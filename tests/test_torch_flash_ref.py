"""repro_torch chunk_fwd (the plain version, which CPU tensors take) against
the JAX package's chunk_fwd with the Pallas kernel in interpret mode: the
shape sweep of tests/test_kernels_flash.py, carry continuation, windows and
causality; plus the port's routing by device (CPU tensors never reach the
CUDA binding, mixed devices raise)."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.online_softmax import SoftmaxState as JState, finalize as j_finalize
from repro.kernels.flash_attention import ops as JO
from repro_torch.convert import from_jax_params
from repro_torch.core.online_softmax import SoftmaxState, finalize
from repro_torch.kernels import build as B
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops as O

SWEEP = [
    # b, hq, hkv, sq, sk, d, block  (tests/test_kernels_flash.py::SWEEP)
    (1, 1, 1, 16, 16, 8, 8),
    (2, 4, 2, 32, 32, 16, 16),
    (1, 4, 1, 64, 64, 32, 16),   # MQA
    (1, 3, 3, 48, 48, 16, 16),   # odd head count, non-divisible block fit
    (2, 2, 2, 40, 24, 16, 8),    # sq != sk
]


def _mk(rng, b, hq, hkv, sq, sk, d, dtype):
    """The same q/k/v as numpy, then as jax and torch arrays of ``dtype``."""
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tx = from_jax_params([np.asarray(a) for a in jx], "cpu")
    return jx, tx


def _tol(dtype):
    return 1e-5 if dtype == jnp.float32 else 3e-2


def _assert_state(t_state, j_state, tol):
    for t, j in zip(t_state, j_state):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)
    np.testing.assert_allclose(finalize(SoftmaxState(*t_state)).numpy(),
                               np.asarray(j_finalize(JState(*j_state))), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,blk", SWEEP)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_chunk_fwd_matches_pallas(rng, b, hq, hkv, sq, sk, d, blk, dtype):
    (jq, jk, jv), (tq, tk, tv) = _mk(rng, b, hq, hkv, sq, sk, d, dtype)
    want = JO.chunk_fwd(jq, jk, jv, impl="pallas", block_q=blk, block_k=blk)
    got = O.chunk_fwd(tq, tk, tv)
    _assert_state(got, want, _tol(dtype))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("q_offset,k_offset", [(0, 0), (48, 0), (48, 24)])
def test_head_dim_256_mqa_window_matches_pallas(rng, dtype, q_offset, k_offset):
    """recurrentgemma-9b's attention: head_dim 256, one kv head for all q
    heads, a sliding window, chunk pairs at their global offsets."""
    b, hq, hkv, s, d, window, blk = 1, 4, 1, 48, 256, 40, 16
    (jq, jk, jv), (tq, tk, tv) = _mk(rng, b, hq, hkv, s, s, d, dtype)
    kw = dict(causal=True, window=window, q_offset=q_offset, k_offset=k_offset)
    want = JO.chunk_fwd(jq, jk, jv, impl="pallas", block_q=blk, block_k=blk, **kw)
    _assert_state(O.chunk_fwd(tq, tk, tv, **kw), want, _tol(dtype))


def test_carry_continues_softmax(rng):
    """Two KV halves at their global offsets, carried, == the JAX kernel's
    carried pair, and == one call over the whole KV."""
    b, h, s, d, blk = 1, 2, 64, 16, 16
    (jq, jk, jv), (tq, tk, tv) = _mk(rng, b, h, h, s, s, d, jnp.float32)
    half = s // 2
    q_off = 2 * half  # the query chunk sits after both KV halves
    jc = tc = None
    for j in range(2):
        sl = slice(j * half, (j + 1) * half)
        kw = dict(causal=True, q_offset=q_off, k_offset=j * half)
        jc = JO.chunk_fwd(jq[:, :, :half], jk[:, :, sl], jv[:, :, sl], jc, impl="pallas",
                          block_q=blk, block_k=blk, **kw)
        tc = O.chunk_fwd(tq[:, :, :half], tk[:, :, sl].contiguous(), tv[:, :, sl].contiguous(),
                         tc, **kw)
    _assert_state(tc, jc, 1e-5)
    whole = O.chunk_fwd(tq[:, :, :half], tk, tv, causal=True, q_offset=q_off)
    np.testing.assert_allclose(finalize(SoftmaxState(*tc)).numpy(),
                               finalize(SoftmaxState(*whole)).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [4, 16, 33])
def test_window_matches_pallas(rng, window):
    b, hq, hkv, sq, sk, d, blk = 1, 4, 2, 32, 48, 16, 16
    (jq, jk, jv), (tq, tk, tv) = _mk(rng, b, hq, hkv, sq, sk, d, jnp.float32)
    # q after the keys, overlapping their tail: some rows see keys, early
    # tiles are window-dead, and (window=4) some rows see nothing
    kw = dict(causal=True, window=window, q_offset=40, k_offset=0)
    want = JO.chunk_fwd(jq, jk, jv, impl="pallas", block_q=blk, block_k=blk, **kw)
    got = O.chunk_fwd(tq, tk, tv, **kw)
    _assert_state(got, want, 1e-5)


def test_causality(rng):
    """Outputs never depend on future keys; causal=False matches the
    kernel's non-causal mode."""
    b, h, s, d = 1, 2, 32, 16
    (jq, jk, jv), (tq, tk, tv) = _mk(rng, b, h, h, s, s, d, jnp.float32)
    base = finalize(SoftmaxState(*O.chunk_fwd(tq, tk, tv)))
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[:, :, 20:] += 5.0
    tv2[:, :, 20:] -= 3.0
    moved = finalize(SoftmaxState(*O.chunk_fwd(tq, tk2, tv2)))
    torch.testing.assert_close(moved[:, :, :20], base[:, :, :20], rtol=0, atol=0)
    assert not torch.allclose(moved[:, :, 20:], base[:, :, 20:])
    want = JO.chunk_fwd(jq, jk, jv, causal=False, impl="pallas", block_q=16, block_k=16)
    _assert_state(O.chunk_fwd(tq, tk, tv, causal=False), want, 1e-5)


def test_impl_device_pairing_raises(rng, monkeypatch):
    """The op is picked by the tensors' device alone: CPU tensors never reach
    the CUDA binding (every launch there is made to raise), and tensors on
    mixed devices raise."""
    _, (tq, tk, tv) = _mk(rng, 1, 2, 2, 16, 16, 16, jnp.float32)
    st = O.chunk_fwd(tq, tk, tv)
    L, delta = st[1], st[2]
    # the bindings themselves take CUDA tensors only
    with pytest.raises(ValueError, match="CUDA kernel"):
        K.flash_fwd(tq, tk, tv)
    with pytest.raises(ValueError, match="CUDA kernel"):
        K.flash_bwd_dq(tq, tk, tv, tq, L, delta)
    with pytest.raises(ValueError, match="CUDA kernel"):
        K.flash_bwd_dkv(tq, tk, tv, tq, L, delta)

    def no_launch(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA binding")

    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        monkeypatch.setattr(K, name, no_launch)
    assert len(O.chunk_fwd(tq, tk, tv)) == 3
    assert O.chunk_bwd_dq(tq, tk, tv, tq, L, delta).shape == tq.shape
    assert all(t.shape == tk.shape for t in O.chunk_bwd_dkv(tq, tk, tv, tq, L, delta))
    meta = torch.empty(tk.shape, device="meta")
    with pytest.raises(ValueError, match="mixed devices"):
        O.chunk_fwd(tq, meta, tv)
    with pytest.raises(ValueError, match="mixed devices"):
        O.chunk_bwd_dq(tq, tk, tv, tq, L, delta.to("meta"))
    with pytest.raises(ValueError, match="not meta"):
        O.chunk_fwd(*(t.to("meta") for t in (tq, tk, tv)))


def test_wrapper_imports_without_nvcc():
    """Importing the binding builds nothing, even where no nvcc is on the
    PATH: the kernel is compiled at its first launch, on the card's machine."""
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    code = ("import repro_torch.kernels.flash_attention.kernel as K, sys; "
            "import repro_torch.kernels.build as B; "
            "assert K._lib is None and K.launches == 0; "
            "assert not (B.BUILD_DIR.exists() and any(B.BUILD_DIR.glob('*.tmp'))); "
            "print('ok')")
    env = dict(os.environ, PATH="/nonexistent", PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    assert K.SOURCE.exists() and K.SOURCE.suffix == ".cu"
    assert "arch=compute_90a,code=sm_90a" in B.NVCC_FLAGS
