"""repro_torch's linear scan on the CPU (the plain version, which CPU tensors
take) against the JAX package's: the forward of ``ops.linear_scan`` and
``ref.linear_scan`` against JAX ``ops.linear_scan(impl="pallas")`` (interpret
mode) and ``ref.linear_scan_naive`` on the grid of
tests/test_kernels_linear_scan.py, with h0 given and absent and bf16
inputs; the op's gradients (da, db, dh0) and the plain backward
(``ref.linear_scan_bwd``, which the op runs for CPU tensors) against the JAX
``custom_vjp``'s; the reverse scan; the segment plan of the CUDA wrapper,
which reads no SM count; and the routing by device.  Tolerances are the JAX tests' own: forward
rtol/atol 1e-5, gradients 1e-4."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.linear_scan import ops as JO
from repro.kernels.linear_scan import ref as JR
from repro_torch.convert import from_jax_params
from repro_torch.kernels.linear_scan import kernel as K
from repro_torch.kernels.linear_scan import ops as O
from repro_torch.kernels.linear_scan import ref as R

GRID = [(1, 8, 4, 4, 4), (2, 32, 8, 8, 4), (1, 24, 6, 8, 3)]  # b, s, c, block_s, block_c


def _inputs(seed, b, s, c, dtype=jnp.float32, lo=-0.99, hi=0.99):
    rng = np.random.default_rng(seed)
    a = jnp.asarray(rng.uniform(lo, hi, (b, s, c)), dtype)
    x = jnp.asarray(rng.standard_normal((b, s, c)), dtype)
    h0 = jnp.asarray(rng.standard_normal((b, c)), jnp.float32)
    ta, tx, th0 = from_jax_params([np.asarray(a), np.asarray(x), np.asarray(h0)], "cpu")
    return (a, x, h0), (ta, tx, th0)


@pytest.mark.parametrize("b,s,c,bs,bc", GRID)
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_forward_matches_jax(b, s, c, bs, bc, with_h0, dtype):
    (a, x, h0), (ta, tx, th0) = _inputs(b * 100 + s + c, b, s, c, dtype)
    h0, th0 = (h0, th0) if with_h0 else (None, None)
    want = JO.linear_scan(a, x, h0, impl="pallas", block_s=bs, block_c=bc)
    naive = JR.linear_scan_naive(np.asarray(a, np.float32), np.asarray(x, np.float32),
                                 None if h0 is None else np.asarray(h0))
    for got in (O.linear_scan(ta, tx, th0), R.linear_scan(ta, tx, th0)):
        assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, c)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), naive, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(R.linear_scan_naive(ta.float(), tx.float(), th0), naive, rtol=0,
                               atol=0)


@pytest.mark.parametrize("b,s,c,bs,bc", GRID)
@pytest.mark.parametrize("with_h0", [True, False])
def test_grads_match_jax(b, s, c, bs, bc, with_h0):
    (a, x, h0), (ta, tx, th0) = _inputs(b + s * 7 + c, b, s, c, lo=0.2, hi=0.95)

    def jloss(a, x, h0):
        return (JO.linear_scan(a, x, h0 if with_h0 else None, impl="pallas", block_s=bs,
                               block_c=bc) ** 2).sum()

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(a, x, h0)
    leaves = [ta.requires_grad_(True), tx.requires_grad_(True)]
    if with_h0:
        leaves.append(th0.requires_grad_(True))
    h = O.linear_scan(ta, tx, th0 if with_h0 else None)
    tg = torch.autograd.grad((h ** 2).sum(), leaves)
    for got, want in zip(tg, jg):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_bf16_grads_keep_input_dtypes():
    """da, db in the inputs' dtype and dh0 in h0's, as the JAX custom_vjp."""
    (a, x, h0), (ta, tx, th0) = _inputs(3, 2, 16, 8, jnp.bfloat16, lo=0.2, hi=0.95)
    jg = jax.grad(lambda a, x, h0: (JO.linear_scan(a, x, h0, impl="pallas", block_s=8,
                                                   block_c=8) ** 2).sum(),
                  argnums=(0, 1, 2))(a, x, h0)
    leaves = [t.requires_grad_(True) for t in (ta, tx, th0)]
    tg = torch.autograd.grad((O.linear_scan(*leaves) ** 2).sum(), leaves)
    assert [t.dtype for t in tg] == [torch.bfloat16, torch.bfloat16, torch.float32]
    for got, want in zip(tg, jg):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                                   atol=3e-2 * np.abs(want).max())


@pytest.mark.parametrize("lo,hi", [(0.999, 1.0), (-1.0, -0.999)])
@pytest.mark.parametrize("normalized", [True, False])
def test_long_sequence_near_unit_decay(lo, hi, normalized):
    """a near +1 and near -1 (alternating signs) over 2048 steps, against the
    float64 recurrence.  With RG-LRU's input scaling b = sqrt(1 - a^2) x, h
    stays O(1) and is held elementwise at 1e-5.  With raw b, h is a random
    walk of size ~sqrt(t): fp32 rounding then accumulates over the walk, so
    near its zero crossings the error is set by the walk's size, not by
    |h_t|, and the error is held at 1e-5 relative to (1 + max |h|), as the
    flash backward's dk/dv sums are."""
    (a, x, h0), (ta, tx, th0) = _inputs(11, 2, 2048, 16, lo=lo, hi=hi)
    if normalized:
        tx = torch.sqrt(1 - ta * ta) * tx
    want = JR.linear_scan_naive(ta.numpy(), tx.numpy(), th0.numpy())
    got = O.linear_scan(ta, tx, th0).numpy()
    if normalized:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(want).max() > 20  # the walk did wander
        assert np.abs(got - want).max() / (1 + np.abs(want).max()) <= 1e-5


@pytest.mark.parametrize("with_h0", [True, False])
def test_reverse_scan_is_the_flipped_scan(with_h0):
    _, (ta, tx, th0) = _inputs(5, 2, 37, 6)
    th0 = th0 if with_h0 else None
    want = R.linear_scan(ta.flip(1), tx.flip(1), th0).flip(1)
    torch.testing.assert_close(O.scan(ta, tx, th0, reverse=True), want, rtol=0, atol=0)


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("b,s,c,bs,bc", GRID)
def test_plain_backward_matches_jax_vjp(b, s, c, bs, bc, with_h0):
    """ref.linear_scan_bwd (the chain the fused CUDA backward replaces)
    against jax.vjp of the Pallas kernel, interpret mode, at 1e-4."""
    (a, x, h0), (ta, tx, th0) = _inputs(b * 13 + s + c, b, s, c, lo=0.2, hi=0.95)
    dout = np.random.default_rng(s).standard_normal((b, s, c)).astype(np.float32)
    if with_h0:
        h, vjp = jax.vjp(lambda a, x, h0: JO.linear_scan(a, x, h0, impl="pallas", block_s=bs,
                                                         block_c=bc), a, x, h0)
    else:
        h, vjp = jax.vjp(lambda a, x: JO.linear_scan(a, x, None, impl="pallas", block_s=bs,
                                                     block_c=bc), a, x)
    want = vjp(jnp.asarray(dout))
    got = R.linear_scan_bwd(ta, torch.from_numpy(np.array(h)), th0 if with_h0 else None,
                            torch.from_numpy(dout), tx.dtype)
    assert (got[2] is None) == (not with_h0)
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.float32
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-4, atol=1e-4)


def test_plain_backward_keeps_bf16_dtypes():
    """bf16 a and b: da and db in their dtypes, dh0 in h0's, as the JAX
    custom_vjp gives them."""
    (a, x, h0), (ta, tx, th0) = _inputs(7, 2, 16, 8, jnp.bfloat16, lo=0.2, hi=0.95)
    dout = np.random.default_rng(7).standard_normal((2, 16, 8)).astype(np.float32)
    h, vjp = jax.vjp(lambda a, x, h0: JO.linear_scan(a, x, h0, impl="pallas", block_s=8,
                                                     block_c=8), a, x, h0)
    want = vjp(jnp.asarray(dout))
    got = R.linear_scan_bwd(ta, torch.from_numpy(np.array(h)), th0, torch.from_numpy(dout),
                            tx.dtype)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.bfloat16, torch.float32]
    assert [np.asarray(w).dtype for w in want] == [jnp.bfloat16, jnp.bfloat16, np.float32]
    for g_, w_ in zip(got, want):
        w_ = np.asarray(w_, np.float32)
        np.testing.assert_allclose(g_.float().numpy(), w_, rtol=3e-2,
                                   atol=3e-2 * np.abs(w_).max())


def test_cpu_backward_runs_the_plain_chain(monkeypatch):
    """The op's backward on CPU tensors is ref.linear_scan_bwd, and never
    reaches the CUDA binding."""
    _, (ta, tx, th0) = _inputs(9, 2, 12, 5)
    calls = []
    plain = R.linear_scan_bwd

    def spy(*args, **kw):
        calls.append(args)
        return plain(*args, **kw)

    def no_launch(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA binding")

    monkeypatch.setattr(R, "linear_scan_bwd", spy)
    monkeypatch.setattr(K, "linear_scan", no_launch)
    monkeypatch.setattr(K, "linear_scan_bwd", no_launch)
    leaves = [t.requires_grad_(True) for t in (ta, tx, th0)]
    got = torch.autograd.grad(O.linear_scan(*leaves).sum(), leaves)
    assert len(calls) == 1 and all(torch.isfinite(g).all() for g in got)


@pytest.mark.parametrize("batch,seq,chan", [
    (1, 8192, 4096), (1, 1, 5), (2, 1000, 300), (3, 77, 129),
    (8, 64, 1), (1, 10 ** 7, 1), (64, 8192, 4096), (1, 33, 7),
])
def test_segment_plan_covers_the_sequence(batch, seq, chan):
    """The CUDA wrapper's segments tile [0, seq) with none empty, each
    SEGMENT steps but the last; one block per segment, batch row and block
    of THREADS channels, within the grid's limit.  (The scratch's size is
    the CUDA source's to reckon: test_torch_linear_scan_cuda.py holds it.)"""
    p = K.plan(batch, seq, chan)
    assert p.seg_len == K.SEGMENT and p.nseg >= 1
    assert p.seg_len * p.nseg >= seq and p.seg_len * (p.nseg - 1) < seq
    assert p.blocks == batch * -(-chan // K.THREADS) * p.nseg <= K.MAX_BLOCKS


def test_plan_reads_no_sm_count(monkeypatch):
    """The plan, and so the bits, is a function of the shapes alone: planning
    the RG-LRU training shape asks nothing of the card, and no code on the
    kernel's path reads an SM count."""
    def no_card(*a, **k):
        raise AssertionError("the plan asked the card for its properties")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_card)
    monkeypatch.setattr(torch.cuda, "device_count", no_card)
    assert K.plan(1, 8192, 4096) == K.Plan(K.SEGMENT, 256, 32 * 256)
    for mod in (K, O):
        assert "multi_processor_count" not in open(mod.__file__).read()
    assert "multiProcessorCount" not in K.SOURCE.read_text()


def test_routing_by_device(monkeypatch):
    """CPU tensors never reach the CUDA binding; the binding refuses them;
    tensors on mixed or other devices raise."""
    _, (ta, tx, th0) = _inputs(0, 1, 8, 4)
    with pytest.raises(ValueError, match="CUDA kernel"):
        K.linear_scan(ta, tx, th0)

    def no_launch(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA binding")

    monkeypatch.setattr(K, "linear_scan", no_launch)
    monkeypatch.setattr(K, "linear_scan_bwd", no_launch)
    assert O.linear_scan(ta, tx, th0).shape == ta.shape
    with pytest.raises(ValueError, match="mixed devices"):
        O.linear_scan(ta, tx, th0.to("meta"))
    with pytest.raises(ValueError, match="not meta"):
        O.scan(ta.to("meta"), tx.to("meta"))


def test_binding_imports_without_nvcc():
    """Importing the binding builds nothing, even where no nvcc is on the
    PATH: the kernel is compiled at its first launch, on the card's machine."""
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    code = ("import repro_torch.kernels.linear_scan.ops as O, "
            "repro_torch.kernels.linear_scan.kernel as K; "
            "assert K._lib is None and K.launches == K.bwd_launches == 0; print('ok')")
    env = dict(os.environ, PATH="/nonexistent", PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    assert K.SOURCE.exists() and K.SOURCE.suffix == ".cu"
