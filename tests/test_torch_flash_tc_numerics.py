"""Where the bf16 tensor-core flash kernels round, emulated on the CPU and
held against the JAX package's chunk_fwd / chunk_bwd_dq / chunk_bwd_dkv
(Pallas kernels in interpret mode) at the bf16 kernel tolerance that the
card check uses.

The kernels themselves run only on the card (tests/test_torch_flash_cuda.py,
tests/test_torch_flash_bwd_cuda.py).  What they do beyond fp32 arithmetic in
another summation order is round at these points, which the emulation below
repeats in plain PyTorch (ref.attend_chunk_tc, ref.chunk_bwd_dq_tc,
ref.chunk_bwd_dkv_tc, which chip_smoke.py also holds the kernels against):
  * flash_fwd: P to bf16 before P V, tile by tile of the online softmax
    (64 keys, 32 at head_dim 256), with l summing the fp32 P;
  * flash_bwd_dq: dO to bf16 on load, and dS (from the fp32 P) to bf16
    before dQ = dS K;
  * flash_bwd_dkv: dO to bf16 on load, and P^T and dS^T to bf16 before
    dV = P^T dO and dK = dS^T Q.
Inputs are bf16-representable q, k, v made from a seed with numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as JO
from repro_torch.core.online_softmax import NEG_INF, SoftmaxState, finalize, lse
from repro_torch.kernels.flash_attention import ops as O
from repro_torch.kernels.flash_attention import ref as R

TOL = 3e-2  # tests/test_kernels_flash.py:34, the bf16 kernel tolerance

CASES = [
    # b, hq, hkv, sq, sk, d, window, q_offset, k_offset, carry
    (1, 8, 2, 100, 70, 64, 33, 90, 40, True),      # GQA g=4, ragged, window, offsets
    (1, 16, 1, 96, 96, 64, 0, 96, 0, False),       # MQA g=16, an off-diagonal pair
    (1, 8, 2, 80, 80, 256, 50, 0, 0, False),       # d 256, GQA, diagonal with a window
    (1, 16, 1, 70, 100, 256, 48, 150, 60, True),   # d 256, MQA, window and offsets
    (1, 4, 1, 40, 64, 64, 16, 0, 30, True),        # rows 0..29 see no key: fully masked
]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _live(sq, sk, window, q_offset, k_offset):
    qpos = q_offset + torch.arange(sq)[:, None]
    kpos = k_offset + torch.arange(sk)[None, :]
    ok = qpos >= kpos
    return ok & (qpos - kpos < window) if window else ok


def _inputs(case, seed):
    b, hq, hkv, sq, sk, d, window, qo, ko, carry = case
    rng = np.random.default_rng(seed)
    q, k, v = (_bf16(torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
               for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    st = None
    if carry:
        st = (torch.from_numpy(rng.standard_normal((b, hq, sq, d)).astype(np.float32)),
              torch.from_numpy(rng.standard_normal((b, hq, sq)).astype(np.float32)),
              torch.from_numpy(rng.uniform(0.5, 1.5, (b, hq, sq)).astype(np.float32)))
    do = torch.from_numpy(rng.standard_normal((b, hq, sq, d)).astype(np.float32))
    return q, k, v, st, do, dict(causal=True, window=window, q_offset=qo, k_offset=ko)


@pytest.mark.parametrize("case", CASES)
def test_fwd_rounding_meets_the_bf16_tolerance(case):
    q, k, v, st, _, kw = _inputs(case, seed=sum(case[:6]))
    got = R.attend_chunk_tc(q, k, v, carry=None if st is None else SoftmaxState(*st), **kw)
    want = JO.chunk_fwd(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                        None if st is None else tuple(jnp.asarray(t.numpy()) for t in st),
                        impl="pallas", **kw)
    want = [torch.from_numpy(np.array(w)) for w in want]
    out_err = float((finalize(SoftmaxState(*got)) - finalize(SoftmaxState(*want))).abs().max())
    m_err = float((got[1] - want[1]).abs().max())
    l_err = float(((got[2] - want[2]).abs() / (1 + want[2].abs())).max())
    acc_err = float(((got[0] - want[0]).abs() / (1 + want[2][..., None])).max())
    print(f"fwd {case}: out {out_err:.2e}, m {m_err:.2e}, l {l_err:.2e}, "
          f"acc / (1 + l) {acc_err:.2e} (tol {TOL})")
    assert max(out_err, m_err, l_err, acc_err) <= TOL
    masked = ~_live(case[3], case[4], kw["window"], kw["q_offset"], kw["k_offset"]).any(-1)
    if st is not None and masked.any():  # rows that see no key keep their carry
        assert torch.equal(got[0][..., masked, :], st[0][..., masked, :])
    # the rounding is real: P in bf16 moves acc off the fp32 plain version's
    assert not torch.equal(got[0], O.chunk_fwd(q, k, v, st, **kw)[0])


@pytest.mark.parametrize("case", CASES)
def test_dkv_rounding_meets_the_bf16_tolerance(case):
    q, k, v, _, do, kw = _inputs(case, seed=sum(case[:6]) + 1)
    st = SoftmaxState(*O.chunk_fwd(q, k, v, **kw))  # the pair's own L and o
    L, delta = lse(st), (do * finalize(st)).sum(-1)
    got = R.chunk_bwd_dkv_tc(q, k, v, do, L, delta, **kw)
    want = JO.chunk_bwd_dkv(*(jnp.asarray(t.numpy()) for t in (q, k, v, do, L, delta)),
                            impl="pallas", **kw)
    errs = []
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w))
        errs.append(float((g - w).abs().max()) / (1 + float(w.abs().max())))
    print(f"dkv {case}: dk, dv err / (1 + max|ref|) {errs[0]:.2e}, {errs[1]:.2e} (tol {TOL})")
    assert max(errs) <= TOL
    masked = ~_live(case[3], case[4], kw["window"], kw["q_offset"], kw["k_offset"]).any(-1)
    if masked.any():  # rows that see no key give nothing: their L is NEG_INF
        assert bool((L[..., masked] <= NEG_INF / 2).all())


@pytest.mark.parametrize("case", CASES)
def test_dq_rounding_meets_the_bf16_tolerance(case):
    q, k, v, _, do, kw = _inputs(case, seed=sum(case[:6]) + 2)
    st = SoftmaxState(*O.chunk_fwd(q, k, v, **kw))  # the pair's own L and o
    L, delta = lse(st), (do * finalize(st)).sum(-1)
    got = R.chunk_bwd_dq_tc(q, k, v, do, L, delta, **kw)
    want = torch.from_numpy(np.array(JO.chunk_bwd_dq(
        *(jnp.asarray(t.numpy()) for t in (q, k, v, do, L, delta)), impl="pallas", **kw)))
    err = float((got - want).abs().max()) / (1 + float(want.abs().max()))
    print(f"dq {case}: err / (1 + max|ref|) {err:.2e} (tol {TOL})")
    assert err <= TOL
    masked = ~_live(case[3], case[4], kw["window"], kw["q_offset"], kw["k_offset"]).any(-1)
    if masked.any():  # rows that see no key get dq = 0
        assert not got[..., masked, :].any()
    # the rounding is real: dO and dS in bf16 move dq off the fp32 plain version's
    assert not torch.equal(got, O.chunk_bwd_dq(q, k, v, do, L, delta, **kw))
