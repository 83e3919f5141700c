"""The hand-written CUDA linear scan against its plain PyTorch version on the
card, the fused backward bit for bit against the unfused chain (the forward
kernel in reverse mode, then torch's multiply and cast), two launches of
each kernel bit for bit, the op's gradients against autograd of the plain
version, and a reduced recurrentgemma-9b training step through every kernel
with host offload on and off.  Marked ``cuda``: each test skips, inside its fixture,
where there is no NVIDIA GPU (a CUDA kernel has no CPU mode).  Run them on
a machine with the card:  PYTHONPATH=src python -m pytest --noconftest \
    -m cuda tests/test_torch_linear_scan_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.linear_scan import kernel as K
from repro_torch.kernels.linear_scan import ops as O
from repro_torch.kernels.linear_scan import ref as R
from repro_torch.models import transformer as T
from repro_torch.runtime import train_loop as TL
from repro_torch.tree import tree_leaves

pytestmark = pytest.mark.cuda

CASES = [
    # b, seq, chan, dtype, a range, h0
    (1, 1, 5, torch.float32, (-1.0, 1.0), True),
    (2, 1000, 300, torch.bfloat16, (-0.99, 0.99), False),
    (3, 77, 129, torch.float32, (0.0, 0.99), True),
    (1, 4096, 1024, torch.float32, (0.0, 1.0), False),
]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(case, device, seed=0):
    b, s, c, dtype, (lo, hi), with_h0 = case
    g = torch.Generator(device=device).manual_seed(seed)
    a = (lo + (hi - lo) * torch.rand((b, s, c), generator=g, device=device)).to(dtype)
    x = torch.randn((b, s, c), generator=g, device=device).to(dtype)
    h0 = torch.randn((b, c), generator=g, device=device) if with_h0 else None
    return a, x, h0


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain(device, case, reverse):
    """Elementwise at the JAX kernel tests' 1e-5, relative to (1 + max |h|):
    the segmented scan rounds in another order than the serial loop."""
    a, x, h0 = _inputs(case, device)
    before = K.launches
    got = K.linear_scan(a, x, h0, reverse=reverse)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    want = (R.linear_scan(a.flip(1), x.flip(1), h0).flip(1) if reverse
            else R.linear_scan(a, x, h0))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * (1 + float(want.abs().max()))


def _chain(a, h, h0, dout, b_dtype):
    """The unfused backward: the forward kernel in reverse mode over a
    shifted copy of a, then torch's multiply and cast."""
    return R.linear_scan_bwd(a, h, h0, dout, b_dtype,
                             reverse_scan=lambda a_, b_: K.linear_scan(a_, b_, reverse=True))


@pytest.mark.parametrize("case", CASES)
def test_fused_backward_is_the_unfused_chain(device, case):
    """g, da, db and dh0 of the one-pass backward equal, bit for bit, those of
    the chain it replaces: the same plan and association, read by index."""
    a, x, h0 = _inputs(case, device, seed=2)
    h = K.linear_scan(a, x, h0)
    dout = torch.randn(h.shape, device=device)
    before = K.bwd_launches
    got = K.linear_scan_bwd(a, h, h0, dout, x.dtype)
    torch.cuda.synchronize()
    assert K.bwd_launches == before + 1
    want = _chain(a, h, h0, dout, x.dtype)
    assert [None if t is None else t.dtype for t in got] == \
        [a.dtype, x.dtype, None if h0 is None else torch.float32]
    for g_, w_ in zip(got, want):
        assert (g_ is None) == (w_ is None)
        if g_ is not None:
            assert torch.equal(g_, w_)


@pytest.mark.parametrize("case", CASES)
def test_two_launches_are_bit_identical(device, case):
    """The look-back folds summaries into a state in a fixed order, so the
    bits do not depend on which block ran when."""
    a, x, h0 = _inputs(case, device, seed=3)
    for reverse in (False, True):
        assert torch.equal(K.linear_scan(a, x, h0, reverse=reverse),
                           K.linear_scan(a, x, h0, reverse=reverse))
    h = K.linear_scan(a, x, h0)
    dout = torch.randn(h.shape, device=device)
    first, second = (K.linear_scan_bwd(a, h, h0, dout, x.dtype) for _ in range(2))
    assert all(u is v is None or torch.equal(u, v) for u, v in zip(first, second))


@pytest.mark.parametrize("batch,seq,chan", [
    (1, 8192, 4096), (1, 1, 5), (2, 1000, 300), (3, 77, 129),
    (8, 64, 1), (1, 10 ** 7, 1), (64, 8192, 4096), (1, 33, 7),
])
def test_scratch_holds_the_look_back(device, batch, seq, chan):
    """The scratch the C side asks for holds a flag per block, the ticket and
    sum_a, sum_b and the state of every (batch row, segment, channel)."""
    p = K.plan(batch, seq, chan)
    words = K._load().linear_scan_scratch_words(batch, seq, chan)
    assert words >= p.blocks + 1 + 3 * batch * p.nseg * chan
    assert K._load().linear_scan_scratch_words(0, seq, chan) == -1


def test_op_grads_match_plain_autograd(device):
    a, x, h0 = _inputs((2, 300, 70, torch.float32, (0.2, 0.99), True), device, seed=1)
    w = torch.randn(a.shape, device=device)
    leaves = [t.requires_grad_(True) for t in (a, x, h0)]
    before = (K.launches, K.bwd_launches)
    got = torch.autograd.grad((O.linear_scan(*leaves) * w).sum(), leaves)
    # one forward launch, and one of the fused backward
    assert (K.launches, K.bwd_launches) == (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad((R.linear_scan(*leaves) * w).sum(), leaves)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=1e-4, atol=1e-4)


def test_wrapper_rejects_what_the_kernel_does_not_take(device):
    a = torch.zeros((1, 8, 4), device=device)
    with pytest.raises(ValueError, match="expected one of"):
        K.linear_scan(a.half(), a)
    with pytest.raises(ValueError, match="contiguous"):
        K.linear_scan(a, torch.zeros((1, 4, 8), device=device).transpose(1, 2))
    with pytest.raises(ValueError, match="shape"):
        K.linear_scan(a, a, torch.zeros((1, 5), device=device))
    with pytest.raises(ValueError, match="expected one of"):
        K.linear_scan_bwd(a, a, None, a.bfloat16(), torch.float32)
    with pytest.raises(ValueError, match="b_dtype"):
        K.linear_scan_bwd(a, a, None, a, torch.float16)


def test_reduced_hybrid_train_step_runs_through_the_kernels(device):
    """Two cycles' worth of layers (a stacked cycle and a 2-layer rglru
    tail) at u=4 under remat full: every kernel launches as planned, the
    loss and gradients are finite, and offload on and off agree bit for bit."""
    cfg = dataclasses.replace(reduced(get_config("recurrentgemma-9b")), param_dtype="float32",
                              num_layers=5, fpdt_chunks=4, mlp_chunks=8, remat="full",
                              fpdt_offload=True)
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    batch = make_batch_fn(cfg, ShapeConfig("t", 64, 2, "train"))(0)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    K.launches = K.bwd_launches = FK.launches = FK.dq_launches = FK.dkv_launches = 0
    loss, _, grads = TL.value_and_grad(cfg, None, params, batch)
    torch.cuda.synchronize()
    # scan forward: cycle 2 rglru x (forward, recompute), tail 2 rglru x 1;
    # the fused scan backward once a rglru layer.  One local_attn layer,
    # window 8 at chunk 16: 7 live pairs of u=4.
    assert (K.launches, K.bwd_launches, FK.launches, FK.dq_launches, FK.dkv_launches) == \
        (6, 4, 14, 7, 7)
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in tree_leaves(grads))
    loss2, _, grads2 = TL.value_and_grad(dataclasses.replace(cfg, fpdt_offload=False), None,
                                         params, batch)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(grads2)))
