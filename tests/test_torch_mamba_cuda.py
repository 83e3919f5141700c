"""The selective scan and the recurrent archs on the card, through the
hand-written CUDA ``linear_scan`` and ``linear_scan_bwd``, against the
same functions on the CPU (their plain versions): ``selective_scan``'s
output, last state and gradients, the launches each block makes, two runs
bit for bit; a reduced falcon-mamba-7b training step (launches as
reckoned, remat offload == remat full bit for bit); reduced
recurrentgemma-9b and falcon-mamba-7b prefill and decode.  Marked
``cuda``: each test skips, inside its fixture, where there is no NVIDIA
GPU (a CUDA kernel has no CPU mode).  Run them on a machine with the card:
PYTHONPATH=src python -m pytest --noconftest -m cuda \\
    tests/test_torch_mamba_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.linear_scan import kernel as K
from repro_torch.models import mamba as M
from repro_torch.models import serve as SV
from repro_torch.models import transformer as T
from repro_torch.runtime import train_loop as TL
from repro_torch.tree import tree_leaves, tree_map

pytestmark = pytest.mark.cuda

# tests/test_kernels_linear_scan.py's forward 1e-5 and gradients 1e-4,
# relative to (1 + the largest magnitude): the segmented scan rounds in
# another order than the plain loop
TOL, TOL_GRAD = 1e-5, 1e-4


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol, name=""):
    got, want = got.detach().cpu().float(), want.detach().cpu().float()
    err = float((got - want).abs().max())
    assert err <= tol * (1 + float(want.abs().max())), f"{name}: {err:.3e}"


def _scan_inputs(s, with_h0, di=64, ds=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    xc = torch.randn((2, s, di), generator=g)
    dt = torch.exp(torch.empty((2, s, di)).uniform_(-6.9, -0.7, generator=g))
    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32)).repeat(di, 1)
    bm, cm = torch.randn((2, s, ds), generator=g), torch.randn((2, s, ds), generator=g)
    h0 = torch.randn((2, di, ds), generator=g) if with_h0 else None
    return [xc, dt, a_log, bm, cm, h0]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [24, 512])
def test_selective_scan_matches_plain(device, s, with_h0):
    """Output and last state at TOL, every input's gradient at TOL_GRAD;
    with grad each block launches the forward twice (its pass and the
    checkpoint's recompute) and the fused backward once."""
    cpu = [t if t is None else t.requires_grad_(True) for t in _scan_inputs(s, with_h0)]
    card = [t if t is None else t.detach().to(device).requires_grad_(True) for t in cpu]
    wy = torch.randn(cpu[0].shape)
    nb = -(-s // 256)
    K.launches = K.bwd_launches = 0
    y, h = M.selective_scan(*card)
    gy = torch.autograd.grad((y * wy.to(device)).sum() + h.sum(),
                             [t for t in card if t is not None])
    torch.cuda.synchronize()
    assert (K.launches, K.bwd_launches) == (2 * nb, nb)
    want_y, want_h = M.selective_scan(*cpu)
    want_g = torch.autograd.grad((want_y * wy).sum() + want_h.sum(),
                                 [t for t in cpu if t is not None])
    _close(y, want_y, TOL, "y")
    _close(h, want_h, TOL, "h_last")
    for name, g_, w_ in zip(("xc", "dt", "A_log", "B", "C", "h0"), gy, want_g):
        _close(g_, w_, TOL_GRAD, name)


def test_selective_scan_bits_repeat(device):
    """Two runs, forward and backward, give the same bits: the scan's plan
    is fixed by the shapes."""
    card = [t.to(device).requires_grad_(True) for t in _scan_inputs(512, True)]
    runs = []
    for _ in range(2):
        y, h = M.selective_scan(*card)
        runs.append([y, h, *torch.autograd.grad(y.sum() + h.sum(), card)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_reduced_falcon_train_step_runs_through_the_kernels(device):
    """Three ssm layers at 512 tokens (two scan blocks) under remat full:
    forward launches 3 a block (the cycle's pass, its recompute, the
    block's recompute), the backward 1; the loss and gradients against the
    CPU's; remat offload the same bits."""
    cfg = dataclasses.replace(reduced(get_config("falcon-mamba-7b")), param_dtype="float32",
                              remat="full")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = make_batch_fn(cfg, ShapeConfig("t", 512, 1, "train"))(0)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want_loss, _, want_g = TL.value_and_grad(cfg, None, params, tb)
    dparams = tree_map(lambda t: t.to(device), params)
    db = {k: v.to(device) for k, v in tb.items()}
    K.launches = K.bwd_launches = 0
    loss, _, grads = TL.value_and_grad(cfg, None, dparams, db)
    torch.cuda.synchronize()
    assert (K.launches, K.bwd_launches) == (3 * 2 * 3, 3 * 2)
    _close(loss, want_loss, 2e-4, "loss")
    for n, (g_, w_) in enumerate(zip(tree_leaves(grads), tree_leaves(want_g))):
        assert float((g_.cpu() - w_).abs().max()) <= 5e-4 * float(w_.abs().max()), n
    loss2, _, grads2 = TL.value_and_grad(dataclasses.replace(cfg, remat="offload"), None,
                                         dparams, db)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(grads2)))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "falcon-mamba-7b"])
def test_reduced_recurrent_serve_matches_plain(device, arch):
    """Prefill and 4 decode steps on the card against the CPU's, in fp32:
    the logits and every cache leaf at 2e-4 of their largest magnitude;
    the scan launches in prefill (and, for the hybrid, flash_fwd)."""
    cfg = dataclasses.replace(reduced(get_config(arch)), param_dtype="float32", remat="none",
                              fpdt_chunks=4)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(device if dev == "cuda" else dev), params)
        K.launches = FK.launches = 0
        logits, cache = SV.prefill_step(cfg, None, p, {"tokens": tokens.to(p["embed"].device)},
                                        max_len=32)
        launches = (K.launches, FK.launches)
        steps = [logits]
        for i in range(4):
            # the card's steps take the CPU's tokens, so both decode the same
            tok = torch.argmax(out["cpu"][1][i] if dev == "cuda" else steps[-1], dim=-1)
            tok = tok.to(p["embed"].device)
            logits, cache = SV.decode_step(cfg, None, p, cache, {"tokens": tok[:, None].int()},
                                           20 + i)
            steps.append(logits)
        out[dev] = (launches, steps, cache)
    (k_scan, k_flash), steps, cache = out["cuda"]
    assert k_scan > 0 and (k_flash > 0) == (arch == "recurrentgemma-9b")
    for got, want in zip(steps, out["cpu"][1]):
        assert float((got.cpu() - want).abs().max()) <= 2e-4 * float(want.abs().max())
    for got, want in zip(tree_leaves(cache), tree_leaves(out["cpu"][2])):
        got, want = got.cpu().float(), want.float()
        assert float((got - want).abs().max()) <= 2e-4 * max(float(want.abs().max()), 1.0)
