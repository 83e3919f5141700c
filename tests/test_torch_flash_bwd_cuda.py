"""The hand-written CUDA flash_bwd_dq / flash_bwd_dkv against their plain
PyTorch versions on the card, the flash_attention Function's gradients, host
offload residency, and a reduced training step through all three kernels.
Marked ``cuda``: each test skips, inside its fixture, where there is no
NVIDIA GPU (a CUDA kernel has no CPU mode).  Run them on a machine with the
card:  PYTHONPATH=src python -m pytest --noconftest -m cuda \
    tests/test_torch_flash_bwd_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import fpdt as F
from repro_torch.core.online_softmax import finalize, lse
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops as O
from repro_torch.kernels.flash_attention import ref as R
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.runtime import train_loop as TL
from repro_torch.tree import tree_leaves

pytestmark = pytest.mark.cuda

TOL = 1e-4  # tests/test_kernels_flash.py's kernel-gradient tolerance
# bf16 flash_bwd_dq and flash_bwd_dkv run on the tensor cores with dO and dS
# (and for dkv P^T) rounded to bf16: held at the bf16 kernel tolerance
# (tests/test_kernels_flash.py:34) relative to (1 + max |ref|); fp32 stays at
# TOL
TOL_BWD_BF16 = 3e-2

CASES = [
    # b, hq, hkv, sq, sk, d, dtype, causal, window, q_offset, k_offset
    (1, 4, 4, 100, 100, 16, torch.float32, True, 0, 0, 0),
    (2, 8, 2, 100, 70, 64, torch.bfloat16, True, 33, 90, 40),
    (1, 4, 1, 64, 128, 128, torch.float32, True, 0, 128, 0),
    (2, 4, 2, 37, 100, 64, torch.bfloat16, False, 0, 0, 0),
    (1, 2, 2, 64, 64, 64, torch.float32, True, 33, 0, 200),  # every row masked
    (1, 16, 1, 100, 70, 256, torch.bfloat16, True, 33, 90, 40),  # d 256, MQA, window
    (1, 4, 1, 64, 100, 256, torch.float32, True, 40, 64, 0),
    # bf16 dkv on the tensor cores with the q heads split across blocks
    # (n_split > 1 at these sizes): d 64 and 256, GQA and MQA, ragged tails,
    # windows, offsets, fully masked rows
    (2, 8, 2, 130, 200, 64, torch.bfloat16, True, 0, 0, 0),
    (1, 16, 1, 77, 150, 64, torch.bfloat16, True, 48, 300, 180),
    (1, 16, 1, 200, 130, 256, torch.bfloat16, True, 0, 130, 0),
    (2, 8, 2, 96, 96, 256, torch.bfloat16, True, 50, 0, 0),
    (1, 4, 1, 70, 64, 256, torch.bfloat16, True, 33, 0, 200),  # every row masked
    (1, 8, 2, 33, 257, 128, torch.bfloat16, False, 0, 0, 0),
    (2, 4, 2, 40, 90, 16, torch.bfloat16, True, 20, 60, 0),
    # head_dim 80 (gpt-2.7b, MHA; one warp column in the bf16 kernels):
    # both kernels, ragged tails, a window, offsets, masked rows
    (1, 4, 4, 100, 100, 80, torch.float32, True, 0, 0, 0),
    (2, 4, 4, 130, 70, 80, torch.float32, True, 33, 90, 40),
    (1, 4, 4, 100, 100, 80, torch.bfloat16, True, 0, 0, 0),
    (2, 4, 4, 130, 200, 80, torch.bfloat16, True, 48, 300, 180),
    (1, 4, 4, 64, 64, 80, torch.bfloat16, True, 33, 0, 200),  # every row masked
    (1, 8, 2, 37, 257, 80, torch.bfloat16, False, 0, 0, 0),
]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pair(case, device):
    """q, k, v of ``case`` with do, L and delta from the plain forward."""
    b, hq, hkv, sq, sk, d, dtype, causal, window, qo, ko = case
    g = torch.Generator(device=device).manual_seed(0)
    q = torch.randn((b, hq, sq, d), generator=g, device=device).to(dtype)
    k = torch.randn((b, hkv, sk, d), generator=g, device=device).to(dtype)
    v = torch.randn((b, hkv, sk, d), generator=g, device=device).to(dtype)
    kw = dict(causal=causal, window=window, q_offset=qo, k_offset=ko)
    st = R.attend_chunk(q, k, v, **kw)
    do = torch.randn((b, hq, sq, d), generator=g, device=device)
    delta = (do * finalize(st)).sum(-1)
    return q, k, v, do, lse(st), delta, kw


def _rel(got, want):
    return float((got - want).abs().max()) / (1.0 + float(want.abs().max()))


@pytest.mark.parametrize("case", CASES)
def test_bwd_kernels_match_plain(device, case):
    q, k, v, do, Lr, delta, kw = _pair(case, device)
    before = (K.dq_launches, K.dkv_launches)
    dq = K.flash_bwd_dq(q, k, v, do, Lr, delta, **kw)
    dk, dv = K.flash_bwd_dkv(q, k, v, do, Lr, delta, **kw)
    torch.cuda.synchronize()
    assert (K.dq_launches, K.dkv_launches) == (before[0] + 1, before[1] + 1)
    want_dq = R.chunk_bwd_dq(q, k, v, do, Lr, delta, **kw)
    want_dk, want_dv = R.chunk_bwd_dkv(q, k, v, do, Lr, delta, **kw)
    if q.dtype == torch.bfloat16:
        assert _rel(dq, want_dq) <= TOL_BWD_BF16
        assert _rel(dk, want_dk) <= TOL_BWD_BF16 and _rel(dv, want_dv) <= TOL_BWD_BF16
    else:
        torch.testing.assert_close(dq, want_dq, rtol=TOL, atol=TOL)
        assert _rel(dk, want_dk) <= TOL and _rel(dv, want_dv) <= TOL
    if kw["k_offset"] > kw["q_offset"] + q.shape[2]:  # keys wholly in the future
        assert not dq.any() and not dk.any() and not dv.any()


@pytest.mark.parametrize("hq,hkv,s,d", [(16, 1, 300, 256), (8, 2, 200, 64), (8, 2, 200, 80)])
def test_bf16_dkv_is_deterministic(device, hq, hkv, s, d):
    """Two launches on the same inputs give the same bits: the q-head
    splits' partials are summed in split order, without atomics."""
    case = (1, hq, hkv, s, s, d, torch.bfloat16, True, 0, 0, 0)
    q, k, v, do, Lr, delta, kw = _pair(case, device)
    assert K.dkv_splits(1, hq, hkv, s) > 1
    first = K.flash_bwd_dkv(q, k, v, do, Lr, delta, **kw)
    second = K.flash_bwd_dkv(q, k, v, do, Lr, delta, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("hq,hkv,s,d", [(16, 1, 300, 256), (8, 2, 200, 64), (32, 32, 300, 80)])
def test_bf16_dq_is_deterministic(device, hq, hkv, s, d):
    """Two launches on the same inputs give the same bits: each block owns
    its q rows' dq, with no cross-block sum."""
    case = (1, hq, hkv, s, s, d, torch.bfloat16, True, 0, 0, 0)
    q, k, v, do, Lr, delta, kw = _pair(case, device)
    first = K.flash_bwd_dq(q, k, v, do, Lr, delta, **kw)
    second = K.flash_bwd_dq(q, k, v, do, Lr, delta, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# chip_smoke.py's limit on ||kernel - emulation|| / ||emulation||
TOL_TC = 3e-4
TC_CASES = [
    (1, 8, 2, 512, 512, 64, torch.bfloat16, True, 0, 512, 0),
    (1, 16, 1, 256, 320, 256, torch.bfloat16, True, 200, 256, 64),
    (1, 8, 8, 512, 512, 80, torch.bfloat16, True, 0, 512, 512),  # gpt-2.7b's width
]


@pytest.mark.parametrize("case", TC_CASES)
def test_bf16_dq_matches_its_rounding(device, case):
    """The tensor-core dq against the plain version rounded where it rounds
    (dO and dS to bf16, ref.chunk_bwd_dq_tc): only the fp32 summation order
    and rare bf16 roundings to the other neighbour differ."""
    q, k, v, do, Lr, delta, kw = _pair(case, device)
    got = K.flash_bwd_dq(q, k, v, do, Lr, delta, **kw)
    want = R.chunk_bwd_dq_tc(q, k, v, do, Lr, delta, **kw)
    assert float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)) <= TOL_TC


@pytest.mark.parametrize("case", TC_CASES)
def test_bf16_dkv_matches_its_rounding(device, case):
    """The tensor-core dkv against the plain version rounded where it rounds
    (dO, P^T and dS^T to bf16, ref.chunk_bwd_dkv_tc): only the fp32
    summation order and rare bf16 roundings to the other neighbour differ."""
    q, k, v, do, Lr, delta, kw = _pair(case, device)
    got = K.flash_bwd_dkv(q, k, v, do, Lr, delta, **kw)
    want = R.chunk_bwd_dkv_tc(q, k, v, do, Lr, delta, **kw)
    for a, b in zip(got, want):
        assert float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)) <= TOL_TC


def test_flash_attention_function_grads(device):
    b, hq, hkv, s, d = 2, 8, 2, 96, 64
    g = torch.Generator(device=device).manual_seed(1)
    q, k, v = (torch.randn(shape, generator=g, device=device, requires_grad=True)
               for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    w = torch.randn((b, hq, s, d), generator=g, device=device)
    before = (K.launches, K.dq_launches, K.dkv_launches)
    got = torch.autograd.grad((O.flash_attention(q, k, v, window=40) * w).sum(), (q, k, v))
    assert (K.launches, K.dq_launches, K.dkv_launches) == tuple(n + 1 for n in before)
    want = torch.autograd.grad((R.mha(q, k, v, window=40) * w).sum(), (q, k, v))
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, rtol=TOL, atol=TOL)


def _attn_setup(device, u, offload):
    cfg = dataclasses.replace(reduced(get_config("llama3.2-1b")), param_dtype="float32",
                              fpdt_chunks=u, fpdt_offload=offload)
    gen = torch.Generator(device=device).manual_seed(2)
    p = L.init_attn(cfg, gen, torch.float32, device)
    x = torch.randn((2, 64, cfg.d_model), generator=gen, device=device)
    return cfg, p, x


def test_offload_keeps_chunks_pinned_on_the_host(device):
    cfg, p, x = _attn_setup(device, 4, True)
    x.requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        o = F.fpdt_attention(cfg, None, p, x)
    host = [t for t in saved if t.device.type == "cpu"]
    # q, k and v of every chunk wait on the host; o and L stay on the card
    assert len(host) == 3 * cfg.fpdt_chunks and all(t.is_pinned() for t in host)
    o.sum().backward()
    assert torch.isfinite(x.grad).all()


def test_offload_on_and_off_give_identical_grads(device):
    outs = []
    for offload in (True, False):
        cfg, p, x = _attn_setup(device, 4, offload)
        ws = [p[n].requires_grad_(True) for n in ("wq", "wk", "wv")]
        x.requires_grad_(True)
        o = F.fpdt_attention(cfg, None, p, x)
        outs.append([o, *torch.autograd.grad((o * o).sum(), [x, *ws])])
    for a, b_ in zip(*outs):
        assert torch.equal(a, b_)


def test_reduced_train_step_runs_through_the_kernels(device):
    cfg = dataclasses.replace(reduced(get_config("llama3.2-1b")), param_dtype="float32",
                              fpdt_chunks=4, mlp_chunks=8, remat="full", fpdt_offload=True)
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    batch = make_batch_fn(cfg, ShapeConfig("t", 64, 2, "train"))(0)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    K.launches = K.dq_launches = K.dkv_launches = 0
    loss, _, grads = TL.value_and_grad(cfg, None, params, batch)
    torch.cuda.synchronize()
    pairs = cfg.num_layers * 10  # u=4: 10 live (i, j <= i) pairs per layer
    assert (K.launches, K.dq_launches, K.dkv_launches) == (2 * pairs, pairs, pairs)
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in tree_leaves(grads))
