"""The hand-written CUDA flash_fwd against its plain PyTorch version, on the
card.  Marked ``cuda``: each test skips, inside its fixture, where there is
no NVIDIA GPU (a CUDA kernel has no CPU mode).  Run them on a machine with
the card:  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_flash_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.online_softmax import SoftmaxState, finalize
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref as R

pytestmark = pytest.mark.cuda

CASES = [
    # b, hq, hkv, sq, sk, d, dtype, causal, window, q_offset, k_offset, carry
    (1, 4, 4, 100, 100, 16, torch.float32, True, 0, 0, 0, False),
    (2, 8, 2, 100, 70, 64, torch.bfloat16, True, 33, 90, 40, True),
    (1, 4, 1, 64, 128, 128, torch.float32, True, 0, 128, 0, True),
    (2, 4, 4, 48, 48, 32, torch.bfloat16, False, 0, 0, 0, False),
    (1, 2, 2, 64, 64, 64, torch.float32, True, 33, 0, 200, True),  # every row masked
    (1, 16, 1, 100, 70, 256, torch.bfloat16, True, 33, 90, 40, True),  # d 256, MQA, window
    (1, 4, 1, 64, 64, 256, torch.float32, True, 40, 64, 0, True),
    # bf16 runs the tensor-core kernel: d 64 and 256, GQA and MQA, ragged
    # tails (sq, sk not multiples of 64), windows, offsets, masked rows
    (2, 8, 2, 130, 200, 64, torch.bfloat16, True, 0, 0, 0, False),
    (1, 16, 1, 77, 150, 64, torch.bfloat16, True, 48, 300, 180, True),
    (1, 16, 1, 200, 130, 256, torch.bfloat16, True, 0, 130, 0, True),
    (2, 8, 2, 96, 96, 256, torch.bfloat16, True, 50, 0, 0, False),
    (1, 4, 1, 70, 64, 256, torch.bfloat16, True, 33, 0, 200, True),  # every row masked
    (1, 4, 4, 64, 64, 64, torch.bfloat16, True, 0, 0, 100, False),  # every row masked, no carry
    (1, 8, 2, 33, 257, 128, torch.bfloat16, False, 0, 0, 0, True),
    (2, 4, 2, 40, 90, 16, torch.bfloat16, True, 20, 60, 0, False),
    # head_dim 80 (gpt-2.7b, MHA): both kernels, ragged tails, a window,
    # offsets, a carry, masked rows
    (1, 4, 4, 100, 100, 80, torch.float32, True, 0, 0, 0, False),
    (2, 4, 4, 130, 70, 80, torch.float32, True, 33, 90, 40, True),
    (1, 4, 4, 100, 100, 80, torch.bfloat16, True, 0, 0, 0, False),
    (2, 4, 4, 130, 200, 80, torch.bfloat16, True, 48, 300, 180, True),
    (1, 4, 4, 64, 64, 80, torch.bfloat16, True, 33, 0, 200, True),  # every row masked
    (1, 8, 8, 37, 257, 80, torch.bfloat16, False, 0, 0, 0, True),
]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(case, device):
    b, hq, hkv, sq, sk, d, dtype, causal, window, qo, ko, carry = case
    g = torch.Generator(device=device).manual_seed(0)
    q = torch.randn((b, hq, sq, d), generator=g, device=device).to(dtype)
    k = torch.randn((b, hkv, sk, d), generator=g, device=device).to(dtype)
    v = torch.randn((b, hkv, sk, d), generator=g, device=device).to(dtype)
    st = None
    if carry:
        st = SoftmaxState(torch.randn((b, hq, sq, d), generator=g, device=device),
                          torch.randn((b, hq, sq), generator=g, device=device),
                          torch.rand((b, hq, sq), generator=g, device=device) + 0.5)
    kw = dict(causal=causal, window=window, q_offset=qo, k_offset=ko)
    return q, k, v, st, kw


@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain(device, case):
    q, k, v, st, kw = _inputs(case, device)
    tol = 1e-5 if q.dtype == torch.float32 else 3e-2
    before = K.launches
    got = K.flash_fwd(q, k, v, None if st is None else tuple(st), **kw)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    want = R.attend_chunk(q, k, v, carry=st, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)
    torch.testing.assert_close(finalize(SoftmaxState(*got)), finalize(want), rtol=tol, atol=tol)


def test_wrapper_rejects_what_the_kernel_does_not_take(device):
    q = torch.zeros((1, 2, 16, 48), device=device)
    with pytest.raises(ValueError, match="head_dim"):
        K.flash_fwd(q, q, q)
    q = torch.zeros((1, 2, 16, 64), device=device, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K.flash_fwd(q, q, q)
    q = torch.zeros((1, 2, 64, 16), device=device).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        K.flash_fwd(q, q, q)
    # the tensor-core kernel copies q, k, v in 16-byte vectors
    q = torch.zeros(2 * 64 * 64 + 1, device=device, dtype=torch.bfloat16)[1:].view(1, 2, 64, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.flash_fwd(q, q, q)


# chip_smoke.py's limit on ||kernel - emulation|| / ||emulation||
TOL_TC = 3e-4


TC_CASES = [
    (1, 8, 2, 512, 512, 64, torch.bfloat16, True, 0, 512, 0, True),
    (1, 16, 1, 256, 320, 256, torch.bfloat16, True, 200, 256, 64, True),
    (1, 8, 8, 512, 512, 80, torch.bfloat16, True, 0, 512, 512, True),  # gpt-2.7b's width
]


@pytest.mark.parametrize("case", TC_CASES)
def test_bf16_kernel_matches_its_rounding(device, case):
    """The tensor-core kernel against the plain version rounded where it
    rounds (P to bf16 before P V, ref.attend_chunk_tc): only the fp32
    summation order and rare bf16 roundings to the other neighbour differ."""
    q, k, v, st, kw = _inputs(case, device)
    got = K.flash_fwd(q, k, v, tuple(st), **kw)
    want = R.attend_chunk_tc(q, k, v, carry=st, **kw)
    for a, b in ((got[0], want.acc), (got[2], want.l)):
        assert float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)) <= TOL_TC


@pytest.mark.parametrize("case", TC_CASES)
def test_bf16_kernel_is_deterministic(device, case):
    """Two launches on the same inputs give the same bits: each block owns
    its q rows, with no cross-block sum."""
    q, k, v, st, kw = _inputs(case, device)
    first = K.flash_fwd(q, k, v, tuple(st), **kw)
    second = K.flash_fwd(q, k, v, tuple(st), **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_reduced_serve_runs_through_the_kernel(device):
    from repro_torch.models import serve as SV
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(reduced(get_config("llama3.2-1b")), param_dtype="float32",
                              fpdt_chunks=4)
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_params(cfg, gen, device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen, device=device)
    before = K.launches
    logits, _ = SV.prefill_step(cfg, None, params, {"tokens": tokens}, max_len=40)
    assert K.launches - before == cfg.num_layers * 10  # u=4: 10 live (i, j <= i) pairs
    assert torch.isfinite(logits).all()
