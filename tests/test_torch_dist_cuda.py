"""FPDT's distributed kinds on the card: 2 gloo ranks that share one GPU
(gloo moves the CUDA tensors), each running the hand-written kernels at the
shapes sharding gives them, against ``kind="local"`` on the same card and
inputs (``tests/_torch_dist.py::task_fpdt_cuda``: ulysses with KV through
the all-to-all and gathered, and cp; fp32 and bf16; offload on).  Marked
``cuda``: the test skips, inside its fixture, where there is no NVIDIA GPU.
Run it on a machine with the card:

    PYTHONPATH=src python -m pytest -p no:cacheprovider --noconftest -m cuda \\
        tests/test_torch_dist_cuda.py
"""
import pytest
import torch

from _torch_dist import CUDA_CASES, CUDA_DTYPES, run_ranks

pytestmark = pytest.mark.cuda

# the output elementwise, |got - want| <= tol * (1 + |want|); each gradient
# relative to its largest magnitude: fp32 2e-4 and 5e-4 (tests/test_fpdt.py),
# bf16 the repo's bf16 kernel tolerance (tests/test_kernels_flash.py:34)
TOL = {"float32": {"o": 2e-4, "grad": 5e-4}, "bfloat16": {"o": 3e-2, "grad": 3e-2}}


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return run_ranks("fpdt_cuda", 2, tmp_path_factory.mktemp("fpdt_cuda"))


@pytest.mark.parametrize("kind,hq,hkv", CUDA_CASES, ids=str)
@pytest.mark.parametrize("dtype", CUDA_DTYPES)
def test_two_ranks_on_one_card_match_local(readings, kind, hq, hkv, dtype):
    for rank, got in enumerate(readings):
        errs = got[f"{kind} h{hq}-{hkv} {dtype}"]
        assert errs["o"] <= TOL[dtype]["o"], (rank, errs)
        for part in ("dx", "dwq", "dwk", "dwv"):
            assert errs[part] <= TOL[dtype]["grad"], (rank, part, errs)
