"""The benchmark's frozen arithmetic against the originals it was copied
from (the port's reckoners and chip_smoke.py's), at each cell's shapes,
and the interval sums of a trace."""
import importlib.util
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench import spec  # noqa: E402
from bench import yardstick as Y  # noqa: E402
from bench.harness import program_config  # noqa: E402

# every cell with a workload file: those in BENCHMARK.json and those kept out of it
CELLS = sorted(p.stem for p in (ROOT / "bench" / "workloads").glob("*.json"))


@pytest.fixture(scope="module")
def smoke():
    s = importlib.util.spec_from_file_location("chip_smoke_for_bench", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", CELLS)
def test_model_flops_and_params_match_the_port(name):
    from repro_torch.launch import dryrun

    cell = spec.cell(name, ROOT)
    cfg = program_config(cell)
    b, s = cell.traffic["batch"], cell.traffic["seq"]
    assert Y.num_params(cell.config["model"]) == cfg.num_params()
    assert Y.model_flops(cell.config["model"], b, s) == dryrun.model_flops(cfg, b, s)


@pytest.mark.parametrize("args", [(512, 512, 0, 0, 0), (64, 128, 128, 0, 0), (64, 64, 0, 64, 0),
                                  (100, 100, 300, 200, 50), (16, 32, 40, 0, 8)])
def test_live_pairs_is_the_ports(args):
    from repro_torch.launch import dryrun

    assert Y.live_pairs(*args) == dryrun.live_pairs(*args)


def _chunk_calls(cell):
    """(b, hq, hkv, sq, sk, d, bytes, q_offset, k_offset, carry) of every
    FPDT pair of the cell's layer: its chunks, their offsets, a carry on
    all but the first pair of a row."""
    m, t, u = cell.config["model"], cell.traffic, cell.run["fpdt_chunks"]
    c = t["seq"] // u
    for i in range(u):
        for j in range(i + 1):
            yield (t["batch"], m["num_heads"], m["num_kv_heads"], c, c, m["head_dim"], 2,
                   i * c, j * c, j > 0)


@pytest.mark.parametrize("name", [n for n in CELLS if "gpt" in n])
def test_kernel_bounds_match_chip_smoke(name, smoke):
    cell = spec.cell(name, ROOT)
    calls = list(_chunk_calls(cell))
    if len(calls) > 40:
        calls = calls[:20] + calls[-20:]
    for b, hq, hkv, sq, sk, d, nb, qo, ko, carry in calls:
        ms, _ = smoke._bound(b, hq, hkv, sq, sk, d, nb, qo, ko, carry)
        assert Y.call_bound(b, hq, hkv, sq, sk, d, nb, qo, ko, carry) * 1e3 == pytest.approx(
            ms, rel=1e-12)
        for which in ("dq", "dkv"):
            ms, _ = smoke._bwd_bound(which, b, hq, hkv, sq, sk, d, nb, qo, ko)
            assert Y.bwd_bound(which, b, hq, hkv, sq, sk, d, nb, qo, ko) * 1e3 == pytest.approx(
                ms, rel=1e-12)


def test_scan_bounds_are_bytes_bound_as_chip_smoke_counts_them(smoke):
    n, h0 = 256 * 131072, 131072
    assert Y.scan_bound(n, 4, 4, 0) == pytest.approx(3 * 4 * n / smoke.PEAK_BYTES)
    assert Y.scan_bound(n, 4, 4, h0) == pytest.approx((3 * n + h0) * 4 / smoke.PEAK_BYTES)
    assert Y.scan_bwd_bound(n, 4, 4, 0) == pytest.approx(5 * 4 * n / smoke.PEAK_BYTES)
    assert (Y.PEAK_BF16_FLOPS, Y.PEAK_FP32_FLOPS, Y.PEAK_BYTES) == (
        smoke.PEAK_BF16_FLOPS, smoke.PEAK_FP32_FLOPS, smoke.PEAK_BYTES)


@pytest.mark.parametrize("kernel", [
    "void flash_fwd_tc_kernel<80>(...)", "void flash_bwd_dq_tc_kernel<80>(...)",
    "void flash_bwd_dkv_tc_kernel<80>(...)", "flash_bwd_round_do_kernel",
    "flash_bwd_dkv_split_sum_kernel", "void linear_scan_kernel<float, float>(...)",
    "void linear_scan_bwd_kernel<float, float>(...)", "sm90_xmma_gemm_bf16bf16_bf16f32",
    "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN", "Memcpy HtoD (Pinned -> Device)",
    "Memset (Device)", "void at::native::vectorized_elementwise_kernel<4, ...>",
    "ampere_sgemm_128x64_nn"])
def test_groups_are_chip_smokes(kernel, smoke):
    assert Y.group_of(kernel) == smoke._group_of(kernel)


def test_interval_arithmetic(smoke):
    a = [(0, 10), (5, 12), (20, 30), (30, 31), (40, 41)]
    b = [(8, 21), (29, 45)]
    ma, mb = Y.merged(a), Y.merged(b)
    assert ma == [[0, 12], [20, 31], [40, 41]] == smoke._merged(a)
    assert Y.length(ma) == 24 == smoke._length(ma)
    assert Y.overlap(ma, mb) == smoke._overlap(ma, mb) == 4 + 1 + 2 + 1
    assert Y.gaps(ma, -5, 50) == [(-5, 0), (12, 20), (31, 40), (41, 50)]
    assert Y.gaps(ma, 1, 11) == []
    assert Y.gaps([], 0, 3) == [(0, 3)]
