"""The comparison that decides ``correct`` fails what it must, at a size a
test run holds (the CPU; the chip runs the same at each cell's size through
``bench/control.py``): each cell's limits pass the program as configured
(bf16) and fail the fp8 control and every fault a training cell can have,
a state left unchanged and half of the batch left out.  The harness's run
is driven whole, only its look for a chip skipped."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src", ROOT / "bench" / "tests"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench import control, harness, spec  # noqa: E402
from bench.run import result_line  # noqa: E402
from test_benchreference import small_cell  # noqa: E402

CELLS = [w["name"] for w in spec.benchmark(ROOT)["workloads"]]
SEED = 2 ** 31 + 99


def _cell(name):
    real = spec.cell(name, ROOT)
    small = small_cell(real.config["name"], param_dtype="bfloat16")
    return spec.Cell(name, 1, small.config, small.traffic,
                     {**small.run, "ref_steps": real.run["ref_steps"],
                      "limits": real.run["limits"]}, real.end_to_end, real.per_layer)


def _correct(cell, res):
    return result_line(cell, res, False, "cpu")["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_the_program_passes(name):
    cell = _cell(name)
    res = harness.run_cell(cell, SEED, 0.2, False, "cpu", 0.0)
    assert _correct(cell, res), res.gaps


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["frozen_state", "half_batch"])
def test_a_fault_fails(name, fault):
    cell = _cell(name)
    with control.fault(fault):
        res = harness.run_cell(cell, SEED, 0.2, False, "cpu", 0.0)
    assert not _correct(cell, res), res.gaps


@pytest.mark.parametrize("name", CELLS)
def test_the_fp8_control_fails(name):
    cell = _cell(name)
    ref = harness.follow_reference(cell, SEED, "cpu", "fp32")
    ctl = harness.follow_reference(cell, SEED, "cpu", "fp8")
    gaps = harness.compare(ctl, ref)
    assert any(gaps[k] > v for k, v in cell.run["limits"].items()), gaps
