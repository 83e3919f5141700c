"""BENCHMARK.json keeps to its contract, and the harness finds every cell,
configuration, traffic mix and per-layer metric by its name alone."""
import json
import re
import statistics
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench import spec, traffic  # noqa: E402

BM = spec.benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"config": {"name", "source", "file", "reduced", "why"},
        "workload": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expan|_dim$|_rank$|d_model"
                   r"|d_ff|experts_per)")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BM) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                       "per_layer"}
    assert BM["command"] == ["python3", "bench/run.py"] and len(BM["command"]) <= 32
    assert all(_line(w) for w in BM["command"])
    assert 1 <= len(BM["paths"]) <= 16
    for p in BM["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    assert isinstance(BM["run_seconds"], int) and 1 <= BM["run_seconds"] <= 51
    assert len(json.dumps(BM)) <= 64 * 1024


def test_every_name_and_unit():
    names = []
    for c in BM["configs"]:
        assert set(c) == KEYS["config"]
        names.append(("config", c["name"]))
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BM["workloads"]:
        assert set(w) == KEYS["workload"] and w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(("workload", w["name"]))
    for kind in ("end_to_end", "per_layer"):
        for m in BM[kind]:
            assert set(m) - {"workloads"} == KEYS[kind]
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            names.append(("metric", m["name"]))
    for _, n in names:
        assert NAME.match(n), n
    for kind in ("config", "workload", "metric"):
        got = [n for k, n in names if k == kind]
        assert len(got) == len(set(got)), f"duplicate {kind} names"


def test_configs_files_and_cuts():
    used = {w["config"] for w in BM["workloads"]}
    files = [c["file"] for c in BM["configs"]]
    assert len(files) == len(set(files))
    for c in BM["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BM["paths"])
        doc = json.loads((ROOT / c["file"]).read_text())
        assert doc["name"] == c["name"] and doc["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert not WIDTH.search(key), f"{key} is a width"
            assert key in doc["published"] and doc["published"][key] != doc["model"][key]


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in BM["end_to_end"]}
    assert {"setup_s", "train_tokens_per_s"} <= set(e2e) and len(e2e) <= 16
    assert 1 <= len(BM["per_layer"]) <= 128
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25
    layers = {}
    for m in BM["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), "one spelling a layer"
    cells = {w["name"] for w in BM["workloads"]}
    for m in BM["per_layer"] + BM["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("name", [w["name"] for w in BM["workloads"]])
def test_each_cell_is_found_by_name(name):
    cell = spec.cell(name, ROOT)
    run = cell.run
    for key in ("fpdt_chunks", "mlp_chunks", "offload", "remat", "ref_steps", "trace_steps",
                "limits"):
        assert key in run
    assert run["limits"] and set(run["limits"]) <= {"loss_gap", "grad_gap", "change_gap"}
    assert cell.traffic["seq"] % run["fpdt_chunks"] == 0
    readers = spec.metric_readers(cell.per_layer)
    assert set(readers) == {m["name"] for m in cell.per_layer}
    assert all(callable(r.read) for r in readers.values())
    assert {"setup_s"} < {m["name"] for m in cell.end_to_end} and cell.per_layer
    assert spec.reference(cell.config["reference"]).loss
    # the cell's per-layer metrics move an end-to-end metric the cell reports
    assert {m["moves"] for m in cell.per_layer} <= {m["name"] for m in cell.end_to_end}


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    fours = sum(w["chips"] == 4 for w in BM["workloads"])
    assert fours <= max(1, len(BM["workloads"]) // 4)


def test_a_full_check_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (BM["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("mix", sorted(p.stem for p in (ROOT / "bench" / "traffic").glob("*.json")))
def test_traffic_is_the_seeds_and_every_seed_the_same_sizes(mix):
    m = json.loads((ROOT / "bench" / "traffic" / f"{mix}.json").read_text())
    small = {**m, "seq": 256}
    a, b = traffic.batch_fn(small, 1000, 2 ** 31 + 5), traffic.batch_fn(small, 1000, 7)
    x0, x1, y0 = a(0), a(1), b(0)
    assert x0["tokens"].shape == y0["tokens"].shape == (m["batch"], 256)
    assert (x0["tokens"] == a(0)["tokens"]).all()
    assert not (x0["tokens"] == x1["tokens"]).all() and not (x0["tokens"] == y0["tokens"]).all()
    assert (x0["labels"][:, :-1] == x0["tokens"][:, 1:]).all()
    assert x0["tokens"].min() >= 0 and x0["tokens"].max() < 1000
    assert statistics.mean((x0["tokens"] == 0).mean(1)) < 0.05
