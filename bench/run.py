"""Run one cell of the benchmark once and print its result as the last line.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the checkout's root, on a machine with the cards the cell asks for.
With ``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (from torch.profiler over the steps
after the window) and the device's busy seconds.  ``correct`` says whether
the program's first steps agree with the plain reference's within each
limit of the cell; every number compared is printed beside its limit, as
the last lines on standard error and under ``checks`` in the result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole
CACHE = ROOT / ".bench_cache"


def _env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    the program's own nvcc builds already live in it
    (``src/repro_torch/kernels/build``)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _metric(value, unit):
    return {"value": value, "unit": unit}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        ap.error("--seed must be >= 0 and --seconds > 0")
    _env()
    import torch

    from bench import harness, spec

    cell = spec.cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    if cell.chips != 1:
        print(f"{args.workload}: only one-chip cells are run by this harness", file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # one process, few threads: the host dispatches, it does not compute
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"the process has loaded {bad} (JAX or its reference package)", file=sys.stderr)
        return 3
    out = result_line(cell, res, bool(args.trace), torch.cuda.get_device_name(0))
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def result_line(cell, res, trace: bool, kind: str) -> dict:
    """The result object: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` [, ``breakdown``], and ``checks`` last."""
    from bench import yardstick as Y
    from bench.spec import metric_readers

    limits = cell.run["limits"]
    checks = {k: {"value": res.gaps[k], "limit": limits[k]} for k in limits}
    correct = res.finite and all(c["value"] <= c["limit"] for c in checks.values())
    tokens = cell.traffic["batch"] * cell.traffic["seq"]
    flops = Y.model_flops(cell.config["model"], cell.traffic["batch"], cell.traffic["seq"])
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": res.peak_bytes}
    out = {"correct": correct, "attempted": res.steps, "failed": 0 if res.finite else 1}
    if not trace:
        e2e = {"train_tokens_per_s": _metric(res.steps * tokens / res.window_s, "tokens/s"),
               "mfu": _metric(100.0 * res.steps * flops
                              / (res.window_s * Y.PEAK_BF16_FLOPS * cell.chips), "%"),
               "peak_mem_gib": _metric(res.peak_bytes / 2 ** 30, "GiB"),
               "setup_s": _metric(res.setup_s, "s")}
        out["metrics"] = {m["name"]: e2e[m["name"]] for m in cell.end_to_end}
    else:
        tr = res.trace
        readers = metric_readers(cell.per_layer)
        metrics = {}
        for m in cell.per_layer:
            v = readers[m["name"]].read(tr)
            if v is not None:
                metrics[m["name"]] = _metric(v, m["unit"])
        out["metrics"] = metrics
        device["busy_s"] = tr.union_s(lambda n, g: True)
        device["window_s"] = tr.window_s
        out["breakdown"] = breakdown(tr)
    out["device"] = device
    out["checks"] = checks
    return out


def breakdown(tr) -> dict:
    """Device seconds by kernel group, and the longest idle stretches of
    the device summed by the innermost host event traced under their middle
    (a CUDA runtime call), else by the kernel group the host was about to
    launch."""
    import bisect

    from bench import yardstick as Y

    ops = sorted(((g, tr.group_s(g)) for g in Y.GROUPS), key=lambda kv: -kv[1])
    busy = Y.merged([(s, e) for _, _, s, e in tr.kernels])
    if not busy:
        return {"device_ops": [[g, s] for g, s in ops if s > 0][:10], "idle_gaps": []}
    lo = min([busy[0][0]] + [s for _, s, _ in tr.host_ops])
    hi = max([busy[-1][1]] + [e for _, _, e in tr.host_ops])
    holes = sorted(Y.gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:200]
    host = sorted(tr.host_ops, key=lambda h: h[1])
    starts = [h[1] for h in host]
    firsts = [s for s, _ in busy]
    group_at = {s: g for _, g, s, _ in reversed(tr.kernels)}
    by_name = {}
    for s, e in holes:
        t = (s + e) / 2
        i = bisect.bisect_right(starts, t)
        best = None
        for j in range(i - 1, max(-1, i - 4000), -1):
            name, hs, he = host[j]
            if he >= t and (best is None or he - hs < best[1]):
                best = (name, he - hs)
        nxt = bisect.bisect_left(firsts, e)
        key = best[0] if best else "host, before " + (
            group_at[busy[nxt][0]] if nxt < len(busy) else "the end")
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e6
    idle = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[g, s] for g, s in ops if s > 0][:10],
            "idle_gaps": [[n, s] for n, s in idle]}


if __name__ == "__main__":
    sys.exit(main())
