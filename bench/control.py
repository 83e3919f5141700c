"""Readings that set a cell's limits, at the cell's own size, many seeds in
one process (the benchmark's runs never run this):

  python3 bench/control.py --workload <cell> --seeds 1,2,3 [--program] \\
      [--control] [--fault half_batch] [--fault frozen_state]

For each seed, ``--program`` reads the program's first steps against the
fp32 reference (the numbers a run compares), ``--control`` the reference
computed in fp8 against it (the control, which has to fail), and each
``--fault`` the program with that fault planted: ``half_batch`` (the loss
of half the batch's rows, half the tokens of a single row, the mean over
the rest) or ``frozen_state`` (AdamW returns the parameters and moments
unchanged).  No window: the steps are the reference's.  ``--witness
embed`` reads, on the first batch, the program's gradient of the
embedding table beside the same table gradient summed in fp32 from the
program's own gradient of the looked-up rows (its bf16 table gradient sums
a token's rows in bf16).  One JSON line a reading on standard output.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from bench import harness, spec  # noqa: E402


@contextlib.contextmanager
def fault(name: str):
    """The program's step broken underneath: see the module's docstring."""
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop as TL

    if name == "half_batch":
        orig = TL.value_and_grad

        def half(cfg, par, params, batch):
            labels = batch["labels"].clone()
            if labels.shape[0] > 1:
                labels[labels.shape[0] // 2:] = -100
            else:
                labels[:, labels.shape[1] // 2:] = -100
            return orig(cfg, par, params, {**batch, "labels": labels})

        TL.value_and_grad = half
        try:
            yield
        finally:
            TL.value_and_grad = orig
    elif name == "frozen_state":
        orig = adamw.apply

        def frozen(oc, params, grads, state, par=None, plans=None):
            return params, state, {"grad_norm": adamw.global_norm(grads, par, plans),
                                   "lr": adamw.lr_at(oc, state.step + 1)}

        adamw.apply = frozen
        try:
            yield
        finally:
            adamw.apply = orig
    else:
        raise ValueError(f"unknown fault {name!r}")


def embed_witness(cell, seed: int, device) -> dict:
    """The embedding table's first gradient two ways (see the module's
    docstring), each also as AdamW takes it, clipped by the global norm
    that it gives with the other leaves' gradients."""
    from repro_torch.models import transformer as T
    from repro_torch.runtime import train_loop as TL

    from bench import traffic, weights

    cfg = harness.program_config(cell)
    tree = weights.make(harness.skeleton(cfg), seed, device)
    batch = {k: torch.from_numpy(v).to(device) for k, v in
             traffic.batch_fn(cell.traffic, cfg.vocab_size, seed)(0).items()}
    caught, orig = [], T.embed_input

    def hooked(*args, **kw):
        out = orig(*args, **kw)
        out.register_hook(lambda g: caught.append(g.detach()))
        return out

    T.embed_input = hooked
    try:
        _, _, grads = TL.value_and_grad(cfg, None, tree, batch)
    finally:
        T.embed_input = orig
    table = grads["embed"]
    fp32 = torch.zeros(table.shape, dtype=torch.float32, device=table.device).index_add_(
        0, batch["tokens"].reshape(-1).long(), caught[0].reshape(-1, table.shape[1]).float())
    rest = sum(float(g.float().norm()) ** 2 for k, g in weights.flat(grads).items()
               if k != "embed")
    bf, f32 = float(table.float().norm()), float(fp32.norm())
    clip = cell.config["optimizer"]["clip_norm"]

    def clipped(n):
        return n * min(1.0, clip / ((n * n + rest) ** 0.5 + 1e-9))

    return {"embed_bf16_sum": bf, "embed_fp32_sum": f32, "ratio": bf / f32,
            "clipped_bf16_sum": clipped(bf), "clipped_fp32_sum": clipped(f32),
            "rows_differ_by_1pct": int(((table.float() - fp32).norm(dim=1)
                                         > 0.01 * fp32.norm(dim=1)).sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--witness", choices=["embed"], default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload, ROOT)
    kind = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.witness:
            print(json.dumps({"cell": cell.name, "seed": seed, "what": "witness:embed",
                              "device": kind, **embed_witness(cell, seed, args.device)}),
                  flush=True)
        if not (args.program or args.control or args.fault):
            continue
        t0 = time.perf_counter()
        ref = harness.follow_reference(cell, seed, args.device, "fp32")
        t_ref = time.perf_counter() - t0
        runs = ([("program", None)] if args.program else []) + [("fault:" + f, f)
                                                                for f in args.fault]
        for what, f in runs:
            with fault(f) if f else contextlib.nullcontext():
                res = harness.run_cell(cell, seed, 1e-3, False, args.device, time.perf_counter(),
                                       reference_prec=None)
            print(json.dumps({"cell": cell.name, "seed": seed, "what": what, "device": kind,
                              **harness.compare(res.program, ref)}), flush=True)
        if args.control:
            t0 = time.perf_counter()
            ctl = harness.follow_reference(cell, seed, args.device, "fp8")
            print(json.dumps({"cell": cell.name, "seed": seed, "what": "control", "device": kind,
                              "ref_s": t_ref, "control_s": time.perf_counter() - t0,
                              **harness.compare(ctl, ref)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
