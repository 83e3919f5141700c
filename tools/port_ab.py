"""Time the port's llama3.2-1b serve and train paths in two source trees of
the repo, alternately (A, B, B, A, then B, A, A, B, ... for ``--rounds``),
each run in a process of its own on one card, so that a difference between
two commits is read within one call.

  python3 tools/port_ab.py --trees _archive/parent _archive/change --rounds 2

Each run puts ``<tree>/src`` first on the path (its kernels build into that
tree at their first launch), then, at full size with random bf16 weights
from seed 0:

* serve: ``launch.serve.serve_batch`` at b4, prompt 64, gen 32, greedy
  (the CLI's own function, as ``chip_smoke.py`` drives it), two warm-up
  calls, then ``--serve-reps`` timed calls: prefill ms and decode ms a step
  on the host clock around work that ends in a device synchronise;
* train: ``launch.train.train_steps`` at b1, seq 8192, u 4, mlp_chunks 8,
  remat full, FPDT offload on (``chip_smoke.py``'s training settings), one
  warm-up step and ``--train-steps`` timed steps.

It prints one JSON line a run and, last, each tree's medians over its runs
beside the card's name and power limit.  It uses only the functions both
trees have.  Needs a CUDA card; exits 1 without one.

  python3 tools/port_ab.py --trees _archive/parent _archive/change --ops

counts instead, on the CPU, the aten operators that the same serve and
train paths dispatch in each tree at the reduced size (serve b4 prompt 64
gen 4; one train step at seq 64 with the settings above), and prints the
totals and every operator whose count differs.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import statistics
import subprocess
import sys


def _worker(tree: str, serve_reps: int, train_steps: int) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import pipeline as DP
    from repro_torch.launch import serve as SERVE
    from repro_torch.launch import train as TRAIN
    from repro_torch.models import transformer as T
    from repro_torch.runtime import train_loop as TL

    dev = torch.device("cuda")
    arch = "llama3.2-1b"
    cfg = dataclasses.replace(get_config(arch), remat="none")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(cfg, gen, dev)
    tokens = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen, device=dev)
    for _ in range(2):
        SERVE.serve_batch(cfg, params, tokens, gen=32)
    prefill, decode = [], []
    for _ in range(serve_reps):
        out = SERVE.serve_batch(cfg, params, tokens, gen=32)
        prefill.append(out["prefill_ms"])
        decode.append(out["decode_ms"] / out["steps"])
    del params, out
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config(arch), fpdt_chunks=4, mlp_chunks=8, remat="full",
                              fpdt_offload=True)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    steps = 1 + train_steps
    batch_fn = DP.make_batch_fn(cfg, ShapeConfig("ab", 8192, 1, "train"))
    history = TRAIN.train_steps(cfg, params, TRAIN.opt_config(cfg, 3e-4, steps),
                                TL.TrainConfig(steps=steps, log_every=steps + 1), batch_fn,
                                dev)[2]
    return {"tree": tree, "prefill_ms": prefill, "decode_ms_per_step": decode,
            "train_step_ms": [r["dt"] * 1e3 for r in history[1:]]}


def _op_counts(tree: str) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import ShapeConfig, get_config, reduced
    from repro_torch.data import pipeline as DP
    from repro_torch.launch import serve as SERVE
    from repro_torch.launch import train as TRAIN
    from repro_torch.models import transformer as T
    from repro_torch.runtime import train_loop as TL

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[str(func)] += 1
            return func(*args, **(kwargs or {}))

    base = reduced(get_config("llama3.2-1b"))
    cfg = dataclasses.replace(base, remat="none")
    gen = torch.Generator().manual_seed(0)
    params = T.init_params(cfg, gen, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen)
    with Count() as serve:
        SERVE.serve_batch(cfg, params, tokens, gen=4)
    cfg = dataclasses.replace(base, fpdt_chunks=4, mlp_chunks=8, remat="full", fpdt_offload=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with Count() as train:
        TRAIN.train_steps(cfg, params, TRAIN.opt_config(cfg, 3e-4, 1),
                          TL.TrainConfig(steps=1, log_every=2),
                          DP.make_batch_fn(cfg, ShapeConfig("ab", 64, 1, "train")), "cpu")
    return {"tree": tree, "serve": dict(serve.n), "train": dict(train.n)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--ops", action="store_true",
                    help="count the aten operators of each tree's paths on the CPU")
    ap.add_argument("--serve-reps", type=int, default=5)
    ap.add_argument("--train-steps", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    if args.worker:
        work = _op_counts(args.worker) if args.ops else _worker(args.worker, args.serve_reps,
                                                                args.train_steps)
        print(json.dumps(work), flush=True)
        return 0
    if not args.trees:
        ap.error("--trees A B is required")
    if args.ops:
        got = [json.loads(subprocess.run([sys.executable, os.path.abspath(__file__), "--ops",
                                          "--worker", tree], capture_output=True, text=True,
                                         check=True).stdout.strip().splitlines()[-1])
               for tree in args.trees]
        for path in ("serve", "train"):
            a, b = (g[path] for g in got)
            diff = {op: (a.get(op, 0), b.get(op, 0)) for op in sorted({*a, *b})
                    if a.get(op, 0) != b.get(op, 0)}
            print(f"{path}: {sum(a.values())} / {sum(b.values())} aten operators; differing: "
                  f"{diff or 'none'}")
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    a, b = args.trees
    runs = []
    order = [t for i in range(args.rounds) for t in ((a, b, b, a) if i % 2 == 0 else (b, a, a, b))]
    for tree in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree,
                               "--serve-reps", str(args.serve_reps),
                               "--train-steps", str(args.train_steps)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    for tree in (a, b):
        mine = [r for r in runs if r["tree"] == tree]
        med = {k: statistics.median(x for r in mine for x in r[k])
               for k in ("prefill_ms", "decode_ms_per_step", "train_step_ms")}
        print(f"{tree}: median prefill {med['prefill_ms']:.2f} ms, decode "
              f"{med['decode_ms_per_step']:.3f} ms/step, train step "
              f"{med['train_step_ms']:.1f} ms over {len(mine)} runs [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
