"""Training CLI, on the card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 3 --batch 1 --seq 8192 --chunks 4 --offload [--remat full] \\
      [--reduced] [--device cuda|cpu]

The JAX package's flags, plus ``--device``.  Weights are random from
``--seed``; batches come from the port's copy of the data pipeline, so they
are the JAX trainer's.  The run is on the card unless ``--device cpu`` asks
for the CPU; with no card it stops instead of falling back.  Every time it
prints names the device it was taken on.  ``--mesh``, checkpointing
(``--ckpt-dir/--ckpt-every/--resume``), ``--compress-grads``, telemetry
(``--trace-out/--metrics-out``) are not yet ported.  ``--remat offload``
keeps each layer cycle's input in pinned host memory until the backward
recomputes the cycle (the paper's "OC."), as ``--offload`` keeps FPDT's
idle chunks there.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Callable, Optional

import torch

from repro_torch.configs import ModelConfig, ShapeConfig, get_config, reduced
from repro_torch.data.pipeline import CheckpointableIterator, make_batch_fn
from repro_torch.launch.serve import device_name
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import TrainConfig, TrainLoop, make_train_step


def opt_config(cfg: ModelConfig, lr: float, steps: int) -> adamw.OptConfig:
    """The CLI's optimizer settings (the JAX trainer's)."""
    return adamw.OptConfig(lr=lr, warmup_steps=min(100, steps // 10 + 1), total_steps=steps,
                           state_dtype=cfg.opt_state_dtype)


def train_steps(cfg: ModelConfig, params, oc: adamw.OptConfig, tc: TrainConfig,
                batch_fn: Callable, device, *, opt_state=None,
                on_step: Optional[Callable[[dict], None]] = None):
    """Take ``tc.steps`` AdamW steps from ``params`` (updated in place) over
    ``batch_fn``'s batches 0, 1, ...  Returns (params, opt_state, history);
    each history record holds the step's loss, grad norm and host-clock
    seconds around work that ends in a device synchronise."""
    device = torch.device(device)
    if opt_state is None:
        opt_state = adamw.init(oc, params)
    loop = TrainLoop(cfg, None, oc, tc, make_train_step(cfg, None, oc, tc),
                     CheckpointableIterator(batch_fn), on_step=on_step)

    def put(b):
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    params, opt_state, _ = loop.run(params, opt_state, put_batch=put)
    return params, opt_state, loop.history


NOT_PORTED = {
    "mesh": "--mesh: device meshes",
    "ckpt_dir": "--ckpt-dir: checkpointing",
    "ckpt_every": "--ckpt-every: checkpointing",
    "resume": "--resume: checkpointing",
    "compress_grads": "--compress-grads: gradient compression",
    "trace_out": "--trace-out: train telemetry",
    "metrics_out": "--metrics-out: train telemetry",
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--chunks", type=int, default=None, help="FPDT u")
    ap.add_argument("--offload", action="store_true",
                    help="keep idle FPDT chunks in pinned host memory")
    ap.add_argument("--remat", default=None, choices=[None, "none", "full", "offload"])
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default) or, when asked, on the CPU")
    # the JAX trainer's flags that are not yet ported: refused below
    ap.add_argument("--mesh", default=None, help="not yet ported")
    ap.add_argument("--ckpt-dir", default=None, help="not yet ported")
    ap.add_argument("--ckpt-every", type=int, default=None, help="not yet ported")
    ap.add_argument("--resume", default=None, help="not yet ported")
    ap.add_argument("--compress-grads", action="store_true", help="not yet ported")
    ap.add_argument("--trace-out", default=None, help="not yet ported")
    ap.add_argument("--metrics-out", default=None, help="not yet ported")
    args = ap.parse_args(argv)
    for name, what in NOT_PORTED.items():
        val = getattr(args, name)
        if val not in (None, False) and not (name == "mesh" and val == "none"):
            ap.exit(2, f"{what} is not yet ported\n")
    if min(args.steps, args.batch, args.seq, args.grad_accum) < 1:
        ap.error("--steps, --batch, --seq and --grad-accum must be >= 1")
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.exit(1, "no CUDA device is available; pass --device cpu to run on the CPU\n")
    device = torch.device(args.device)
    name = device_name(device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    over = {}
    if args.chunks:
        over.update(fpdt_chunks=args.chunks, mlp_chunks=2 * args.chunks)
    if args.offload:
        over["fpdt_offload"] = True
    if args.remat:
        over["remat"] = args.remat
    if over:
        cfg = dataclasses.replace(cfg, **over)

    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    oc = opt_config(cfg, args.lr, args.steps)
    tc = TrainConfig(steps=args.steps, log_every=args.log_every, grad_accum=args.grad_accum)
    bf = make_batch_fn(cfg, ShapeConfig("cli", args.seq, args.batch, "train"))
    _, _, history = train_steps(cfg, params, oc, tc, bf, device)
    tokens = args.batch * args.seq
    for rec in history:
        print(f"step {rec['step']}: loss {rec['loss']:.4f} grad_norm {rec['grad_norm']:.4f} "
              f"{rec['dt'] * 1e3:.1f} ms ({tokens / rec['dt']:.1f} tokens/s) on {name}")
    return history


if __name__ == "__main__":
    main(sys.argv[1:])
