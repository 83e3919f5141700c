"""Paper Fig. 14: FPDT is a pure systems optimization: training curves with
and without chunking and offload coincide (the JAX package's
``examples/convergence_fpdt.py``).

Trains a tiny GPT three ways on identical data (baseline, FPDT-chunked,
FPDT-chunked with its idle chunks in pinned host memory) and prints the
loss curves and their largest divergence.

  PYTHONPATH=src python -m repro_torch.examples.convergence_fpdt --steps 40
  PYTHONPATH=src python -m repro_torch.examples.convergence_fpdt --device cpu --steps 4
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.examples import add_device_flag, device_of, seeded, to_device
from repro_torch.launch.serve import device_name
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import make_train_step

# name, FPDT chunks u, offload
VARIANTS = (("baseline", 1, False), ("fpdt-u4", 4, False), ("fpdt-u4-offload", 4, True))
MAX_DEVIATION = 5e-3


def base_config():
    return dataclasses.replace(reduced(get_config("gpt-2.7b")), num_layers=2, block_q=16,
                               block_k=16)


def variant_configs(base):
    return {name: dataclasses.replace(base, fpdt_chunks=u, fpdt_offload=off)
            for name, u, off in VARIANTS}


def run(cfg, steps: int, batch_fn, params, device):
    """The losses of ``steps`` AdamW steps (lr 1e-3, warmup 5) from
    ``params`` (updated in place) over ``batch_fn``'s batches 0, 1, ..."""
    oc = adamw.OptConfig(lr=1e-3, warmup_steps=5, total_steps=steps)
    opt = adamw.init(oc, params)
    step = make_train_step(cfg, None, oc)
    losses = []
    for i in range(steps):
        params, opt, metrics = step(params, opt, to_device(batch_fn(i), device))
        losses.append(float(metrics["loss"]))
    return losses


def deviations(curves):
    """max |loss - baseline| of each curve."""
    ref = np.asarray(curves["baseline"])
    return {name: float(np.max(np.abs(np.asarray(c) - ref))) for name, c in curves.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    base = base_config()
    batch_fn = make_batch_fn(base, ShapeConfig("conv", 64, 4, "train"))
    curves = {}
    for name, cfg in variant_configs(base).items():
        curves[name] = run(cfg, args.steps, batch_fn, T.init_params(cfg, seeded(device), device),
                           device)
        print(f"{name:18s} " + " ".join(f"{l:.3f}" for l in
                                       curves[name][:: max(1, args.steps // 8)]))
    devs = deviations(curves)
    for name, dev in devs.items():
        print(f"max |loss - baseline| for {name}: {dev:.5f}")
        if not dev < MAX_DEVIATION:
            raise AssertionError(name)
    print(f"\ncurves coincide -> FPDT does not change optimization (Fig 14), on "
          f"{device_name(device)}.")
    return {"curves": curves, "deviations": devs}


if __name__ == "__main__":
    main()
