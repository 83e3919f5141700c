"""The JAX package's five example scripts (``examples/*.py``), on the port:

  python -m repro_torch.examples.quickstart            # a ~100M-param model, 100 steps
  python -m repro_torch.examples.convergence_fpdt      # the paper's Fig. 14 curves
  python -m repro_torch.examples.long_context_fpdt     # FPDT vs Ulysses on a 2 x 4 mesh
  python -m repro_torch.examples.fault_tolerance_demo  # preemption, resume, straggler
  python -m repro_torch.examples.serve_batched         # continuous batching

Each takes its JAX script's flags and ``--device {cuda,cpu}``: the card by
default, and with no card it stops rather than run on the CPU.  Its
``main(argv)`` returns what it printed, and each run is a function of its
initial parameters (and batch, where the script draws one), so a caller can
hand it other weights.  Random state comes from a ``torch.Generator``
seeded as the JAX script seeds its ``PRNGKey``; the synthetic batches and
the serve workloads are numpy, the same as JAX's.  Each keeps its JAX
script's assertions and their limits.
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default) or, when asked, on the CPU")


def device_of(kind: str) -> torch.device:
    """The device ``--device`` names; the card, when asked for, must be there."""
    if kind == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to run on the CPU")
    return torch.device(kind)


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def seeded(device: torch.device, seed: int = 0) -> torch.Generator:
    """A generator on ``device``: the port's ``jax.random.PRNGKey(seed)``."""
    return torch.Generator(device=device).manual_seed(seed)
