"""Quickstart: train a ~100M-parameter llama-style model end to end (the
JAX package's ``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart                 # 100 steps
  PYTHONPATH=src python -m repro_torch.examples.quickstart --steps 300 --batch 8 --seq 256
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu --steps 2 --seq 32

Uses the port's whole training stack: the config system, the synthetic
checkpointable data pipeline, AdamW with its cosine schedule, remat full,
the chunked loss and async checkpoints; on the card attention runs the
hand-written flash kernels (``kernels/flash_attention``).  Weights are
random from seed 0.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.examples import add_device_flag, device_of, seeded
from repro_torch.launch.serve import device_name
from repro_torch.launch.train import train_steps
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import TrainConfig


def quickstart_config() -> ModelConfig:
    """~100M params (d=640, 10 layers, tied 32k vocab)."""
    return ModelConfig(
        name="quickstart-100m", family="dense", num_layers=10, d_model=640,
        num_heads=10, num_kv_heads=5, head_dim=64, d_ff=2560, vocab_size=32768,
        mlp_act="swiglu", norm="rmsnorm", tie_embeddings=True, remat="full",
        block_q=128, block_k=128,
    )


def train(cfg: ModelConfig, params, *, steps: int, batch: int, seq: int, lr: float,
          ckpt_dir: str, device):
    """``steps`` AdamW steps from ``params`` over the pipeline's batches,
    checkpointing into ``ckpt_dir``; returns (history, the manager)."""
    oc = adamw.OptConfig(lr=lr, warmup_steps=max(10, steps // 10), total_steps=steps)
    tc = TrainConfig(steps=steps, ckpt_every=max(50, steps // 2), log_every=10)
    mgr = CheckpointManager(ckpt_dir)
    bf = make_batch_fn(cfg, ShapeConfig("quickstart", seq, batch, "train"))
    run = train_steps(cfg, params, oc, tc, bf, device, ckpt=mgr)
    return run.history, mgr


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "quickstart_ckpt"),
                    help="default quickstart_ckpt under the temporary directory ($TMPDIR or "
                         "/tmp)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)

    cfg = quickstart_config()
    print(f"model: {cfg.num_params() / 1e6:.0f}M params, on {device_name(device)}")
    params = T.init_params(cfg, seeded(device), device)
    t0 = time.perf_counter()
    history, mgr = train(cfg, params, steps=args.steps, batch=args.batch, seq=args.seq,
                         lr=args.lr, ckpt_dir=args.ckpt_dir, device=device)
    seconds = time.perf_counter() - t0

    losses = [h["loss"] for h in history]
    n = max(1, len(losses) // 10)
    first, last = sum(losses[:n]) / n, sum(losses[-n:]) / n
    print(f"\nloss: {first:.3f} -> {last:.3f} "
          f"({'OK: decreasing' if last < first else 'WARN: not decreasing'}), "
          f"{len(losses)} steps in {seconds:.1f} s on {device_name(device)}")
    print(f"checkpoints: {mgr.all_steps()} in {args.ckpt_dir}")
    return {"history": history, "first": first, "last": last, "checkpoints": mgr.all_steps(),
            "seconds": seconds}


if __name__ == "__main__":
    main()
