"""Fault-tolerance demo: preemption, elastic resume and straggler detection
(the JAX package's ``examples/fault_tolerance_demo.py``).

1. Train with periodic async checkpoints, then simulate a preemption: the
   loop's ``on_step`` sends this process SIGTERM after step 12, and the
   loop stops there with a final blocking checkpoint (12 is not one of the
   every-5 steps).  The JAX script fires it from a 6 s timer; on the card
   the 30 steps end well before that, so no preemption would happen.
2. Resume from the newest manifest and finish on the SAME loss trajectory:
   the resumed losses of steps 13-30 equal an uninterrupted run's, bit for
   bit.
3. Feed the heartbeat monitor an injected straggler and show the re-mesh
   alert a 1000-node launcher would act on.

  PYTHONPATH=src python -m repro_torch.examples.fault_tolerance_demo
  PYTHONPATH=src python -m repro_torch.examples.fault_tolerance_demo --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import signal
import tempfile
import threading

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.examples import add_device_flag, device_of, seeded
from repro_torch.launch.serve import device_name
from repro_torch.launch.train import train_steps
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import HeartbeatMonitor, StragglerAlert, TrainConfig
from repro_torch.tree import tree_map

PREEMPT_AT = 12


def demo_config():
    return dataclasses.replace(reduced(get_config("llama3.2-1b")), num_layers=2)


def straggler_alert() -> str:
    """Phase 3: 40 steady heartbeats, then two slow ones; the alert's text."""
    mon = HeartbeatMonitor(zscore=4.0, patience=2)
    try:
        for i in range(40):
            mon.record(0.10 + 0.001 * (i % 3))
        mon.record(2.5)  # injected slow host
        mon.record(2.5)
    except StragglerAlert as e:
        return str(e)
    raise RuntimeError("straggler not detected")


def run(cfg, params, ckpt_dir: str, device, preempt_at: int = PREEMPT_AT):
    """The three phases from ``params`` (left unchanged), checkpointing into
    ``ckpt_dir`` (emptied first); returns what they showed."""
    if threading.current_thread() is not threading.main_thread():
        raise RuntimeError("the demo sends this process SIGTERM, which only the main "
                           "thread's loop catches: run it on the main thread")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    oc = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=30)
    tc = TrainConfig(steps=30, ckpt_every=5, log_every=5)
    bf = make_batch_fn(cfg, ShapeConfig("ft", 64, 2, "train"))
    mgr = CheckpointManager(ckpt_dir)

    def fresh():
        return tree_map(torch.clone, params)

    def preempt(rec):
        if rec["step"] == preempt_at:
            os.kill(os.getpid(), signal.SIGTERM)

    # --- phase 1: train, then preempt mid-run
    print(f"== phase 1: training until preemption (SIGTERM after step {preempt_at}) ==")
    first = train_steps(cfg, fresh(), oc, tc, bf, device, ckpt=mgr, on_step=preempt).history
    reached = first[-1]["step"]
    print(f"preempted at step {reached}; checkpoints on disk: {mgr.all_steps()}")
    if not (reached == preempt_at < tc.steps and reached % tc.ckpt_every):
        raise AssertionError(f"stopped at step {reached}, not at the preemption after step "
                             f"{preempt_at}")
    if mgr.latest_step() != reached:  # the final blocking save happened
        raise AssertionError(f"newest checkpoint {mgr.latest_step()}, not step {reached}")

    # --- phase 2: elastic resume from the newest manifest
    print("\n== phase 2: resume ==")
    like = fresh()
    restored, extra = mgr.restore(mgr.latest_step(), {"params": like,
                                                      "opt": adamw.init(oc, like)})
    second = train_steps(cfg, restored["params"], oc, tc, bf, device, opt_state=restored["opt"],
                         ckpt=mgr, start_step=extra["data_step"]).history
    end = second[-1]["step"]
    print(f"resumed from {extra['data_step']} and finished at step {end}")
    if end != tc.steps:
        raise AssertionError(f"the resumed run ended at step {end}, not {tc.steps}")
    print("-- the same 30 steps uninterrupted, from the same weights --")
    whole =train_steps(cfg, fresh(), oc, tc, bf, device).history
    same = [r["loss"] for r in first + second] == [r["loss"] for r in whole]
    print(f"losses of steps 1-{reached} and the resumed {reached + 1}-{end} against an "
          f"uninterrupted run: {'the same bits' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("the resumed run left the uninterrupted run's loss trajectory")

    # --- phase 3: straggler detection
    print("\n== phase 3: straggler detection ==")
    alert = straggler_alert()
    print(f"StragglerAlert raised -> launcher re-meshes: {alert}")
    return {"reached": reached, "end": end, "checkpoints": mgr.all_steps(),
            "losses": [r["loss"] for r in first + second], "straggler": alert}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "ft_demo_ckpt"),
                    help="emptied first (default ft_demo_ckpt under the temporary directory, "
                         "$TMPDIR or /tmp)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = device_of(args.device)
    cfg = demo_config()
    out = run(cfg, T.init_params(cfg, seeded(device), device), args.ckpt_dir, device)
    print(f"\nALL FT PHASES PASSED on {device_name(device)}")
    return out


if __name__ == "__main__":
    main()
