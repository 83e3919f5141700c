"""Training CLI, on the card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 3 --batch 1 --seq 8192 --chunks 4 --offload [--remat full] \\
      [--reduced] [--device cuda|cpu] [--mesh none|host8|DxM] [--dist-backend nccl|gloo] \\
      [--ckpt-dir DIR [--ckpt-every 50] [--resume auto|N]] [--compress-grads] \\
      [--trace-out T.json] [--metrics-out M.prom]

Every flag of the JAX trainer, plus ``--device`` and ``--dist-backend``.  Weights
are random from ``--seed``; batches come from the port's copy of the data
pipeline, so they are the JAX trainer's.  The run is on the card unless
``--device cpu`` asks for the CPU; with no card it stops instead of falling
back.  Every time it prints names the device it was taken on.
``--remat offload`` keeps each layer cycle's input in pinned host memory
until the backward recomputes the cycle (the paper's "OC."), as
``--offload`` keeps FPDT's idle chunks there.

``--mesh DxM`` (``host8``: the JAX CLI's 2 data x 4 model) trains over
D*M ranks, sequence-parallel over M (FPDT's Ulysses or CP kind,
``models/transformer.py::attn_kind``; the recurrent mixers' two-pass scans
over the ranks' spans, ``models/mamba.py``) and data-parallel over D, with
every weight and its AdamW moments sharded over the mesh as the JAX
package places them (ZeRO-3, ``launch/shardings.py``: gathered at use,
gradients reduce-scattered); rank 0 prints the layout.
Without ``WORLD_SIZE`` in the environment the CLI spawns the ranks itself
(``torch.multiprocessing``, a ``file://`` store in a temporary directory);
under ``torchrun`` it joins the world it finds.  Rank r runs on cuda:(LOCAL_RANK % cards), or the CPU.
``--dist-backend`` is nccl on the card and gloo on the CPU unless given:
NCCL needs one card a rank, gloo can share one.  Only rank 0 prints.

``--ckpt-dir`` checkpoints every ``--ckpt-every`` steps and at the end, and
after SIGTERM/SIGINT (``checkpoint/manager.py``, the JAX package's layout
on disk); ``--resume auto`` (the newest step) or ``--resume N`` restores
before training, onto the mesh this run has, whatever mesh wrote it.

``--compress-grads`` quantizes the summed gradients to int8 blocks with
error feedback before AdamW (``optim/compression.py``; under a mesh with
the whole leaves' blocks, bit for bit).  Unlike the JAX CLI, whose loop
never hands its step the residuals and so compresses nothing, the port's
loop carries them (fp32, 4 bytes a parameter of the rank's shards); they
are not checkpointed and restart at zero after ``--resume``.
``--trace-out`` writes the loop's ``train.step`` spans as Chrome
trace-event JSON and ``--metrics-out`` its metrics registry as Prometheus
text (``runtime/telemetry.py``), after the run; under ``--mesh`` every
rank records and rank 0 writes.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Any, Callable, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ModelConfig, ShapeConfig, get_config, reduced
from repro_torch.core.parallel import ParallelContext
from repro_torch.data.pipeline import CheckpointableIterator, make_batch_fn, shard_batch
from repro_torch.launch import mesh as MESH
from repro_torch.launch.serve import device_name
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.runtime import telemetry as TM
from repro_torch.runtime.train_loop import TrainConfig, TrainLoop, make_train_step


def opt_config(cfg: ModelConfig, lr: float, steps: int) -> adamw.OptConfig:
    """The CLI's optimizer settings (the JAX trainer's)."""
    return adamw.OptConfig(lr=lr, warmup_steps=min(100, steps // 10 + 1), total_steps=steps,
                           state_dtype=cfg.opt_state_dtype)


class TrainRun(NamedTuple):
    """What ``train_steps`` hands back."""

    params: Any
    opt_state: adamw.OptState
    history: List[dict]  # per step: loss, grad_norm, dt (host-clock seconds)[, aux]
    telemetry: TM.Telemetry  # the loop's
    residuals: Any  # the error-feedback residuals under tc.compress_grads, else None


def train_steps(cfg: ModelConfig, params, oc: adamw.OptConfig, tc: TrainConfig,
                batch_fn: Callable, device, *, par: Optional[ParallelContext] = None,
                opt_state=None, on_step: Optional[Callable[[dict], None]] = None,
                ckpt: Optional[CheckpointManager] = None, start_step: int = 0) -> TrainRun:
    """Take AdamW steps ``start_step`` + 1 .. ``tc.steps`` from ``params``
    (updated in place; under a mesh this rank's shards, ``init_params(...,
    par)``) over ``batch_fn``'s batches ``start_step``, ... (under a mesh,
    each rank's part of them), checkpointing through ``ckpt``.  Each history
    record holds the step's loss, grad norm and host-clock seconds around
    work that ends in a device synchronise."""
    device = torch.device(device)
    if opt_state is None:
        opt_state = adamw.init(oc, params)
    loop = TrainLoop(cfg, par, oc, tc, make_train_step(cfg, par, oc, tc),
                     CheckpointableIterator(batch_fn), ckpt, on_step=on_step)

    def put(b):
        return {k: torch.from_numpy(v).to(device)
                for k, v in shard_batch(b, par, cfg.fpdt_chunks).items()}

    params, opt_state, _ = loop.run(params, opt_state, start_step, put_batch=put)
    return TrainRun(params, opt_state, loop.history, loop.telemetry, loop.residuals)


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
    ap.add_argument("--mesh", default=None,
                    help="none, host8 (2 data x 4 model) or DxM: train over D*M ranks")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="the ranks' backend under --mesh (default nccl on the card, gloo on "
                         "the CPU)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default=None, help="'auto' or a step number")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 gradient blocks with error feedback before AdamW")
    ap.add_argument("--trace-out", default="",
                    help="write per-step train.step spans as Chrome trace-event JSON "
                         "(Perfetto-viewable)")
    ap.add_argument("--metrics-out", default="",
                    help="write the step-timing metrics registry as Prometheus text exposition")
    args = ap.parse_args(argv)
    if min(args.steps, args.batch, args.seq, args.grad_accum, args.ckpt_every) < 1:
        ap.error("--steps, --batch, --seq, --grad-accum and --ckpt-every must be >= 1")
    if args.resume not in (None, "auto") and not args.resume.isdigit():
        ap.error(f"--resume takes auto or a step number, not {args.resume!r}")
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.exit(1, "no CUDA device is available; pass --device cpu to run on the CPU\n")
    if args.mesh in (None, "none"):
        return _train(args, None, torch.device(args.device))
    try:
        shape = MESH.parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    backend = MESH.default_backend(args.dist_backend, args.device)
    if args.device == "cpu" and backend == "nccl":
        ap.error("nccl runs on the card: --device cpu takes --dist-backend gloo")
    return MESH.run_ranks(shape[0] * shape[1], backend, main,
                          list(argv if argv is not None else sys.argv[1:]),
                          lambda: _rank_main(args, shape, backend))


def _rank_main(args, shape, backend):
    """One rank of a ``--mesh`` run: join the world, build the mesh, train."""
    _, world, local_rank = MESH.init_from_env(backend)
    try:
        device = MESH.take_device(args.device, local_rank, world)
        par = ParallelContext(MESH.make_mesh(*shape))
        return _train(args, par, device)
    finally:
        dist.destroy_process_group()


def _layout(cfg: ModelConfig, par: ParallelContext, seq: int) -> str:
    """The chunk-interleaved layout of ``seq`` tokens under ``par``, in words."""
    u, sp = cfg.fpdt_chunks, par.sp
    line = (f"layout: {u} chunks of {seq // u} tokens, {seq // u // sp} of each on every model "
            "rank")
    if sp > 1 and any(k in ("rglru", "ssm") for k in cfg.layer_kinds()):
        line += f"; the recurrent scans run in two passes over {u * sp} spans"
    return line


def _train(args, par: Optional[ParallelContext], device: torch.device):
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
    main_rank = par is None or par.rank == 0
    if par is not None:
        u = cfg.fpdt_chunks
        if args.batch % par.dp or args.seq % u or (args.seq // u) % par.sp:
            raise SystemExit(f"--batch {args.batch} must split over {par.dp} data ranks and "
                             f"each of the {u} chunks of --seq {args.seq} over {par.sp} model "
                             "ranks")
        if main_rank:
            print(f"mesh {par.dp} data x {par.sp} model ({par.mesh.backend}), attention kind "
                  f"{T.attn_kind(cfg, par) if T.has_attention(cfg) else 'none'}, on {name}; "
                  f"{_layout(cfg, par, args.seq)}", flush=True)

    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(args.seed), device,
                           par)
    oc = opt_config(cfg, args.lr, args.steps)
    opt_state = adamw.init(oc, params)
    tc = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every, log_every=args.log_every,
                     grad_accum=args.grad_accum, compress_grads=args.compress_grads)
    bf = make_batch_fn(cfg, ShapeConfig("cli", args.seq, args.batch, "train"))
    mgr = CheckpointManager(args.ckpt_dir, cfg=cfg, par=par) if args.ckpt_dir else None
    start = 0
    if mgr and args.resume:
        step = mgr.latest_step() if args.resume == "auto" else int(args.resume)
        if step is not None:
            restored, _ = mgr.restore(step, {"params": params, "opt": opt_state})
            params, opt_state, start = restored["params"], restored["opt"], step
            if main_rank:
                print(f"[resume] restored step {step}", flush=True)
    run = train_steps(cfg, params, oc, tc, bf, device, par=par, opt_state=opt_state, ckpt=mgr,
                      start_step=start)
    tokens = args.batch * args.seq
    where = name if par is None else f"{name}, {par.dp * par.sp} ranks"
    for rec in run.history if main_rank else ():
        aux = f" aux {rec['aux']:.4f}" if "aux" in rec else ""
        print(f"step {rec['step']}: loss {rec['loss']:.4f}{aux} grad_norm {rec['grad_norm']:.4f} "
              f"{rec['dt'] * 1e3:.1f} ms ({tokens / rec['dt']:.1f} tokens/s) on {where}")
    if main_rank and (args.trace_out or args.metrics_out):
        _write_telemetry(args, run.telemetry, where)
    return run.history


def _write_telemetry(args, telemetry: TM.Telemetry, where: str) -> None:
    """``--trace-out`` / ``--metrics-out``, and the JAX CLI's three lines."""
    if args.trace_out:
        doc = TM.write_chrome_trace(args.trace_out, telemetry)
        print(f"[telemetry] wrote {len(doc['traceEvents'])} trace events to {args.trace_out}")
    if args.metrics_out:
        TM.write_prometheus(args.metrics_out, telemetry)
        print(f"[telemetry] wrote metrics registry to {args.metrics_out}")
    h = telemetry.registry.histogram("train_step_ms").summary()
    print(f"[telemetry] train_step_ms: p50 {h['p50']:.1f} p95 {h['p95']:.1f} mean "
          f"{h['mean']:.1f} over {h['count']} steps on {where}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
