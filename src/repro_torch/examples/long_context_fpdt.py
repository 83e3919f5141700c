"""FPDT long-context demo: sequence-chunked, host-offloaded attention on a
(2 data x 4 model) mesh of ranks (the JAX package's
``examples/long_context_fpdt.py``, whose 8 devices are faked CPU devices;
here they are ranks, gloo on the CPU).

Takes the loss and gradient of the same batch with (a) plain Ulysses (u=1)
and (b) FPDT at u=--chunks with KV offload, checks that the losses and
gradient sums agree (FPDT is exact, paper Fig. 14) and, on the card,
reports each variant's peak device memory on rank 0.

  PYTHONPATH=src python -m repro_torch.examples.long_context_fpdt [--seq 4096]
  PYTHONPATH=src python -m repro_torch.examples.long_context_fpdt --mesh 1x2 --dist-backend gloo
  PYTHONPATH=src python -m repro_torch.examples.long_context_fpdt --device cpu --seq 256

``--mesh DxM`` (default 2x4, the JAX script's device count) runs D*M
ranks, spawned as the train CLI spawns them (``launch/mesh.py::spawn``);
``--dist-backend`` is nccl on the card and gloo on the CPU unless given
(nccl needs a card a rank; gloo ranks can share one).  Each rank holds its
ZeRO-3 shards of the weights (``init_params(..., par)``) and its part of
the batch; the gradient sum counts each element of the whole gradient
once (the shards gathered after ``reduce_grads``).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced
from repro_torch.core.parallel import ParallelContext
from repro_torch.data.pipeline import shard_batch
from repro_torch.examples import add_device_flag, device_of, seeded, to_device
from repro_torch.launch import mesh as MESH
from repro_torch.launch import shardings as SH
from repro_torch.launch.serve import device_name
from repro_torch.models import transformer as T
from repro_torch.runtime import train_loop as TL
from repro_torch.tree import tree_leaves

LOSS_RTOL, GRAD_RTOL = 1e-4, 1e-3


def base_config():
    return dataclasses.replace(reduced(get_config("llama3.2-1b")), num_layers=4, block_q=256,
                               block_k=256)


def variant_configs(base, chunks: int):
    """{name: config}: Ulysses at u=1, then FPDT at u=chunks with offload."""
    out = {}
    for name, u, off in (("ulysses-baseline", 1, False),
                         (f"fpdt-u{chunks}-offload", chunks, True)):
        out[name] = dataclasses.replace(base, fpdt_chunks=u, fpdt_offload=off,
                                        mlp_chunks=2 * u if u > 1 else 1)
    return out


def draw_batch(cfg, seq: int, device, seed: int = 0):
    """The JAX script's batch: tokens and labels drawn from the same key,
    so the two are equal; numpy, [2, seq] int32."""
    def draw():
        return torch.randint(0, cfg.vocab_size, (2, seq), generator=seeded(device, seed),
                             device=device).to(torch.int32).cpu().numpy()

    return {"tokens": draw(), "labels": draw()}


def run(base, par, params, batch, chunks: int, device):
    """{variant: (loss, sum of |g| over every gradient element, peak device
    bytes or None)} of ``loss_fn`` at ``params`` (this rank's shards under
    ``par``) on ``batch`` (the global numpy batch; each variant takes this
    rank's part of it in its own chunk layout)."""
    results = {}
    for name, cfg in variant_configs(base, chunks).items():
        local = to_device(shard_batch(batch, par, cfg.fpdt_chunks), device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        loss, _, grads = TL.value_and_grad(cfg, par, params, local)
        grads = TL.reduce_grads(cfg, par, grads)
        if par is not None:
            grads = SH.gather_params_tree(cfg, par, grads)
        gsum = sum(float(g.float().abs().sum()) for g in tree_leaves(grads))
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        results[name] = (float(loss), gsum, peak)
        del grads
    return results


def report(results, where: str) -> None:
    for name, (loss, gsum, peak) in results.items():
        mem = (f"peak {peak / 2**20:.0f} MiB (device memory on rank 0)" if peak is not None
               else "peak memory: the card's figure only")
        print(f"{name:24s} loss={loss:.5f} |grad|={gsum:.2f} {mem} on {where}", flush=True)


def check(results) -> None:
    """The JAX script's assertions: loss within 1e-4 and the gradient sum
    within 1e-3, relative."""
    (l0, g0, _), (l1, g1, _) = results.values()
    np.testing.assert_allclose(l0, l1, rtol=LOSS_RTOL)
    np.testing.assert_allclose(g0, g1, rtol=GRAD_RTOL)


def _demo(args, par, device, where: str):
    """Both variants from seed 0's weights (this rank's shards under
    ``par``) on the script's batch; rank 0 reports, every rank checks."""
    base = base_config()
    results = run(base, par, T.init_params(base, seeded(device), device, par),
                  draw_batch(base, args.seq, device), args.chunks, device)
    lead = par is None or par.rank == 0
    if lead:
        report(results, where)
    check(results)
    if lead:
        print("\nFPDT == baseline (loss and grad sum) — pure systems optimization, "
              "as the paper's Fig 14 claims.", flush=True)
    return results


def _rank_main(args):
    """One rank: join the world, build the mesh, run both variants."""
    shape = args.shape
    _, world, local_rank = MESH.init_from_env(args.backend)
    try:
        device = MESH.take_device(args.device, local_rank, world)
        return _demo(args, ParallelContext(MESH.make_mesh(*shape)), device,
                     f"{device_name(device)}, {world} ranks ({shape[0]} data x {shape[1]} "
                     f"model, {dist.get_backend()})")
    finally:
        dist.destroy_process_group()


def parse_args(argv=None):
    """The script's flags; ``shape`` (data, model) and ``backend`` added."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--mesh", default="2x4", help="DxM: D data x M model ranks")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="the ranks' backend (default nccl on the card, gloo on the CPU)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    try:
        args.shape = MESH.parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    args.backend = MESH.default_backend(args.dist_backend, args.device)
    if args.device == "cpu" and args.backend == "nccl":
        ap.error("nccl runs on the card: --device cpu takes --dist-backend gloo")
    return args


def main(argv=None):
    args = parse_args(argv)
    device = device_of(args.device)
    if args.shape == (1, 1):  # one rank, in this process
        return _demo(args, None, device, device_name(device))
    return MESH.run_ranks(args.shape[0] * args.shape[1], args.backend, main,
                          list(argv if argv is not None else sys.argv[1:]),
                          lambda: _rank_main(args))


if __name__ == "__main__":
    main()
