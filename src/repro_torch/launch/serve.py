"""Serving CLI: batched FPDT prefill + multi-token decode, or continuous
batching, on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --batch 4 --prompt-len 64 --gen 32 [--temperature 0.8 --top-k 40] \
      [--per-token] [--host-kv-chunks 8] [--reduced] [--device cuda|cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --engine [--blocking] --requests 8 --batch 4 --prompt-len 64 --gen 16 \
      [--segment 8] [--prefill-chunk 64] [--shared-prefix 16] \
      [--host-kv-chunks 4] [--trace-out t.json] [--metrics-out m.prom]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --engine --paged [--page-size 16] [--n-pages 0] [--spill-pages 64] \
      [--kv-store kv.npz] [--sched slo|fifo] [--prefill-budget 2] ...
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --engine [--paged] --mesh 1x2 [--replicas 2] [--router affine|rr] \
      [--fault-plan "1:raise@0"] [--retry 1] [--dispatch-timeout 0] \
      [--shared-kv-store DIR] [--dist-backend nccl|gloo] [--layers N] ...

The same flags as the JAX package's serve CLI.  Weights and prompts are
random, from ``--seed``; an audio model's prompt is ``--prompt-len`` frame
embeddings and its decode steps feed fresh random frames (a per-token
loop), a vision model's prompt is its ``num_patches`` patch embeddings and
``--prompt-len`` minus those in tokens.  The run is on the card unless
``--device cpu`` asks for the CPU; with no card it stops instead of
falling back.  Every time it prints names the device it was taken on.
Every registered arch serves.

``--host-kv-chunks N`` keeps the full-attention KV cache in pinned host
memory and streams it through decode in N slabs (FPDT's pipeline applied
to inference, ``models/serve.py``); N must divide the cache length.  With
``--paged`` the page pool is parked there and streams its live pages; with
``--mesh`` each rank parks its own shard.  An engine run prints the bytes
parked and the slabs merged or pages fetched.
``--engine`` serves ``--requests`` prompts of ``--prompt-len // 4`` to
``--prompt-len`` tokens (``numpy.random.default_rng(seed)``, as the JAX
CLI draws them, after a ``--shared-prefix`` common to all) over
``--batch`` slots through the fused mixed-step scheduler
(``runtime/decode_loop.ServeEngine``: ``--prefill-chunk`` prompt tokens
stream into a refilling slot a step while the others decode, ``--segment``
steps a dispatch), or with ``--blocking`` the stop-the-world baseline
(``BlockingServeEngine``), and prints the dispatch times (steady p50,
refill-active p95).  ``--trace-out`` / ``--metrics-out`` write the
engine's telemetry (a Chrome trace with the ``request.*`` events;
Prometheus text).

``--paged`` serves through the slot-shared paged pool with radix prefix
reuse (``runtime/paged.PagedServeEngine``): ``--page-size`` tokens a
page, ``--n-pages`` physical pages (0: the dense engine's capacity),
``--shared-prefix`` for radix hits; the run prints prefix hits and page
occupancy.  ``--spill-pages N`` adds the host spill tier, and
``--kv-store PATH`` restores the prefix cache from PATH at start when the
file exists and saves it after the run (with no ``--spill-pages``, a tier
of 4 x ``--n-pages`` pages, or 64).  ``--sched slo`` (with ``--paged``)
serves through ``SLOPagedServeEngine``: the prompts no longer than the
median are the priority-0 interactive tier, arriving one a step, the
others best-effort; ``--prefill-budget N`` pauses a prefill after N
chunks while others decode; ``--sched fifo`` is the arrival-order
baseline.

``--mesh DxM`` (with ``--engine``) serves each engine sharded over D data
x M model ranks (``models/serve.py::cache_shardings``: kv heads, else
positions, over model; slots over data) and ``--replicas N`` runs N such
engines behind the session-affine router (``launch/router.py``; ``--router
rr`` is the round-robin baseline), even at N = 1, as the JAX CLI does.
``--fault-plan`` injects deterministic faults (``launch/faults.py``),
``--retry`` and ``--dispatch-timeout`` tune the router's retries and its
stall deadline (read on rank 0's clock alone), and ``--shared-kv-store
DIR`` gives the replicas a shared prefix-cache directory
(``launch/kvstore.py``) from which a dead replica's pages restore into
the survivors.  At ``--mesh 1x1`` every replica is an engine in this
process, replica r on cuda:(r % cards).  Otherwise the CLI runs N x D x M
ranks (spawned through a ``file://`` store, or the ``torchrun`` world it
finds; ``--dist-backend`` nccl needs a card a rank, gloo shares one):
replica r owns ranks [r D M, (r + 1) D M), every rank holds the whole
weight tree, and world rank 0 runs the router over proxies that hand
each command (generate, save_kv_store, restore_kv_store, stop) to their
replica's ranks; the replica's first rank answers, and at stop hands over
its telemetry.  The run prints each replica's requests and prefix hits,
the spills, the failover line, and the tokens' digest.  ``--layers N``
cuts the model to N layers (0: the config's).  Every arch serves on a
mesh (the recurrent states over channels, ``Shard.channels``), with
``--host-kv-chunks`` too.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ModelConfig, get_config, reduced
from repro_torch.launch import mesh as MESH
from repro_torch.models import serve as SV
from repro_torch.models import transformer as T
from repro_torch.runtime import decode_loop as DL
from repro_torch.runtime import paged as PG
from repro_torch.runtime import telemetry as TM

def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(cfg: ModelConfig, params, prompt: Dict[str, torch.Tensor], *, gen: int,
                sampling: DL.SamplingConfig = DL.GREEDY,
                generator: Optional[torch.Generator] = None, per_token: bool = False,
                frames: Optional[torch.Tensor] = None, n_host_chunks: int = 0
                ) -> Dict[str, Any]:
    """Prefill the prompt batch (``models/serve.py::prefill_step``'s:
    {"tokens" [b, s]}, {"frame_embeds" [b, s, d]} or {"patch_embeds" [b,
    P, d], "tokens" [b, s - P]}) and generate ``gen`` tokens per row (the
    first from the prefill logits), timing both phases on the host clock
    around work that ends in a device synchronise.  Decode runs
    ``decode_loop.decode_tokens`` or, with ``per_token`` and always for the
    audio frontend, a loop over ``decode_step`` that samples each token on
    the way; an audio model's step t feeds ``frames[:, t]`` ([b, gen - 1,
    d], the caller's), as the JAX CLI feeds fresh random frames.  With
    ``n_host_chunks`` the prefilled cache's full-attention KV moves to
    pinned host memory (``SV.offload_kv``, before the decode timer starts)
    and decode streams it in that many slabs.

    Returns {"tokens" [b, gen], "prefill_logits" [b, padded_vocab],
    "prefill_ms", "decode_ms", "steps", "mode"}."""
    device = next(iter(prompt.values())).device
    audio = cfg.frontend == "audio_frames"
    b = next(iter(prompt.values())).shape[0]
    s = sum(v.shape[1] for v in prompt.values())  # positions: patches + tokens
    steps = gen - 1
    if audio and (frames is None or tuple(frames.shape[:2]) != (b, steps)):
        raise ValueError(f"the audio frontend decodes frame embeddings: frames [{b}, {steps}, "
                         f"d] are needed")
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = SV.prefill_step(cfg, None, params, prompt, max_len=s + gen)
    _sync(device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok0 = DL.sample_token(logits[:, : cfg.vocab_size], generator, sampling)
    if n_host_chunks:
        SV.offload_kv(cfg, cache, device)
        _sync(device)
    t0 = time.perf_counter()
    if per_token or audio:
        outs = [tok0[:, None]]
        for i in range(steps):
            inp = {"frame_embeds": frames[:, i:i + 1]} if audio else {"tokens": outs[-1]}
            lg, cache = SV.decode_step(cfg, None, params, cache, inp, s + i,
                                       n_host_chunks=n_host_chunks,
                                       bounds=[(s + i, s + i)] * b)
            outs.append(DL.sample_token(lg[:, : cfg.vocab_size], generator, sampling)[:, None])
        toks, mode = torch.cat(outs, dim=1), "per-token loop"
    else:
        # the positions as a host int: host-streamed KV bounds each step by them
        toks, _ = DL.decode_tokens(cfg, None, params, cache, tok0[:, None], s,
                                   num_steps=steps, n_host_chunks=n_host_chunks,
                                   sampling=sampling, generator=generator)
        toks, mode = torch.cat([tok0[:, None], toks], dim=1), "loop"
    _sync(device)
    decode_ms = (time.perf_counter() - t0) * 1e3
    return {"tokens": toks, "prefill_logits": logits, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms, "steps": steps, "mode": mode}


def random_prompt(cfg: ModelConfig, b: int, prompt_len: int, gen: torch.Generator, device
                  ) -> Dict[str, torch.Tensor]:
    """A random prompt batch of ``prompt_len`` positions from ``gen``, as
    the JAX CLI builds it: tokens; or standard normal frame embeddings in
    the parameter dtype; or standard normal patch embeddings followed by
    ``prompt_len - num_patches`` tokens."""
    dtype = getattr(torch, cfg.param_dtype)

    def normal(n):
        return torch.randn((b, n, cfg.d_model), generator=gen, device=device).to(dtype)

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (b, n), generator=gen, device=device)

    if cfg.frontend == "audio_frames":
        return {"frame_embeds": normal(prompt_len)}
    if cfg.frontend == "vision_patches":
        return {"patch_embeds": normal(cfg.num_patches),
                "tokens": tokens(prompt_len - cfg.num_patches)}
    return {"tokens": tokens(prompt_len)}


def engine_prompts(cfg: ModelConfig, requests: int, prompt_len: int, shared_prefix: int = 0,
                   seed: int = 0):
    """The engine's workload as the JAX CLI draws it: a shared prefix of
    ``shared_prefix`` tokens, then per request ``prompt_len // 4`` to
    ``prompt_len`` tokens (``numpy.random.default_rng(seed)``).  Returns
    (prompts, lengths without the prefix)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, size=shared_prefix).tolist()
    lens = rng.integers(max(1, prompt_len // 4), prompt_len + 1, size=requests)
    return [shared + rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lens], lens


def dispatch_summary(steps) -> Optional[Dict[str, float]]:
    """Steady p50 and refill-active p50 and p95 dispatch ms of an engine's
    step records, as the JAX CLI reads them (the first dispatch dropped),
    or None when either kind is missing."""
    steps = list(steps)[1:]
    refill = [st["ms"] for st in steps if st["prefilling"]]
    steady = [st["ms"] for st in steps if not st["prefilling"]]
    if not (refill and steady):
        return None
    return {"steady_p50_ms": float(np.percentile(steady, 50)),
            "refill_p50_ms": float(np.percentile(refill, 50)),
            "refill_p95_ms": float(np.percentile(refill, 95)),
            "refill_dispatches": len(refill), "dispatches": len(steps)}


def engine_name(engine) -> str:
    """The engine's label in the CLI's prints, as the JAX CLI's."""
    if isinstance(engine, PG.SLOPagedServeEngine):
        return (f"SLO scheduler (policy={engine.policy}, page_size={engine.page_size}, "
                f"prefill_budget={engine.prefill_budget})")
    if isinstance(engine, PG.PagedServeEngine):
        spill = engine.kv.spill
        return (f"paged pool (page_size={engine.page_size}, n_pages={engine.n_pages}, "
                f"prefill_chunk={engine.cp}"
                + (f", spill_pages={spill.n_spill}" if spill is not None else "") + ")")
    if isinstance(engine, DL.BlockingServeEngine):
        return "blocking baseline"
    return f"fused scheduler (prefill_chunk={engine.cp})"


def make_engine(cfg: ModelConfig, params, *, slots: int, bucket: int, gen: int,
                blocking: bool = False, segment: int = 8, prefill_chunk: int = 0,
                n_host_chunks: int = 0, sampling: DL.SamplingConfig = DL.GREEDY,
                stop_tokens=(), paged: Optional[Dict[str, Any]] = None, par=None):
    """``ServeEngine``, with ``blocking`` the ``BlockingServeEngine``, or
    with ``paged`` (``PagedServeEngine``'s keywords: ``page_size``,
    ``n_pages``, ``radix``, ``spill_pages``; with ``policy`` and
    ``prefill_budget`` too the ``SLOPagedServeEngine``) a paged one;
    sharded over ``par``'s mesh when it is given."""
    kw = dict(slots=slots, bucket=bucket, max_new_tokens=gen, segment=segment,
              n_host_chunks=n_host_chunks, sampling=sampling, stop_tokens=stop_tokens,
              par=par)
    if paged is not None:
        cls = PG.SLOPagedServeEngine if "policy" in paged else PG.PagedServeEngine
        return cls(cfg, params, prefill_chunk=prefill_chunk, **paged, **kw)
    if blocking:
        return DL.BlockingServeEngine(cfg, params, **kw)
    return DL.ServeEngine(cfg, params, prefill_chunk=prefill_chunk, **kw)


def run_engine(cfg: ModelConfig, params, prompts, *, engine=None,
               generator: Optional[torch.Generator] = None, **kw) -> Dict[str, Any]:
    """Serve ``prompts`` (token lists or ``Request``s) through ``engine``,
    or a new one from ``make_engine(cfg, params, **kw)``, timed on the host
    clock around a run that ends in a device synchronise.  Returns
    {"outs", "engine", "name", "ms", "summary" (``dispatch_summary``)}."""
    engine = make_engine(cfg, params, **kw) if engine is None else engine
    device = engine.device
    _sync(device)
    t0 = time.perf_counter()
    outs = engine.generate(prompts, generator=generator)
    _sync(device)
    return {"outs": outs, "engine": engine, "name": engine_name(engine),
            "ms": (time.perf_counter() - t0) * 1e3,
            "summary": dispatch_summary(engine.last_stats["steps"])}


def slo_requests(prompts, lens):
    """The JAX CLI's QoS tiers for ``--sched``: the prompts no longer than
    the median are priority 0 (interactive, an ITL deadline of 8 steps),
    the rest priority 1 (batch); request i arrives at step i."""
    med = int(np.median(lens))
    return [DL.Request(tokens=tuple(p), arrival=i, priority=0 if lens[i] <= med else 1,
                       itl_slo=8.0 if lens[i] <= med else float("inf"),
                       tier="interactive" if lens[i] <= med else "batch")
            for i, p in enumerate(prompts)]


def _paged_report(args, engine):
    """The paged pool's, the spill tier's and the scheduler's figures after a
    run, as the JAX CLI prints them."""
    st = engine.last_stats
    hit = st["prefix_hit_tokens"] / max(st["prompt_tokens"], 1)
    print(f"  paged pool: prefix hits {st['prefix_hit_tokens']}/{st['prompt_tokens']} prompt "
          f"tokens ({hit:.0%}), {st['prefilled_tokens']} prefilled, {st['cow_copies']} COW "
          f"copies, peak occupancy {st['pages_peak']}/{engine.n_pages} pages "
          f"({st['radix_pages']} retained in the radix tree)")
    if st.get("spill_pages"):
        print(f"  spill tier: {st['spilled_pages']}/{st['spill_pages']} host pages held, "
              f"{st['spill_promotes']} promoted back on-device this run")
    if args.sched:
        pre = [r for r in st["requests"] if r["preemptions"]]
        print(f"  scheduler [{st['policy']}]: {st['preemptions']} preemptions "
              f"({len(pre)} requests), {st['prefill_pauses']} prefill pauses, "
              f"{st['deferrals']} deferrals")
        if args.trace_out:  # a line a request, from the trace alone
            summ = engine.telemetry.request_summaries()
            for r in sorted(summ):
                s = summ[r]
                print(f"  req {r}: ttft {s['ttft']} steps, itl p50/p95 {s['itl_p50']}/"
                      f"{s['itl_p95']}, queue wait {s['queue_wait']}, {s['n_emitted']} "
                      f"tokens, {s['preemptions']} preemptions, {s['prefix_hit_tokens']} "
                      f"prefix-hit")


def _host_kv_words(st, paged: bool) -> str:
    """The engine's host-streamed KV figures (``--host-kv-chunks``)."""
    if st.get("pool_on_device"):
        return ("host KV: the pool stays in device memory (no pool dim divides the mesh), "
                f"{st['host_kv_bytes']} B parked on the host")
    moved = (f"{st['host_kv_pages']} pages fetched" if paged else
             f"{st['host_kv_slabs']} slabs merged")
    return f"host KV: {st['host_kv_bytes']} B parked on the host, {moved}"


def _export_telemetry(args, telemetries):
    """--trace-out / --metrics-out: dump the run's telemetry to disk."""
    if args.trace_out:
        doc = TM.write_chrome_trace(args.trace_out, telemetries)
        print(f"[telemetry] wrote {len(doc['traceEvents'])} trace events "
              f"to {args.trace_out} (open in Perfetto / chrome://tracing)")
    if args.metrics_out:
        TM.write_prometheus(args.metrics_out, telemetries)
        print(f"[telemetry] wrote metrics registry to {args.metrics_out}")


def _engine_kw(args, store: str) -> Dict[str, Any]:
    """``make_engine``'s keywords from the flags, as the JAX CLI builds its
    engines.  With ``store`` (a prefix store the engine restores) and no
    ``--spill-pages``, a paged engine gets a spill tier of 4 x
    ``--n-pages`` pages, or 64, for the restore to land in."""
    paged = None
    if args.paged:
        spill = args.spill_pages
        if store and not spill:
            spill = 4 * args.n_pages if args.n_pages else 64
        paged = dict(page_size=args.page_size, n_pages=args.n_pages, spill_pages=spill)
        if args.sched:
            paged.update(policy=args.sched, prefill_budget=args.prefill_budget)
    return dict(slots=args.batch, bucket=args.prompt_len + args.shared_prefix, gen=args.gen,
                blocking=args.blocking, segment=args.segment, prefill_chunk=args.prefill_chunk,
                n_host_chunks=args.host_kv_chunks,
                sampling=DL.SamplingConfig(temperature=args.temperature, top_k=args.top_k),
                paged=paged)


def _engine_main(args, cfg: ModelConfig, params, device: torch.device, gen: torch.Generator):
    """--engine: the twin of the JAX CLI's non-mesh engine run."""
    name = device_name(device)
    prompts, lens = engine_prompts(cfg, args.requests, args.prompt_len, args.shared_prefix,
                                   args.seed)
    if args.sched:
        prompts = slo_requests(prompts, lens)
    engine = make_engine(cfg, params, **_engine_kw(args, args.kv_store))
    if args.kv_store and os.path.exists(args.kv_store):
        n = engine.restore_kv_store(args.kv_store)
        print(f"[kv-store] restored {n} prefix pages from {args.kv_store}")
    run = run_engine(cfg, params, prompts, engine=engine, generator=gen)
    total = sum(len(o) for o in run["outs"])
    dt = run["ms"] / 1e3
    shared = f" +{args.shared_prefix} shared" if args.shared_prefix else ""
    print(f"[{run['name']}] {args.requests} requests (prompt {lens.min()}-{lens.max()}{shared}) "
          f"over {args.batch} slots: {total} tokens in {run['ms']:.0f} ms "
          f"({total / max(dt, 1e-9):.1f} tok/s) on {name}")
    sm = run["summary"]
    if sm:
        print(f"  dispatch wall-clock: steady p50 {sm['steady_p50_ms']:.2f} ms, refill-active "
              f"p95 {sm['refill_p95_ms']:.2f} ms ({sm['refill_dispatches']}/"
              f"{sm['dispatches']} dispatches overlapped a refill) on {name}")
    if args.host_kv_chunks and not args.blocking:
        print("  " + _host_kv_words(engine.last_stats, args.paged))
    if args.paged:
        _paged_report(args, engine)
        if args.kv_store:
            n = engine.save_kv_store(args.kv_store)
            print(f"[kv-store] saved {n} prefix pages to {args.kv_store}")
    _export_telemetry(args, engine.telemetry)
    return run


# ---------------------------------------------------------------------------
# replicas over a mesh behind the router (the JAX CLI's _mesh_engine_main)
# ---------------------------------------------------------------------------


class MeshReplica:
    """One replica's engine on this rank, the router's seat for it (the
    JAX CLI's ``_MeshReplica``): every dispatch draws from the replica's
    own generator (seeded alike on each of its ranks, so sampling agrees),
    and the stats and the prefix store pass through."""

    def __init__(self, engine, generator: Optional[torch.Generator] = None):
        self.engine, self.generator = engine, generator

    def generate(self, prompts):
        return self.engine.generate(prompts, generator=self.generator)

    def save_kv_store(self, path):
        return self.engine.save_kv_store(path)

    def restore_kv_store(self, path):
        return self.engine.restore_kv_store(path)

    @property
    def last_stats(self):
        return self.engine.last_stats

    @property
    def telemetry(self):
        return self.engine.telemetry


def _answer(rep: MeshReplica, cmd: str, args):
    """What a replica's ranks do for one command (every rank of it runs
    the collectives; its first rank's answer is the replica's)."""
    if cmd == "generate":
        outs = rep.generate(*args)
        return outs, {k: v for k, v in rep.last_stats.items() if isinstance(v, (int, float))}
    if cmd == "save_kv_store":
        return rep.save_kv_store(*args)
    if cmd == "restore_kv_store":
        return rep.restore_kv_store(*args)
    if cmd == "stop":
        return rep.telemetry
    raise ValueError(f"unknown replica command {cmd!r}")


class RankProxy:
    """World rank 0's seat for a replica of a multi-rank run: a call
    broadcasts its command over the control group (rank 0 and the
    replica's ranks) and the replica's first rank broadcasts the answer
    back.  ``local`` is rank 0's own ``MeshReplica`` when rank 0 is that
    first rank (replica 0)."""

    def __init__(self, group, first: int, local: Optional[MeshReplica] = None):
        self.group, self.first, self.local = group, first, local
        self.last_stats: Dict[str, Any] = {}
        self.telemetry = None

    def _call(self, cmd: str, *args):
        dist.broadcast_object_list([(cmd, args)], src=0, group=self.group)
        ans = [_answer(self.local, cmd, args) if self.local is not None else None]
        dist.broadcast_object_list(ans, src=self.first, group=self.group)
        return ans[0]

    def generate(self, prompts):
        outs, self.last_stats = self._call("generate", list(prompts))
        return outs

    def save_kv_store(self, path):
        return self._call("save_kv_store", path)

    def restore_kv_store(self, path):
        return self._call("restore_kv_store", path)

    def stop(self):
        self.telemetry = self._call("stop")


def _serve_commands(rep: MeshReplica, group, first: int) -> None:
    """A replica rank's loop (every rank but world rank 0): run each
    command rank 0 broadcasts, the first rank answering, until stop."""
    rank = dist.get_rank()
    while True:
        msg = [None]
        dist.broadcast_object_list(msg, src=0, group=group)
        cmd, args = msg[0]
        ans = _answer(rep, cmd, args)
        dist.broadcast_object_list([ans if rank == first else None], src=first, group=group)
        if cmd == "stop":
            return


def _serve_cfg(args) -> ModelConfig:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    over = {"remat": "none"}
    if args.layers:
        over["num_layers"] = args.layers
    return dataclasses.replace(cfg, **over)


def _replica(args, cfg: ModelConfig, device: torch.device, par=None) -> MeshReplica:
    """One replica's engine on ``device`` (on ``par``'s mesh): weights from
    ``--seed``, whose generator then draws the samples."""
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init_params(cfg, gen, device)
    return MeshReplica(make_engine(cfg, params, par=par,
                                   **_engine_kw(args, args.shared_kv_store)), gen)


def route(replicas: List[Any], prompts, sessions=None, *, policy: str = "affine",
          fault_plan: str = "", retry: int = 1, dispatch_timeout: float = 0.0,
          shared_kv_store: str = ""):
    """The router over ``replicas`` (engines or proxies, fault-wrapped by
    ``fault_plan``, with a shared prefix store when ``shared_kv_store``
    names one) serves ``prompts`` (with ``sessions``, their affinity keys).
    Returns (router, outputs, the store or None, host-clock seconds)."""
    from repro_torch.launch.faults import FaultyReplica, parse_fault_plan
    from repro_torch.launch.kvstore import SharedKVStore
    from repro_torch.launch.router import ReplicaRouter

    plan = parse_fault_plan(fault_plan) if fault_plan else {}
    seats = [FaultyReplica(rep, plan[r], name=f"replica{r}") if r in plan else rep
             for r, rep in enumerate(replicas)]
    kv_store = SharedKVStore(shared_kv_store) if shared_kv_store else None
    router = ReplicaRouter(seats, policy=policy, max_retries=retry,
                           dispatch_timeout=dispatch_timeout or None, kv_store=kv_store)
    t0 = time.perf_counter()
    outs = router.generate(prompts, sessions)
    return router, outs, kv_store, time.perf_counter() - t0


def _route(args, cfg: ModelConfig, replicas: List[Any], name: str, mesh):
    """Rank 0's part of a mesh run: ``route`` serves the CLI's workload and
    the run's figures print as the JAX CLI prints them."""
    data, model = mesh
    n = args.replicas
    prompts, _ = engine_prompts(cfg, args.requests, args.prompt_len, args.shared_prefix,
                                args.seed)
    router, outs, kv_store, dt = route(
        replicas, prompts, policy=args.router, fault_plan=args.fault_plan, retry=args.retry,
        dispatch_timeout=args.dispatch_timeout, shared_kv_store=args.shared_kv_store)
    total = sum(len(o) for o in outs)
    st = router.last_stats
    print(f"[{n} x ({data} data x {model} model) mesh replicas, router={args.router}] "
          f"{len(prompts)} requests: {total} tokens in {dt * 1e3:.0f} ms "
          f"({total / max(dt, 1e-9):.1f} tok/s) on {name}")
    for rs in st["per_replica"]:
        line = f"  replica {rs['replica']}: {rs['requests']} requests"
        if "prompt_tokens" in rs:
            hit = rs.get("prefix_hit_tokens", 0)
            line += (f", {rs['prompt_tokens']} prompt tokens"
                     + (f", {hit} prefix-hit" if args.paged else ""))
        eng = getattr(replicas[rs["replica"]], "last_stats", None) or {}
        if "host_kv_bytes" in eng:  # its last dispatch's, on its first rank
            line += "; " + _host_kv_words(eng, args.paged)
        print(line)
    if args.router == "affine" and st["spilled"]:
        print(f"  {st['spilled']} requests spilled off their home replica")
    fo = st.get("failover")
    if fo and (fo["deaths"] or fo["retries"] or fo["timeouts"]):
        print(f"  failover: {fo['deaths']} deaths (dead={fo['dead']}), {fo['retries']} "
              f"retries, {fo['timeouts']} timeouts, {fo['rehomed_requests']} requests "
              f"re-homed ({fo['rehomed_sessions']} sessions), "
              f"{fo['recovered_prefix_tokens']} prefix tokens recovered via the shared store "
              f"({fo['recovered_pages']} pages restored), {fo['live']}/{n} replicas live")
    elif fo:
        print(f"  failover: clean run, {fo['live']}/{n} replicas live")
    digest = hashlib.sha256(json.dumps(outs).encode()).hexdigest()[:16]
    print(f"  tokens sha256 {digest}; first request's: {outs[0]}")
    return router, outs, kv_store


def _export_mesh_telemetry(args, router, telemetries, kv_store):
    """The router's telemetry, every replica's (labelled ``replica=r``)
    and the store's, as the JAX CLI writes them."""
    if not (args.trace_out or args.metrics_out):
        return
    tels = [router.telemetry]
    for r, tel in enumerate(telemetries):
        tel.replica = r
        tels.append(tel)
    if kv_store is not None:
        tels.append(kv_store.telemetry)
    _export_telemetry(args, tels)


def _mesh_engine_main(args, argv, mesh):
    """--mesh: sharded engine replicas behind the router; ``mesh`` is
    (data, model)."""
    per, n = mesh[0] * mesh[1], args.replicas
    if args.fault_plan:
        from repro_torch.launch.faults import parse_fault_plan

        bad = [r for r in parse_fault_plan(args.fault_plan) if r >= n]
        if bad:
            raise SystemExit(f"--fault-plan names replicas {bad} but only {n} exist")
    if args.shared_kv_store and not args.paged:
        raise SystemExit("--shared-kv-store needs --paged (the prefix cache lives in the "
                         "radix tree)")
    cfg = _serve_cfg(args)
    if per == 1:  # every replica an engine in this process
        devices = MESH.replica_devices(args.device, n)
        reps = [_replica(args, cfg, d) for d in devices]
        router, outs, store = _route(args, cfg, reps, device_name(devices[0]), mesh)
        _export_mesh_telemetry(args, router, [rep.telemetry for rep in reps], store)
        return outs
    backend = MESH.default_backend(args.dist_backend, args.device)
    return MESH.run_ranks(n * per, backend, main, argv,
                          lambda: _mesh_rank(args, cfg, mesh, backend))


def serve_ranks(mesh, replicas: int, backend: str, device_kind: str, make_replica, lead):
    """One rank of a multi-rank mesh run: join the world, build every
    replica's (data, model) ``mesh`` and the control groups and this rank's
    replica (``make_replica(device, par)``, a ``MeshReplica``); then world
    rank 0 returns ``lead(proxies, device)`` (``lead`` routes over the
    replicas' ``RankProxy`` seats and stops each at the end) and every other
    rank serves its replica's commands until stop, returning None."""
    data, model = mesh
    per, n = data * model, replicas
    rank, world, local_rank = MESH.init_from_env(backend)
    try:
        device = MESH.take_device(device_kind, local_rank, world)
        par = MESH.serve_mesh(data, model, replicas=n)
        ctl = [dist.new_group(sorted({0, *range(r * per, (r + 1) * per)})) for r in range(n)]
        rep = make_replica(device, par)
        me = rank // per
        if rank != 0:
            _serve_commands(rep, ctl[me], me * per)
            return None
        return lead([RankProxy(ctl[r], r * per, rep if r == 0 else None) for r in range(n)],
                    device)
    finally:
        dist.destroy_process_group()


def _mesh_rank(args, cfg: ModelConfig, mesh, backend: str):
    """One rank of the CLI's multi-rank mesh run (``serve_ranks``)."""
    def lead(proxies, device):
        router, outs, store = _route(args, cfg, proxies, device_name(device), mesh)
        for px in proxies:
            px.stop()
        _export_mesh_telemetry(args, router, [px.telemetry for px in proxies], store)
        return outs

    return serve_ranks(mesh, args.replicas, backend, args.device,
                       lambda device, par: _replica(args, cfg, device, par), lead)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--host-kv-chunks", type=int, default=0,
                    help="FPDT-for-inference: stream the KV cache from pinned host "
                         "memory in N slabs")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples at this temperature")
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the k best tokens (0 = all)")
    ap.add_argument("--per-token", action="store_true",
                    help="a Python loop over decode_step, sampling each token on the way, "
                         "in place of decode_tokens (always for the audio frontend)")
    ap.add_argument("--engine", action="store_true",
                    help="continuous batching via the fused mixed-step scheduler "
                         "(ServeEngine) instead of one batch")
    ap.add_argument("--blocking", action="store_true",
                    help="with --engine: the stop-the-world refill baseline")
    ap.add_argument("--requests", type=int, default=8, help="with --engine: queued prompts")
    ap.add_argument("--segment", type=int, default=8,
                    help="with --engine: mixed steps per dispatch")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="with --engine: prompt tokens streamed into a refilling slot "
                         "per mixed step (0 = auto)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="with --engine: prepend a common system prompt of this many tokens")
    ap.add_argument("--trace-out", default="",
                    help="with --engine: write the run's lifecycle spans as Chrome "
                         "trace-event JSON")
    ap.add_argument("--metrics-out", default="",
                    help="with --engine: write the metrics registry as Prometheus text")
    ap.add_argument("--paged", action="store_true",
                    help="with --engine: the slot-shared paged KV pool with radix prefix "
                         "reuse (PagedServeEngine)")
    ap.add_argument("--page-size", type=int, default=16, help="with --paged: tokens a page")
    ap.add_argument("--n-pages", type=int, default=0,
                    help="with --paged: physical pages in the pool (0 = the dense "
                         "engine's capacity)")
    ap.add_argument("--spill-pages", type=int, default=0,
                    help="with --paged: host spill tier pages (evicted radix pages demote "
                         "there instead of being dropped; 0 = no tier)")
    ap.add_argument("--kv-store", default="",
                    help="with --paged: the prefix cache's file, restored at start when it "
                         "exists and saved after the run (implies a spill tier)")
    ap.add_argument("--sched", default="", choices=["", "fifo", "slo"],
                    help="with --paged: SLO-aware admission (SLOPagedServeEngine); 'slo' "
                         "preempts less urgent slots, 'fifo' is the arrival-order baseline")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="with --sched slo: prefill chunks a request may take before it "
                         "pauses while others decode (0 = unbounded)")
    ap.add_argument("--mesh", default="",
                    help="with --engine: shard each engine over a DxM (data x model) mesh of "
                         "ranks, e.g. 1x2 or 2x2 (host8: 2x4), behind the replica router")
    ap.add_argument("--replicas", type=int, default=1,
                    help="with --mesh: engine replicas, each on its own D*M ranks")
    ap.add_argument("--router", default="affine", choices=["affine", "rr"],
                    help="with --replicas: session-affine dispatch or round-robin")
    ap.add_argument("--fault-plan", default="",
                    help="with --replicas: deterministic faults, ';'-separated "
                         "R:KIND@N[xC][~S] items (KIND raise, transient or hang), e.g. "
                         "'1:raise@2' kills replica 1 on its 3rd dispatch")
    ap.add_argument("--retry", type=int, default=1,
                    help="with --replicas: dispatch retries before a faulting replica is "
                         "declared dead")
    ap.add_argument("--dispatch-timeout", type=float, default=0.0,
                    help="with --replicas: seconds after which a dispatch counts as a fault "
                         "and its late result is discarded (0 = none)")
    ap.add_argument("--shared-kv-store", default="",
                    help="with --replicas and --paged: a shared prefix-cache directory (one "
                         "npz a replica); a dead replica's cache restores into the survivors")
    ap.add_argument("--dist-backend", default="", choices=["", "nccl", "gloo"],
                    help="with --mesh over several ranks: nccl (the card's default; a card a "
                         "rank) or gloo (the CPU's; ranks may share a card)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers (0 = the config's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default) or, when asked, on the CPU")
    args = ap.parse_args(argv)
    if args.mesh and not args.engine:
        ap.error("--mesh requires --engine")
    if args.paged and not args.engine:
        ap.error("--paged requires --engine")
    if (args.trace_out or args.metrics_out) and not args.engine:
        ap.error("--trace-out/--metrics-out export engine telemetry; they require --engine")
    if (args.fault_plan or args.shared_kv_store) and not args.mesh:
        ap.error("--fault-plan/--shared-kv-store act on the replica router; they require "
                 "--mesh (and --replicas > 1 to have anywhere to fail over to)")
    if args.sched and not args.paged:
        ap.error("--sched requires --paged (preemption spills KV pages)")
    if args.sched and args.mesh:
        ap.error("--sched is single-engine for now; route QoS requests to sharded replicas "
                 "via launch/router.py instead")
    if args.mesh:
        try:
            mesh = MESH.parse_mesh(args.mesh)
        except ValueError:
            ap.error(f"--mesh must look like AxB, got {args.mesh!r}")
        if args.replicas < 1:
            ap.error("--mesh sizes and --replicas must be >= 1")
        if args.blocking or args.kv_store:
            ap.error("--blocking and --kv-store are the single engine's; with --mesh the "
                     "replicas run the fused (or --paged) engine and share --shared-kv-store")
    if args.gen < 1 or args.prompt_len < 1 or args.batch < 1:
        ap.error("--batch, --prompt-len and --gen must be >= 1")
    if args.host_kv_chunks < 0:
        ap.error("--host-kv-chunks must be >= 0")
    if (not args.engine and args.host_kv_chunks
            and (args.prompt_len + args.gen) % args.host_kv_chunks):
        ap.error(f"--host-kv-chunks {args.host_kv_chunks} must divide the cache length "
                 f"prompt-len+gen={args.prompt_len + args.gen}")
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.exit(1, "no CUDA device is available; pass --device cpu to run on the CPU\n")
    if args.mesh:
        return _mesh_engine_main(args, list(argv if argv is not None else sys.argv[1:]), mesh)
    device = torch.device(args.device)
    name = device_name(device)

    cfg = _serve_cfg(args)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if cfg.frontend == "vision_patches" and args.prompt_len <= cfg.num_patches:
        ap.error(f"--prompt-len {args.prompt_len} counts the {cfg.num_patches} image patches "
                 "and the tokens after them: it must exceed the patches")
    params = T.init_params(cfg, gen, device)
    if args.engine:
        return _engine_main(args, cfg, params, device, gen)
    prompt = random_prompt(cfg, args.batch, args.prompt_len, gen, device)
    frames = None
    if cfg.frontend == "audio_frames":  # the decode steps' frames, fresh random ones
        frames = random_prompt(cfg, args.batch, args.gen - 1, gen, device)["frame_embeds"]
    sampling = DL.SamplingConfig(temperature=args.temperature, top_k=args.top_k)
    SV.reset_host_kv()
    out = serve_batch(cfg, params, prompt, gen=args.gen, sampling=sampling, generator=gen,
                      per_token=args.per_token, frames=frames,
                      n_host_chunks=args.host_kv_chunks)
    b, steps = args.batch, out["steps"]
    print(f"prefill {args.prompt_len} tokens x {b} seqs: {out['prefill_ms']:.1f} ms on {name}")
    dt = out["decode_ms"] / 1e3
    print(f"decode [{out['mode']}] {steps} steps x {b} seqs: {out['decode_ms']:.1f} ms "
          f"({out['decode_ms'] / max(1, steps):.2f} ms/step, "
          f"{steps * b / max(dt, 1e-9):.1f} tok/s) on {name}")
    if args.host_kv_chunks:
        S = args.prompt_len + args.gen
        print(f"host KV: {args.host_kv_chunks} slabs of {S // args.host_kv_chunks} positions a "
              f"layer; merged {SV.host_kv['fetched']}, skipped {SV.host_kv['skipped']} "
              f"(all layers, all steps)")
    print("generated token ids (first seq):", out["tokens"][0].tolist())
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
