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
to inference, ``models/serve.py``); N must divide the cache length.
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
baseline.  The host-streamed pool (``--paged --host-kv-chunks``), meshes,
replicas, the router and its faults (``--mesh``, ``--replicas``,
``--router``, ``--fault-plan``, ``--retry``, ``--dispatch-timeout``,
``--shared-kv-store``) are not yet ported: the CLI exits 2.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import ModelConfig, get_config, reduced
from repro_torch.models import serve as SV
from repro_torch.models import transformer as T
from repro_torch.runtime import decode_loop as DL
from repro_torch.runtime import paged as PG
from repro_torch.runtime import telemetry as TM

# engine flags of the JAX CLI that this port does not serve yet, with
# their defaults: set to anything else, the CLI exits 2
UNPORTED = {"mesh": "", "replicas": 1, "router": "affine", "fault_plan": "", "retry": 1,
            "dispatch_timeout": 0.0, "shared_kv_store": ""}


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
                stop_tokens=(), paged: Optional[Dict[str, Any]] = None):
    """``ServeEngine``, with ``blocking`` the ``BlockingServeEngine``, or
    with ``paged`` (``PagedServeEngine``'s keywords: ``page_size``,
    ``n_pages``, ``radix``, ``spill_pages``; with ``policy`` and
    ``prefill_budget`` too the ``SLOPagedServeEngine``) a paged one."""
    kw = dict(slots=slots, bucket=bucket, max_new_tokens=gen, segment=segment,
              n_host_chunks=n_host_chunks, sampling=sampling, stop_tokens=stop_tokens)
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


def _export_telemetry(args, telemetries):
    """--trace-out / --metrics-out: dump the run's telemetry to disk."""
    if args.trace_out:
        doc = TM.write_chrome_trace(args.trace_out, telemetries)
        print(f"[telemetry] wrote {len(doc['traceEvents'])} trace events "
              f"to {args.trace_out} (open in Perfetto / chrome://tracing)")
    if args.metrics_out:
        TM.write_prometheus(args.metrics_out, telemetries)
        print(f"[telemetry] wrote metrics registry to {args.metrics_out}")


def _engine_main(args, cfg: ModelConfig, params, device: torch.device, gen: torch.Generator):
    """--engine: the twin of the JAX CLI's non-mesh engine run."""
    name = device_name(device)
    prompts, lens = engine_prompts(cfg, args.requests, args.prompt_len, args.shared_prefix,
                                   args.seed)
    paged = None
    if args.paged:
        spill = args.spill_pages
        if args.kv_store and not spill:
            spill = 4 * args.n_pages if args.n_pages else 64  # the restore's target
        paged = dict(page_size=args.page_size, n_pages=args.n_pages, spill_pages=spill)
        if args.sched:
            paged.update(policy=args.sched, prefill_budget=args.prefill_budget)
            prompts = slo_requests(prompts, lens)
    engine = make_engine(cfg, params, slots=args.batch,
                         bucket=args.prompt_len + args.shared_prefix, gen=args.gen,
                         blocking=args.blocking, segment=args.segment,
                         prefill_chunk=args.prefill_chunk, n_host_chunks=args.host_kv_chunks,
                         sampling=DL.SamplingConfig(temperature=args.temperature,
                                                    top_k=args.top_k),
                         paged=paged)
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
    if args.paged:
        _paged_report(args, engine)
        if args.kv_store:
            n = engine.save_kv_store(args.kv_store)
            print(f"[kv-store] saved {n} prefix pages to {args.kv_store}")
    _export_telemetry(args, engine.telemetry)
    return run


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
    # the JAX CLI's mesh and router flags: parsed, not yet ported
    ap.add_argument("--mesh", default="", help="not yet ported")
    ap.add_argument("--replicas", type=int, default=1, help="not yet ported")
    ap.add_argument("--router", default="affine", choices=["affine", "rr"],
                    help="not yet ported")
    ap.add_argument("--fault-plan", default="", help="not yet ported")
    ap.add_argument("--retry", type=int, default=1, help="not yet ported")
    ap.add_argument("--dispatch-timeout", type=float, default=0.0, help="not yet ported")
    ap.add_argument("--shared-kv-store", default="", help="not yet ported")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default) or, when asked, on the CPU")
    args = ap.parse_args(argv)
    unported = sorted("--" + k.replace("_", "-") for k, v in UNPORTED.items()
                      if getattr(args, k) != v)
    if unported:
        ap.exit(2, f"{', '.join(unported)}: meshes, replicas, the router and its faults "
                   "are not yet ported\n")
    if args.paged and args.host_kv_chunks:
        ap.exit(2, "--paged --host-kv-chunks: the host-streamed page pool is not yet ported "
                   "(ROADMAP Queue A item 2, with serving over a mesh)\n")
    if args.paged and not args.engine:
        ap.error("--paged requires --engine")
    if args.sched and not args.paged:
        ap.error("--sched requires --paged (preemption spills KV pages)")
    if (args.trace_out or args.metrics_out) and not args.engine:
        ap.error("--trace-out/--metrics-out export engine telemetry; they require --engine")
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
    device = torch.device(args.device)
    name = device_name(device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, remat="none")
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
