"""Continuous-batching serving example: a mixed-length prompt workload run
through the fused mixed-step scheduler (``runtime/decode_loop.ServeEngine``;
the JAX package's ``examples/serve_batched.py``): more prompts than slots,
variable prompt lengths (including prompts LONGER than the bucket: they
just take more prefill chunks), staggered finishes (a random stop token),
chunked prefill streaming into freed slots *while the other slots keep
decoding*, FPDT-style host-streamed KV.

  PYTHONPATH=src python -m repro_torch.examples.serve_batched --slots 4 --requests 10 \\
      [--prefill-chunk 16] [--blocking] [--device cpu]

``--paged`` runs the same workload through the slot-shared paged KV pool
(``runtime/paged.py``); add ``--shared-prefix N`` for the shared-system-
prompt variant: every request starts with the same N tokens, so the radix
tree maps the prefix pages copy-free and only the distinct suffixes are
prefilled (prefix-hit and page-occupancy stats printed):

  PYTHONPATH=src python -m repro_torch.examples.serve_batched --paged \\
      --shared-prefix 128 --page-size 16 --slots 4 --requests 10

``--mesh AxB --replicas N`` shards N paged engines over disjoint (A data,
B model) slices of ranks behind the session-affine router (the serve CLI's
replicas, ``launch/serve.py``: at 1x1 each replica is an engine in this
process, replica r on cuda:(r % cards); otherwise N*A*B ranks are spawned,
``--dist-backend`` nccl needing a card a rank, gloo sharing one): each
"tenant" (one distinct system prompt per replica) keeps hitting the same
replica's radix tree, so the prefix-hit rate survives routing; rerun with
``--router rr`` to watch round-robin shred it:

  PYTHONPATH=src python -m repro_torch.examples.serve_batched --paged --mesh 1x2 \\
      --replicas 2 --shared-prefix 64 --requests 8 [--router rr]

The workload (prompt lengths, prefixes, the stop token, the tenants and
their shuffled order) is drawn from ``numpy.random.default_rng(--seed)``
exactly as the JAX script draws it; the weights are random from seed 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.examples import add_device_flag, device_of, seeded
from repro_torch.launch import mesh as MESH
from repro_torch.launch import serve as SVC
from repro_torch.models import transformer as T
from repro_torch.runtime import decode_loop as DL
from repro_torch.tree import tree_map


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--slots", type=int, default=4, help="concurrent cache rows")
    ap.add_argument("--requests", type=int, default=10, help="queued prompts")
    ap.add_argument("--bucket", type=int, default=48,
                    help="capacity floor for prompt length (longer prompts "
                         "are still legal — they take more chunks)")
    ap.add_argument("--min-prompt", type=int, default=8)
    ap.add_argument("--max-prompt", type=int, default=72,
                    help="longest workload prompt (> bucket exercises "
                         "multi-chunk refill)")
    ap.add_argument("--gen", type=int, default=16, help="max new tokens per request")
    ap.add_argument("--segment", type=int, default=8, help="mixed steps per dispatch")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="prompt tokens consumed per mixed step by a "
                         "refilling slot (0 = auto)")
    ap.add_argument("--host-kv-chunks", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--blocking", action="store_true",
                    help="run the stop-the-world refill baseline engine")
    ap.add_argument("--paged", action="store_true",
                    help="slot-shared paged KV pool with radix prefix reuse")
    ap.add_argument("--page-size", type=int, default=16,
                    help="with --paged: tokens per pool page")
    ap.add_argument("--n-pages", type=int, default=0,
                    help="with --paged: pool pages (0 = dense-equivalent)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="shared system prompt length prepended to every "
                         "request (with --paged: radix prefix hits)")
    ap.add_argument("--mesh", default="",
                    help="shard engines over an AxB (data x model) mesh "
                         "and route a multi-tenant workload (see header)")
    ap.add_argument("--replicas", type=int, default=2,
                    help="with --mesh: engine replicas behind the router")
    ap.add_argument("--router", default="affine", choices=["affine", "rr"])
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="with --mesh over several ranks: nccl (the card's default; a card "
                         "a rank) or gloo (the CPU's; ranks may share a card)")
    ap.add_argument("--seed", type=int, default=0)
    add_device_flag(ap)
    return ap.parse_args(argv)


def serve_config(arch: str):
    return dataclasses.replace(reduced(get_config(arch)), remat="none")


def workload(args, vocab: int, rng):
    """The single-engine workload: variable-length prompts, several per
    slot (the blocking baseline cannot take prompts longer than its
    bucket), optionally all opening with the same system prompt, and a
    "stop token" some sequences will happen to emit (staggered finishes).
    Returns (prompts, lengths without the prefix, stop token)."""
    shared = rng.integers(0, vocab, size=args.shared_prefix).tolist()
    hi = args.bucket if args.blocking else args.max_prompt
    lens = rng.integers(args.min_prompt, hi + 1, size=args.requests)
    prompts = [shared + rng.integers(0, vocab, size=n).tolist() for n in lens]
    stop = int(rng.integers(0, vocab))
    return prompts, lens, stop


def mesh_workload(args, vocab: int, rng):
    """The multi-tenant workload: one distinct system prompt per tenant (=
    per replica, at least two), requests cycling over the tenants, then
    shuffled so round-robin cannot align with the tenant cycle.  Returns
    (prompts, sessions, tenants)."""
    npfx = max(args.shared_prefix, 2 * args.page_size)
    tenants = [rng.integers(0, vocab, size=npfx).tolist() for _ in range(max(2, args.replicas))]
    prompts, sessions = [], []
    for i in range(args.requests):
        t = i % len(tenants)
        n = int(rng.integers(args.min_prompt, args.bucket + 1))
        prompts.append(tenants[t] + rng.integers(0, vocab, size=n).tolist())
        sessions.append(f"tenant-{t}")
    order = rng.permutation(len(prompts))
    return [prompts[i] for i in order], [sessions[i] for i in order], tenants


def run(args, cfg, params, device):
    """One engine over ``workload``'s prompts from ``params``; prints the
    JAX script's report and returns {"outs", "prompts", "stop", "stats",
    "mode", "seconds"}."""
    prompts, lens, stop = workload(args, cfg.vocab_size, np.random.default_rng(args.seed))
    paged = dict(page_size=args.page_size, n_pages=args.n_pages) if args.paged else None
    engine = SVC.make_engine(
        cfg, params, slots=args.slots, bucket=args.bucket + args.shared_prefix, gen=args.gen,
        blocking=args.blocking, segment=args.segment, prefill_chunk=args.prefill_chunk,
        n_host_chunks=args.host_kv_chunks, stop_tokens=(stop,), paged=paged,
        sampling=DL.SamplingConfig(temperature=args.temperature))
    if args.paged:
        mode = f"paged pool (page_size={engine.page_size}, n_pages={engine.n_pages})"
    else:
        mode = "blocking baseline" if args.blocking else "fused scheduler"
    done = SVC.run_engine(cfg, params, prompts, engine=engine,
                          generator=seeded(device, args.seed))
    outs, dt = done["outs"], done["ms"] / 1e3
    total = sum(len(o) for o in outs)
    shared = f" +{args.shared_prefix} shared" if args.shared_prefix else ""
    print(f"[{mode}] {args.requests} requests (prompt {lens.min()}-{lens.max()}{shared} "
          f"tokens) over {args.slots} slots, host-KV chunks={args.host_kv_chunks}: "
          f"{total} tokens in {dt * 1e3:.0f} ms ({total / dt:.1f} tok/s) on "
          f"{SVC.device_name(device)}")
    sm = done["summary"]
    if sm:
        print(f"  dispatches: {sm['dispatches'] + 1} ({sm['refill_dispatches']} overlapped a "
              f"refill); steady p50 {sm['steady_p50_ms']:.2f} ms vs refill-active p95 "
              f"{sm['refill_p95_ms']:.2f} ms")
    st = engine.last_stats
    if args.paged:
        hit = st["prefix_hit_tokens"] / max(st["prompt_tokens"], 1)
        print(f"  prefix reuse: {st['prefix_hit_tokens']}/{st['prompt_tokens']} "
              f"prompt tokens served from shared pages ({hit:.0%} hit rate), "
              f"{st['prefilled_tokens']} prefilled, {st['cow_copies']} COW "
              f"copies, {st['deferrals']} deferrals")
        print(f"  page occupancy: peak {st['pages_peak']}/{engine.n_pages} "
              f"pages (page_size={engine.page_size}); {st['radix_pages']} "
              f"pages retained in the radix tree for future requests")
    for i, (n, o) in enumerate(zip(lens, outs)):
        fin = "stop" if o and o[-1] == stop else "budget"
        print(f"  req{i}: prompt={n + args.shared_prefix:<3d} "
              f"generated={len(o):<3d} [{fin}] {o[:8]}...")
    return {"outs": outs, "prompts": prompts, "stop": stop, "stats": dict(st), "mode": mode,
            "seconds": dt}


def _mesh_report(args, mesh, router, outs, dt, n_tenants, name):
    """The JAX script's lines for a routed run; returns the per-replica stats."""
    data, model = mesh
    per_rep = router.last_stats["per_replica"]
    total = sum(len(o) for o in outs)
    print(f"[{args.replicas} x ({data}x{model}) mesh replicas, "
          f"router={args.router}] {n_tenants} tenants, "
          f"{len(outs)} shuffled requests: {total} tokens, "
          f"{dt * 1e3:.0f} ms on {name}")
    for rs in per_rep:
        pt = rs.get("prompt_tokens", 0)
        hit = rs.get("prefix_hit_tokens", 0)
        print(f"  replica {rs['replica']}: {rs['requests']} reqs, "
              f"{hit}/{pt} prompt tokens prefix-hit ({hit / pt:.0%})"
              if pt else f"  replica {rs['replica']}: idle")
    agg_pt = sum(rs.get("prompt_tokens", 0) for rs in per_rep)
    agg_hit = sum(rs.get("prefix_hit_tokens", 0) for rs in per_rep)
    print(f"  aggregate prefix-hit: {agg_hit}/{agg_pt} "
          f"({agg_hit / max(agg_pt, 1):.0%}) — each tenant's repeats only "
          f"hit a radix tree that already served it; rerun with "
          f"--router {'rr' if args.router == 'affine' else 'affine'} "
          f"to compare")
    return [dict(rs) for rs in per_rep]


def run_mesh(args, cfg, params, device, argv):
    """The multi-tenant workload over ``--replicas`` paged engines, each
    sharded over an A x B mesh, behind the router (``launch/serve.py``'s
    ``MeshReplica``, ``RankProxy`` and ``route``).  Returns {"outs",
    "per_replica", "prompts", "sessions"} (None on a rank other than 0)."""
    try:
        mesh = MESH.parse_mesh(args.mesh)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    prompts, sessions, tenants = mesh_workload(args, cfg.vocab_size,
                                               np.random.default_rng(args.seed))
    npfx = len(tenants[0])
    kw = dict(slots=args.slots, bucket=args.bucket + npfx, gen=args.gen, segment=args.segment,
              prefill_chunk=args.prefill_chunk,
              paged=dict(page_size=args.page_size, n_pages=args.n_pages))

    def replica(dev, par=None):
        return SVC.MeshReplica(SVC.make_engine(cfg, tree_map(lambda x: x.to(dev), params),
                                               par=par, **kw))

    def lead(reps, dev):
        router, outs, _, dt = SVC.route(reps, prompts, sessions, policy=args.router)
        for rep in reps:
            if isinstance(rep, SVC.RankProxy):
                rep.stop()
        per_rep = _mesh_report(args, mesh, router, outs, dt, len(tenants),
                               SVC.device_name(dev))
        return {"outs": outs, "per_replica": per_rep, "prompts": prompts, "sessions": sessions}

    per, n = mesh[0] * mesh[1], args.replicas
    if per == 1:  # every replica an engine in this process
        devices = MESH.replica_devices(device.type, n)
        return lead([replica(d) for d in devices], devices[0])
    backend = MESH.default_backend(args.dist_backend, device.type)
    return MESH.run_ranks(n * per, backend, main, argv,
                          lambda: SVC.serve_ranks(mesh, n, backend, device.type, replica, lead))


def main(argv=None):
    args = parse_args(argv)
    device = device_of(args.device)
    cfg = serve_config(args.arch)
    params = T.init_params(cfg, seeded(device), device)
    if args.mesh:
        return run_mesh(args, cfg, params, device, list(argv if argv is not None
                                                         else sys.argv[1:]))
    return run(args, cfg, params, device)


if __name__ == "__main__":
    main()
