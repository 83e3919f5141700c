"""Where the serving engines' and host-streamed decode's time goes, on one
card.

  python3 tools/serve_probe.py

With random fp32 weights from seed 0 and ``chip_smoke.py``'s engine
workload (6 requests of 35-114 tokens over 4 slots, prefill chunk 64,
segment 8, 8 new tokens), for falcon-mamba-7b and recurrentgemma-9b at full
depth: one warm-up run of ``launch.serve.run_engine``, then a run in which
every ``chunk_step`` and ``decode_step`` call is timed on the host clock
between device synchronises (so the run itself is slower than unprobed),
and ``torch.profiler``'s table of one chunk step of 4 rows.  Then one
host-streamed decode step of llama3.2-1b (b2, a 65536-position cache
filled to 32768 positions with random k and v, moved to pinned memory, 16
slabs): how long the host takes to launch it against when the card is done,
and a profiled step's copy and compute time on the card and their overlap.
Every line names the card and its power limit.  Needs a CUDA card; exits 1
without one.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip().splitlines()[0]


def _merged(intervals):
    out = []
    for a, z in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], z)
        else:
            out.append([a, z])
    return out


def engine_steps(torch, CS, M, card, arch):
    dev = torch.device("cuda")
    cfg = CS._fp32_cfg(M, arch)
    params = CS._init_fp32(torch, M, cfg, dev)
    n_req, plen, gen = CS.ENGINE_RECURRENT
    prompts, _ = M.CLI.engine_prompts(cfg, n_req, plen)
    kw = dict(slots=CS.ENGINE_SLOTS, bucket=plen, gen=gen, segment=CS.ENGINE_SEGMENT,
              prefill_chunk=CS.ENGINE_CHUNK)
    M.CLI.run_engine(cfg, params, prompts, **kw)  # warm-up
    times = {"chunk_step": [], "decode_step": []}
    real = {k: getattr(M.SV, k) for k in times}

    def timed(name):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*a, **k)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    for name in times:
        setattr(M.SV, name, timed(name))
    try:
        run = M.CLI.run_engine(cfg, params, prompts, **kw)
    finally:
        for name, fn in real.items():
            setattr(M.SV, name, fn)
    for name, ms in times.items():
        print(f"{arch} {name}: {len(ms)} calls, {min(ms):.1f}-{max(ms):.1f} ms "
              f"(device-synchronised; the probed run {run['ms']:.1f} ms) [{card}]")
    b, cp = CS.ENGINE_SLOTS, CS.ENGINE_CHUNK
    cache = M.SV.init_cache(cfg, b, plen + gen, dev)
    toks = torch.randint(0, cfg.vocab_size, (b, cp), device=dev)
    off = torch.zeros(b, dtype=torch.int32, device=dev)
    live = torch.full((b,), cp - 14, dtype=torch.int32, device=dev)
    M.SV.chunk_step(cfg, None, params, cache, toks, off, live)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        M.SV.chunk_step(cfg, None, params, cache, toks, off, live)
        torch.cuda.synchronize()
    print(f"{arch}: one chunk step of {b} x {cp} tokens [{card}]")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=8))


def host_kv_step(torch, CS, M, card):
    dev = torch.device("cuda")
    cfg = CS._fp32_cfg(M, "llama3.2-1b")
    params = CS._init_fp32(torch, M, cfg, dev)
    b, S, s, n, _ = CS.HOST_KV
    cache = M.SV.init_cache(cfg, b, S, dev)
    for bc in M.SV._full_attn_blocks(cfg, cache):
        bc["k"][:, :, :s].normal_()
        bc["v"][:, :, :s].normal_()
        bc["kpos"][:, :, :s] = torch.arange(s, device=dev, dtype=torch.int32)
    M.SV.offload_kv(cfg, cache, dev)
    tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)

    def step(t):
        M.SV.decode_step(cfg, None, params, cache, {"tokens": tok}, s + t, n_host_chunks=n,
                         bounds=[(s + t, s + t)] * b)

    for t in range(2):
        step(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(2)
    launched = time.perf_counter() - t0
    torch.cuda.synchronize()
    print(f"host-streamed decode step (b{b}, {S} positions, {n} slabs): the host launches it in "
          f"{launched * 1e3:.1f} ms, the card is done at {(time.perf_counter() - t0) * 1e3:.1f} "
          f"ms [{card}]")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(3)
        torch.cuda.synchronize()
    ivs = {"copy": [], "compute": []}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0:
            ivs["copy" if "Memcpy" in e.name else "compute"].append(
                (e.time_range.start, e.time_range.end))
    copy, comp = _merged(ivs["copy"]), _merged(ivs["compute"])
    under = sum(max(0, min(z, d) - max(a, c)) for a, z in copy for c, d in comp)
    print(f"  profiled step on the card: copies {sum(z - a for a, z in copy) / 1e3:.1f} ms, "
          f"compute {sum(z - a for a, z in comp) / 1e3:.1f} ms, copies under compute "
          f"{under / 1e3:.1f} ms; copy kinds "
          f"{sorted({e.name for e in prof.events() if 'Memcpy' in e.name})} [{card}]")


def main():
    import torch

    if not torch.cuda.is_available():
        print("serve_probe.py needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as CS

    M = CS._modules()
    card = _card()
    for arch in ("falcon-mamba-7b", "recurrentgemma-9b"):
        engine_steps(torch, CS, M, card, arch)
        torch.cuda.empty_cache()
    host_kv_step(torch, CS, M, card)


if __name__ == "__main__":
    main()
