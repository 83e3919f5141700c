#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernel to account.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:
  1. device   — the card's name and power limit (nvidia-smi) and torch's name;
  2. build    — nvcc builds the hand-written CUDA flash_fwd for sm_90a from
                the checkout's sources;
  3. kernel   — flash_fwd against its plain PyTorch version (ref.attend_chunk)
                on the card: fp32 and bf16, head_dim 16/64/128, GQA, ragged
                lengths, carry-in with offsets, windows, fully masked rows,
                the serve shapes and every (i, j <= i) chunk pair of a 2048
                prompt at u = 4;
  4. serve    — llama3.2-1b at full width with random weights from a seeded
                generator, through the CLI's own function (serve_batch):
                batch 4, prompt 64, gen 32, greedy; the launch count is reset
                just before and read just after.  Decode's first step against a
                prefill of one more token, in fp32 weights.  Then a 2048 prompt
                whose prefill logits at fpdt_chunks=4 must equal fpdt_chunks=1;
  5. timing   — flash_fwd at the serve shapes beside its bound, the plain
                version and scaled_dot_product_attention (timed as a yardstick
                only: the port never calls it), each as device time from a CUDA
                graph of repeated calls; the kernel's wrapper also launched from
                the host back to back (wrapper_ms: host dispatch included);
  6. kernels  — one JSON line per the kernel contract;
  7. last line: {"ok": true, "device": {...}}.

It imports only the port (``src/repro_torch``), torch and the standard
library, and stops if there is no card or no port beside it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published dense peaks of one H100 SXM at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

TOL = {"float32": 1e-5, "bfloat16": 3e-2}  # tests/test_kernels_flash.py:34
# fp32 logits of decode vs prefill, relative to the logits' largest magnitude:
# other matmul shapes and another softmax order, fp32 rounding through 16 layers.
FP32_LOGIT_RTOL = 1e-4
# Prefill at fpdt_chunks=4 vs 1 is held to bit equality (measured so on the
# H100): 512 is a multiple of the kernel's 64-key tile, so each row meets the
# same tiles in the same order and its fp32 carry passes through memory
# unchanged between the chunk calls; every other product sees the same rows.


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name, fn, *args):
    print(f"== {name}", flush=True)
    try:
        return fn(*args)
    except SystemExit:
        raise
    except Exception:  # every phase failure ends the run with its traceback
        traceback.print_exc()
        fail(f"phase {name!r} failed")


def phase_device(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device 0: {name} "
          f"(count {torch.cuda.device_count()})")
    return card, name


def phase_build(K):
    t0 = time.perf_counter()
    lib = K.build()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    log = lib.with_suffix(".log")
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


def _max_violation(got, want, tol):
    """(max |got - want|, whether any element leaves atol + rtol*|want|)."""
    diff = (got.float() - want.float()).abs()
    return float(diff.max()), bool((diff > tol + tol * want.float().abs()).any())


def phase_kernel(torch, K, R, SoftmaxState, finalize):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    errs = {"float32": 0.0, "bfloat16": 0.0}
    acc_errs = dict(errs)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def carry_of(b, hq, sq, d):
        return SoftmaxState(rnd(b, hq, sq, d), rnd(b, hq, sq), torch.rand(
            (b, hq, sq), generator=g, device=dev) + 0.5)

    def check(label, dtype, q, k, v, carry, **kw):
        got = K.flash_fwd(q, k, v, None if carry is None else tuple(carry), **kw)
        want = R.attend_chunk(q, k, v, carry=carry, **kw)
        torch.cuda.synchronize()
        tname = str(dtype).split(".")[-1]
        tol = TOL[tname]
        worst = 0.0
        for part, a, b in (("m", got[1], want.m), ("l", got[2], want.l),
                           ("out", finalize(SoftmaxState(*got)), finalize(want))):
            err, bad = _max_violation(a, b, tol)
            if not torch.isfinite(a).all():
                raise AssertionError(f"{label}: non-finite {part}")
            if bad:
                raise AssertionError(f"{label}: {part} max err {err:.3e} beyond tol {tol}")
            worst = max(worst, err)
        # acc is unnormalized, a sum of up to sk terms p*v with p <= 1: its
        # rounding grows with the row's l, not with |acc| (terms cancel), so
        # it is held at tol * (1 + l); out = acc / l above holds it at tol.
        if not torch.isfinite(got[0]).all():
            raise AssertionError(f"{label}: non-finite acc")
        acc_rel = float(((got[0] - want.acc).abs() / (1.0 + want.l[..., None])).max())
        if acc_rel > tol:
            raise AssertionError(f"{label}: acc err / (1 + l) {acc_rel:.3e} beyond tol {tol}")
        errs[tname] = max(errs[tname], worst)
        acc_errs[tname] = max(acc_errs[tname], acc_rel)
        return want

    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 64, 128):
            cases = [
                # label, b, hq, hkv, sq, sk, causal, window, q_off, k_off, carry
                ("ragged-diag", 2, 4, 4, 100, 100, True, 0, 0, 0, False),
                ("gqa4-window-carry", 2, 8, 2, 100, 70, True, 33, 90, 40, True),
                ("future-keys-all-masked", 1, 4, 1, 64, 64, True, 33, 0, 200, True),
                ("noncausal-carry", 1, 4, 2, 37, 100, False, 0, 0, 0, True),
            ]
            for label, b, hq, hkv, sq, sk, causal, window, qo, ko, carry in cases:
                q = rnd(b, hq, sq, d).to(dtype)
                k = rnd(b, hkv, sk, d).to(dtype)
                v = rnd(b, hkv, sk, d).to(dtype)
                st = carry_of(b, hq, sq, d) if carry else None
                check(f"{label} d={d} {dtype}", dtype, q, k, v, st, causal=causal,
                      window=window, q_offset=qo, k_offset=ko)
                n += 1
    # the serve shapes, one call per layer at u=1: the 64-token prompt, the
    # 65-token prefill of the decode-vs-prefill check, the 2048 prompt
    for s in (64, 65, 2048):
        for dtype in (torch.float32, torch.bfloat16):
            q = rnd(4, 32, s, 64).to(dtype)
            k, v = rnd(4, 8, s, 64).to(dtype), rnd(4, 8, s, 64).to(dtype)
            check(f"serve b4 hq32 hkv8 s{s} {dtype}", dtype, q, k, v, None)
            n += 1
    # the u=4 chunks of a 2048 prompt (cq=512): every (i, j <= i) pair, each
    # fed the plain version's running state as its carry
    cq, u = 512, 4
    qs = [rnd(4, 32, cq, 64).to(torch.bfloat16) for _ in range(u)]
    ks = [rnd(4, 8, cq, 64).to(torch.bfloat16) for _ in range(u)]
    vs = [rnd(4, 8, cq, 64).to(torch.bfloat16) for _ in range(u)]
    for i in range(u):
        st = None
        for j in range(i + 1):
            st = check(f"fpdt pair ({i},{j})", torch.bfloat16, qs[i], ks[j], vs[j], st,
                       causal=True, q_offset=i * cq, k_offset=j * cq)
            n += 1
    print(f"kernel vs plain: {n} cases within tolerance; max abs err of out, m, l: "
          f"fp32 {errs['float32']:.3e} bf16 {errs['bfloat16']:.3e}; acc err / (1 + l): "
          f"fp32 {acc_errs['float32']:.3e} bf16 {acc_errs['bfloat16']:.3e}")
    return errs


def phase_serve(torch, K, cfg_mod, T, SV, CLI, card):
    dev = torch.device("cuda")
    cfg = cfg_mod.get_config("llama3.2-1b")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    print(f"init_params {cfg.name} ({cfg.num_params() / 1e9:.3f} B params, "
          f"{cfg.param_dtype}) in {time.perf_counter() - t0:.1f} s")
    b, s, new = 4, 64, 32
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    CLI.serve_batch(cfg, params, tokens, gen=new)  # warm-up: cuBLAS and allocator set-up

    torch.cuda.reset_peak_memory_stats()
    K.launches = 0
    out = CLI.serve_batch(cfg, params, tokens, gen=new)
    launches = K.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    logits, toks = out["prefill_logits"], out["tokens"]
    if launches <= 0:
        raise AssertionError("the serve path launched flash_fwd no time")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    if tuple(toks.shape) != (b, new) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"bad generated tokens {tuple(toks.shape)}")
    steps = out["steps"]
    print(f"serve {cfg.name} b={b} prompt={s} gen={new}: flash_fwd launches {launches}; "
          f"prefill {out['prefill_ms']:.2f} ms; decode {out['decode_ms'] / steps:.3f} ms/step, "
          f"{steps * b / (out['decode_ms'] / 1e3):.1f} tok/s; peak {peak_gib:.2f} GiB "
          f"[{card}]")
    print("generated ids (row 0):", toks[0].tolist())

    # decode agrees with prefill (the repo's own check): the first decode
    # step's logits == the last logits of a prefill over the prompt plus that
    # token.  In fp32 weights, so the two orders of summation differ by fp32
    # rounding only; beside it, how far the same logits move when only the
    # first prompt token changes, which reaches them through attention alone.
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    params32 = T.init_params(cfg32, torch.Generator(device=dev).manual_seed(0), dev)
    nxt = toks[:, :1]
    other = tokens.clone()
    other[:, 0] = (other[:, 0] + 1) % cfg.vocab_size
    with torch.no_grad():
        _, cache = SV.prefill_step(cfg32, None, params32, {"tokens": tokens}, max_len=s + 1)
        dec, _ = SV.decode_step(cfg32, None, params32, cache, {"tokens": nxt}, s)
        full, _ = SV.prefill_step(cfg32, None, params32,
                                  {"tokens": torch.cat([tokens, nxt], dim=1)}, max_len=s + 1)
        moved, _ = SV.prefill_step(cfg32, None, params32,
                                   {"tokens": torch.cat([other, nxt], dim=1)}, max_len=s + 1)
    scale = float(full.abs().max())
    rel = float((dec - full).abs().max()) / scale
    signal = float((moved - full).abs().max()) / scale
    del params32, cache
    print(f"decode-vs-prefill fp32 logits: max |diff| / max |logit| = {rel:.3e} "
          f"(tolerance {FP32_LOGIT_RTOL}); changing prompt token 0 moves them {signal:.3e}")
    if not rel <= FP32_LOGIT_RTOL:
        raise AssertionError("decode step disagrees with prefill")
    if not signal >= 10 * FP32_LOGIT_RTOL:
        raise AssertionError("the decode-vs-prefill check cannot see the context: "
                             f"a changed prompt moves the logits by {signal:.3e} only")

    # a 2048 prompt: FPDT with u=4 computes what u=1 computes
    s2 = 2048
    tokens2 = torch.randint(0, cfg.vocab_size, (b, s2), generator=gen, device=dev)
    res = {}
    for u in (1, 4):
        cu = dataclasses.replace(cfg, fpdt_chunks=u)
        SV.prefill_step(cu, None, params, {"tokens": tokens2}, max_len=s2)  # warm-up
        K.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, _ = SV.prefill_step(cu, None, params, {"tokens": tokens2}, max_len=s2)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        res[u] = lg
        if not torch.isfinite(lg).all() or K.launches <= 0:
            raise AssertionError(f"u={u}: non-finite logits or no kernel launch")
        print(f"prefill {cfg.name} b={b} prompt={s2} fpdt_chunks={u}: {ms:.2f} ms, "
              f"flash_fwd launches {K.launches} [{card}]")
    diff = float((res[4] - res[1]).abs().max())
    print(f"u=4 vs u=1 prefill logits: max |diff| = {diff:.3e} (must be 0)")
    if diff != 0.0:
        raise AssertionError("u=4 prefill differs from u=1")
    return launches


def _eager_ms(torch, fn, iters=200, warmup=20):
    """Per call, launched back to back from the host (CUDA events): at small
    shapes this is the host's dispatch time, wrapper included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, fn, per_graph=20, replays=10):
    """Per call, on the device: ``per_graph`` calls captured in one CUDA
    graph, the graph replayed and timed with CUDA events, so no host work
    sits between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as capture wants
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * per_graph)
    del graph
    return ms


def _bound(b, hq, hkv, sq, sk, d, in_bytes, q_offset, k_offset, carry):
    """Least time on the card: (ms, "bytes"|"operations").  Operations count
    4*d per live causal (q, k) pair (q.k and p.v); bytes count q, k, v (and a
    carry) read once and (acc, m, l) written once."""
    live = 0
    for r in range(sq):
        qpos = q_offset + r
        live += max(0, min(sk, qpos - k_offset + 1))
    flops = 4 * d * live * b * hq
    nbytes = in_bytes * (b * hq * sq * d + 2 * b * hkv * sk * d) + 4 * (b * hq * sq * (d + 2))
    if carry:
        nbytes += 4 * (b * hq * sq * (d + 2))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_timing(torch, K, R, card):
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    rows = []
    shapes = [
        # label, b, hq, hkv, sq, sk, q_off, k_off, carry
        ("serve prefill b4 s64 (u=1)", 4, 32, 8, 64, 64, 0, 0, False),
        ("2048 prompt u=4 off-diagonal pair cq=512", 4, 32, 8, 512, 512, 512, 0, True),
        ("2048 prompt u=4 diagonal pair cq=512", 4, 32, 8, 512, 512, 512, 512, True),
    ]
    for label, b, hq, hkv, sq, sk, qo, ko, carry in shapes:
        q = torch.randn((b, hq, sq, 64), generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn((b, hkv, sk, 64), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((b, hkv, sk, 64), generator=g, device=dev).to(torch.bfloat16)
        st = None
        if carry:
            st = (torch.randn((b, hq, sq, 64), generator=g, device=dev),
                  torch.randn((b, hq, sq), generator=g, device=dev),
                  torch.rand((b, hq, sq), generator=g, device=dev) + 0.5)
        kw = dict(causal=True, q_offset=qo, k_offset=ko)

        def kern():
            return K.flash_fwd(q, k, v, st, **kw)

        def plain():
            return R.attend_chunk(q, k, v, carry=None if st is None else R.SoftmaxState(*st),
                                  **kw)

        # yardstick: one library call of (normalized) causal GQA attention on
        # the same q/k/v; only meaningful where the causal diagonal matches
        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

        bound_ms, bound_by = _bound(b, hq, hkv, sq, sk, 64, 2, qo, ko, carry)
        row = {"shape": label, "ms": _device_ms(torch, kern),
               "plain_ms": _device_ms(torch, plain), "bound_ms": bound_ms,
               "bound_by": bound_by,
               "library_ms": _device_ms(torch, library) if qo == ko else None,
               "wrapper_ms": _eager_ms(torch, kern), "card": card}
        print("timing " + json.dumps(row))
        rows.append(row)
    return rows[0]


def main():
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"the port is not beside this script: {SRC / 'repro_torch'} is missing")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products in full fp32

    from repro_torch import configs as cfg_mod
    from repro_torch.core.online_softmax import SoftmaxState, finalize
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref as R
    from repro_torch.launch import serve as CLI
    from repro_torch.models import serve as SV
    from repro_torch.models import transformer as T

    card, name = phase("device", phase_device, torch)
    phase("build", phase_build, K)
    errs = phase("kernel vs plain", phase_kernel, torch, K, R, SoftmaxState, finalize)
    launches = phase("serve llama3.2-1b", phase_serve, torch, K, cfg_mod, T, SV, CLI, card)
    timing = phase("timing", phase_timing, torch, K, R, card)
    kernels = {"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:134",
        "launches": launches,
        "max_abs_err": max(errs.values()),
        "max_err_fp32": errs["float32"],
        "max_err_bf16": errs["bfloat16"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "wrapper_ms": timing["wrapper_ms"],
    }]}
    if not all(math.isfinite(x) for x in (timing["ms"], timing["plain_ms"])):
        fail("non-finite timing")
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
