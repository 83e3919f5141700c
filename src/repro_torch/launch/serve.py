"""Serving CLI: batched FPDT prefill + multi-token decode, on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --batch 4 --prompt-len 64 --gen 32 [--temperature 0.8 --top-k 40] \
      [--reduced] [--device cuda|cpu]

The same flags as the JAX package's non-engine serve path.  Weights and
prompts are random, from ``--seed``.  The run is on the card unless
``--device cpu`` asks for the CPU; with no card it stops instead of
falling back.  Every time it prints names the device it was taken on.
Every registered arch serves, the recurrent ones (recurrentgemma-9b,
falcon-mamba-7b) included.  ``--engine`` (continuous batching) and
``--host-kv-chunks`` are not yet ported: the CLI exits 2.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ModelConfig, get_config, reduced
from repro_torch.models import serve as SV
from repro_torch.models import transformer as T
from repro_torch.runtime import decode_loop as DL


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch(cfg: ModelConfig, params, tokens: torch.Tensor, *, gen: int,
                sampling: DL.SamplingConfig = DL.GREEDY,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """Prefill ``tokens [b, s]`` and generate ``gen`` tokens per row (the
    first from the prefill logits), timing both phases on the host clock
    around work that ends in a device synchronise.

    Returns {"tokens" [b, gen], "prefill_logits" [b, padded_vocab],
    "prefill_ms", "decode_ms", "steps"}."""
    device = tokens.device
    b, s = tokens.shape
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = SV.prefill_step(cfg, None, params, {"tokens": tokens}, max_len=s + gen)
    _sync(device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok0 = DL.sample_token(logits[:, : cfg.vocab_size], generator, sampling)
    steps = gen - 1
    t0 = time.perf_counter()
    toks, _ = DL.decode_tokens(cfg, None, params, cache, tok0[:, None],
                               torch.full((b,), s, dtype=torch.int32, device=device),
                               num_steps=steps, sampling=sampling, generator=generator)
    _sync(device)
    decode_ms = (time.perf_counter() - t0) * 1e3
    return {"tokens": torch.cat([tok0[:, None], toks], dim=1), "prefill_logits": logits,
            "prefill_ms": prefill_ms, "decode_ms": decode_ms, "steps": steps}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--host-kv-chunks", type=int, default=0,
                    help="FPDT-for-inference host KV streaming (not yet ported)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples at this temperature")
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the k best tokens (0 = all)")
    ap.add_argument("--engine", action="store_true",
                    help="continuous batching (not yet ported)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default) or, when asked, on the CPU")
    args = ap.parse_args(argv)
    if args.engine:
        ap.exit(2, "--engine: the continuous-batching engine is not yet ported\n")
    if args.host_kv_chunks > 0:
        ap.exit(2, "--host-kv-chunks: host-streamed KV decode is not yet ported\n")
    if args.gen < 1 or args.prompt_len < 1 or args.batch < 1:
        ap.error("--batch, --prompt-len and --gen must be >= 1")
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.exit(1, "no CUDA device is available; pass --device cpu to run on the CPU\n")
    device = torch.device(args.device)
    name = device_name(device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    cfg = dataclasses.replace(cfg, remat="none")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init_params(cfg, gen, device)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
                           device=device)
    sampling = DL.SamplingConfig(temperature=args.temperature, top_k=args.top_k)
    out = serve_batch(cfg, params, tokens, gen=args.gen, sampling=sampling, generator=gen)
    b, steps = args.batch, out["steps"]
    print(f"prefill {args.prompt_len} tokens x {b} seqs: {out['prefill_ms']:.1f} ms on {name}")
    dt = out["decode_ms"] / 1e3
    print(f"decode {steps} steps x {b} seqs: {out['decode_ms']:.1f} ms "
          f"({out['decode_ms'] / max(1, steps):.2f} ms/step, "
          f"{steps * b / max(dt, 1e-9):.1f} tok/s) on {name}")
    print("generated token ids (first seq):", out["tokens"][0].tolist())
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
