"""Serving CLI: batched FPDT prefill + multi-token decode, on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --batch 4 --prompt-len 64 --gen 32 [--temperature 0.8 --top-k 40] \
      [--per-token] [--reduced] [--device cuda|cpu]

The same flags as the JAX package's non-engine serve path, ``--per-token``
included.  Weights and prompts are random, from ``--seed``; an audio
model's prompt is ``--prompt-len`` frame embeddings and its decode steps
feed fresh random frames (a per-token loop), a vision model's prompt is
its ``num_patches`` patch embeddings and ``--prompt-len`` minus those in
tokens.  The run is on the card unless
``--device cpu`` asks for the CPU; with no card it stops instead of
falling back.  Every time it prints names the device it was taken on.
Every registered arch serves, the recurrent ones (recurrentgemma-9b,
falcon-mamba-7b) and the frontends' (musicgen-medium, internvl2-2b)
included.  ``--engine`` (continuous batching) and
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


def serve_batch(cfg: ModelConfig, params, prompt: Dict[str, torch.Tensor], *, gen: int,
                sampling: DL.SamplingConfig = DL.GREEDY,
                generator: Optional[torch.Generator] = None, per_token: bool = False,
                frames: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """Prefill the prompt batch (``models/serve.py::prefill_step``'s:
    {"tokens" [b, s]}, {"frame_embeds" [b, s, d]} or {"patch_embeds" [b,
    P, d], "tokens" [b, s - P]}) and generate ``gen`` tokens per row (the
    first from the prefill logits), timing both phases on the host clock
    around work that ends in a device synchronise.  Decode runs
    ``decode_loop.decode_tokens`` or, with ``per_token`` and always for the
    audio frontend, a loop over ``decode_step`` that samples each token on
    the way; an audio model's step t feeds ``frames[:, t]`` ([b, gen - 1,
    d], the caller's), as the JAX CLI feeds fresh random frames.

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
    t0 = time.perf_counter()
    if per_token or audio:
        outs = [tok0[:, None]]
        for i in range(steps):
            inp = {"frame_embeds": frames[:, i:i + 1]} if audio else {"tokens": outs[-1]}
            lg, cache = SV.decode_step(cfg, None, params, cache, inp, s + i)
            outs.append(DL.sample_token(lg[:, : cfg.vocab_size], generator, sampling)[:, None])
        toks, mode = torch.cat(outs, dim=1), "per-token loop"
    else:
        toks, _ = DL.decode_tokens(cfg, None, params, cache, tok0[:, None],
                                   torch.full((b,), s, dtype=torch.int32, device=device),
                                   num_steps=steps, sampling=sampling, generator=generator)
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
    ap.add_argument("--per-token", action="store_true",
                    help="a Python loop over decode_step, sampling each token on the way, "
                         "in place of decode_tokens (always for the audio frontend)")
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
    if cfg.frontend == "vision_patches" and args.prompt_len <= cfg.num_patches:
        ap.error(f"--prompt-len {args.prompt_len} counts the {cfg.num_patches} image patches "
                 "and the tokens after them: it must exceed the patches")
    params = T.init_params(cfg, gen, device)
    prompt = random_prompt(cfg, args.batch, args.prompt_len, gen, device)
    frames = None
    if cfg.frontend == "audio_frames":  # the decode steps' frames, fresh random ones
        frames = random_prompt(cfg, args.batch, args.gen - 1, gen, device)["frame_embeds"]
    sampling = DL.SamplingConfig(temperature=args.temperature, top_k=args.top_k)
    out = serve_batch(cfg, params, prompt, gen=args.gen, sampling=sampling, generator=gen,
                      per_token=args.per_token, frames=frames)
    b, steps = args.batch, out["steps"]
    print(f"prefill {args.prompt_len} tokens x {b} seqs: {out['prefill_ms']:.1f} ms on {name}")
    dt = out["decode_ms"] / 1e3
    print(f"decode [{out['mode']}] {steps} steps x {b} seqs: {out['decode_ms']:.1f} ms "
          f"({out['decode_ms'] / max(1, steps):.2f} ms/step, "
          f"{steps * b / max(dt, 1e-9):.1f} tok/s) on {name}")
    print("generated token ids (first seq):", out["tokens"][0].tolist())
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
