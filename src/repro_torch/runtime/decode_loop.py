"""Multi-token decode loop over ``models/serve.py::decode_step``.

The JAX package runs the generation as one ``lax.scan`` so the decode body
is traced once; eager PyTorch runs the same carry through a Python loop.
The loop never reads a device value on the host, so the card runs ahead of
the launching thread.  The continuous-batching engines are not yet ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.parallel import ParallelContext
from repro_torch.models import serve as SV

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """``temperature <= 0`` selects greedy argmax (the default); otherwise
    categorical sampling at the given temperature, optionally restricted to
    the ``top_k`` highest-probability tokens (0 = full vocabulary)."""

    temperature: float = 0.0
    top_k: int = 0


GREEDY = SamplingConfig()


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 sc: SamplingConfig = GREEDY) -> torch.Tensor:
    """logits [b, V] fp32 -> sampled token ids [b] int32.  Greedy ignores
    ``generator``; sampling draws from it (a generator on logits' device)."""
    if sc.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if sc.top_k:
        kth = torch.topk(logits, sc.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -torch.inf), logits)
    probs = torch.softmax(logits / sc.temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


@torch.no_grad()
def decode_tokens(cfg: ModelConfig, par: Optional[ParallelContext], params: Params,
                  cache: Params, tok: torch.Tensor, pos, *, num_steps: int,
                  sampling: SamplingConfig = GREEDY, stop_tokens: Sequence[int] = (),
                  pad_id: int = 0, generator: Optional[torch.Generator] = None,
                  done: Optional[torch.Tensor] = None,
                  remaining: Optional[torch.Tensor] = None,
                  collect_logits: bool = False):
    """Generate up to ``num_steps`` tokens per sequence.

    Carry contract (the JAX package's, with a ``torch.Generator`` in place
    of the PRNG key):
      cache      — decode cache (``models/serve.py`` layout), updated in place;
      tok [b,1]  — the token each sequence feeds NEXT.  The caller samples
                   the first token from the prefill logits, so the full
                   generation is ``[tok0, *emitted]``;
      pos [b]    — the position ``tok`` occupies; frozen once a row is done;
      generator  — sampling randomness (unused under greedy);
      done [b]   — finished rows emit ``pad_id``, stop advancing ``pos``,
                   and stop consuming budget;
      remaining [b] — per-row emission budget; a row finishes after
                   emitting ``remaining`` tokens or a ``stop_tokens`` hit
                   (the stop token itself is emitted).

    Step t feeds ``tok`` at ``pos``, samples from the resulting logits, and
    emits the SAMPLED token.  An audio model, which feeds frame embeddings,
    is refused (ValueError), as in the JAX package.

    Returns ``(tokens [b, num_steps] int32, aux)`` with
    ``aux = {cache, tok, pos, generator, done, remaining[, logits]}`` — the
    carry, so calls chain; ``collect_logits`` adds the per-step
    pre-sampling logits ``[num_steps, b, vocab]``.
    """
    if cfg.frontend == "audio_frames":
        raise ValueError("decode_tokens feeds token ids; the audio_frames "
                         "frontend consumes frame embeddings — drive "
                         "decode_step directly for frame synthesis")
    b = tok.shape[0]
    device = tok.device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device).expand(b).clone()
    done = torch.zeros(b, dtype=torch.bool, device=device) if done is None else done
    if remaining is None:
        remaining = torch.full((b,), num_steps + 1, dtype=torch.int32, device=device)
    remaining = torch.as_tensor(remaining, dtype=torch.int32, device=device)
    done = done | (remaining <= 0)
    stop = torch.as_tensor(tuple(stop_tokens), dtype=torch.int32, device=device)
    tok = tok.to(torch.int32)
    toks, all_logits = [], []
    for _ in range(num_steps):
        logits, cache = SV.decode_step(cfg, par, params, cache, {"tokens": tok}, pos)
        lv = logits[:, : cfg.vocab_size]
        nxt = sample_token(lv, generator, sampling)
        remaining = remaining - (~done).to(torch.int32)
        emit = torch.where(done, torch.full_like(nxt, pad_id), nxt)
        pos = torch.where(done, pos, pos + 1)
        done = done | torch.isin(nxt, stop) | (remaining <= 0)
        tok = emit[:, None]
        toks.append(emit)
        if collect_logits:
            all_logits.append(lv)
    tokens = (torch.stack(toks, dim=1) if toks
              else torch.zeros((b, 0), dtype=torch.int32, device=device))
    aux = {"cache": cache, "tok": tok, "pos": pos, "generator": generator,
           "done": done, "remaining": remaining}
    if collect_logits:
        aux["logits"] = torch.stack(all_logits) if all_logits else None
    return tokens, aux
