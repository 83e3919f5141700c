"""Plain PyTorch version of the flash-attention chunk forward.

Exact fp32 attention over one (q-chunk, kv-chunk) pair with global position
offsets (for FPDT chunk scheduling) and optional carry-in state, returning
the same ``(acc, m, l)`` unnormalized online-softmax state as the CUDA
kernel in ``kernel.py``.  The CPU path runs it, and ``chip_smoke.py`` holds
the kernel against it on the card.

Layout: q [b, hq, sq, d], k/v [b, hkv, sk, d]; GQA via head-group mapping
(kv head = q head // (hq // hkv)).  The window applies only under
``causal=True``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.online_softmax import NEG_INF, SoftmaxState, finalize, merge


def _expand_kv(x: torch.Tensor, hq: int) -> torch.Tensor:
    hkv = x.shape[1]
    if hkv == hq:
        return x
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    return torch.repeat_interleave(x, hq // hkv, dim=1)


def attend_chunk(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    k_offset: int = 0,
    sm_scale: Optional[float] = None,
    carry: Optional[SoftmaxState] = None,
) -> SoftmaxState:
    """Online-softmax state after attending q (at q_offset) to k/v (at k_offset)."""
    b, hq, sq, d = q.shape
    k = _expand_kv(k, hq)
    v = _expand_kv(v, hq)
    scale = sm_scale if sm_scale is not None else d ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
        kpos = k_offset + torch.arange(k.shape[2], device=q.device)[None, :]
        ok = qpos >= kpos
        if window:
            ok = ok & (qpos - kpos < window)
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1)
    # fully-masked rows: keep identity state
    masked = m <= NEG_INF / 2
    m_safe = torch.where(masked, torch.full_like(m, NEG_INF), m)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(masked[..., None], torch.zeros_like(p), p)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    state = SoftmaxState(acc=acc, m=m_safe, l=l)
    if carry is not None:
        state = merge(carry, state)
    return state


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    k_offset: int = 0,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Full exact attention (normalized output, q.dtype)."""
    st = attend_chunk(q, k, v, causal=causal, window=window, q_offset=q_offset,
                      k_offset=k_offset, sm_scale=sm_scale)
    return finalize(st).to(q.dtype)
