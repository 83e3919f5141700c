"""Plain PyTorch versions of the flash-attention chunk kernels.

Exact fp32 attention over one (q-chunk, kv-chunk) pair with global position
offsets (for FPDT chunk scheduling): the forward continues an optional
carry-in state and returns the same ``(acc, m, l)`` unnormalized
online-softmax state as the CUDA ``flash_fwd`` in ``kernel.py``; the two
backward functions give the pair's ``dq`` and its GQA-summed ``(dk, dv)``
from the final row log-sum-exp ``L`` and ``delta = sum(do * o)``, as the
CUDA ``flash_bwd_dq`` / ``flash_bwd_dkv`` do.  The CPU path runs them, and
``chip_smoke.py`` holds the kernels against them on the card.

``attend_chunk_tc``, ``chunk_bwd_dq_tc`` and ``chunk_bwd_dkv_tc`` are the
same functions rounded where the bf16 tensor-core kernels round (P to bf16
before P V; dO and dS to bf16 before dP and dQ; dO, P^T and dS^T to bf16
before dV and dK), so that ``chip_smoke.py`` can hold those kernels to fp32
accumulation order alone; the CPU path never runs them.

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


def _live(sq: int, sk: int, *, causal: bool, window: int, q_offset: int, k_offset: int,
          device) -> Optional[torch.Tensor]:
    """[sq, sk] mask of the (q, k) pairs attended at global positions, or
    None when every pair is (no causal mask)."""
    if not causal:
        return None
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = k_offset + torch.arange(sk, device=device)[None, :]
    ok = qpos >= kpos
    if window:
        ok = ok & (qpos - kpos < window)
    return ok


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
    ok = _live(sq, k.shape[2], causal=causal, window=window, q_offset=q_offset,
               k_offset=k_offset, device=q.device)
    if ok is not None:
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


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def attend_chunk_tc(
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
    """attend_chunk as the bf16 tensor-core flash_fwd rounds it: the online
    softmax over key tiles (64 keys, 32 at head_dim > 128) from the chunk's
    first key, P rounded to bf16 before P V, l summing the fp32 p."""
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    tile = 32 if d > 128 else 64
    ke, ve = _expand_kv(k, hq).float(), _expand_kv(v, hq).float()
    qf = q.float()
    scale = sm_scale if sm_scale is not None else d ** -0.5
    ok = _live(sq, sk, causal=causal, window=window, q_offset=q_offset, k_offset=k_offset,
               device=q.device)
    if carry is None:
        acc = torch.zeros((b, hq, sq, d), device=q.device)
        m = torch.full((b, hq, sq), NEG_INF, device=q.device)
        l = torch.zeros((b, hq, sq), device=q.device)
    else:
        acc, m, l = carry
    for k0 in range(0, sk, tile):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, ke[:, :, k0:k0 + tile]) * scale
        if ok is not None:
            s = torch.where(ok[:, k0:k0 + tile], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(s <= NEG_INF / 2, torch.zeros_like(s), torch.exp(s - m_new[..., None]))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", _bf16(p),
                                                    ve[:, :, k0:k0 + tile])
        m = m_new
    return SoftmaxState(acc=acc, m=m, l=l)


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


def _bwd_terms(q, k, v, do, L, delta, *, causal, window, q_offset, k_offset, sm_scale):
    """(p, ds, k, q) of one pair in fp32 with kv heads expanded to q heads:
    p = exp(s - L), set to 0 where the mask cuts; ds = p (do v^T - delta) scale."""
    b, hq, sq, d = q.shape
    scale = sm_scale if sm_scale is not None else d ** -0.5
    ke = _expand_kv(k, hq).float()
    ve = _expand_kv(v, hq).float()
    qf = q.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, ke) * scale
    p = torch.exp(s - L[..., None])
    ok = _live(sq, k.shape[2], causal=causal, window=window, q_offset=q_offset,
               k_offset=k_offset, device=q.device)
    if ok is not None:
        p = torch.where(ok, p, torch.zeros_like(p))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), ve)
    ds = p * (dp - delta[..., None]) * scale
    return p, ds, ke, qf


def chunk_bwd_dq(q, k, v, do, L, delta, *, causal: bool = True, window: int = 0,
                 q_offset: int = 0, k_offset: int = 0,
                 sm_scale: Optional[float] = None) -> torch.Tensor:
    """dq [b, hq, sq, d] fp32 of one (q-chunk, kv-chunk) pair: sum over keys
    of ds * k.  do [b, hq, sq, d]; L, delta [b, hq, sq] fp32."""
    _, ds, ke, _ = _bwd_terms(q, k, v, do, L, delta, causal=causal, window=window,
                              q_offset=q_offset, k_offset=k_offset, sm_scale=sm_scale)
    return torch.einsum("bhqk,bhkd->bhqd", ds, ke)


def chunk_bwd_dq_tc(q, k, v, do, L, delta, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, k_offset: int = 0,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """chunk_bwd_dq as the bf16 tensor-core flash_bwd_dq rounds it: dO to
    bf16 before dP = dO V^T, dS (from the fp32 p) to bf16 before dS K."""
    _, ds, ke, _ = _bwd_terms(q, k, v, _bf16(do), L, delta, causal=causal, window=window,
                              q_offset=q_offset, k_offset=k_offset, sm_scale=sm_scale)
    return torch.einsum("bhqk,bhkd->bhqd", _bf16(ds), ke)


def chunk_bwd_dkv(q, k, v, do, L, delta, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0, k_offset: int = 0, sm_scale: Optional[float] = None):
    """(dk, dv) [b, hkv, sk, d] fp32 of one pair: dv = p^T do and dk = ds^T q,
    summed over the g q-heads of each kv group."""
    p, ds, _, qf = _bwd_terms(q, k, v, do, L, delta, causal=causal, window=window,
                              q_offset=q_offset, k_offset=k_offset, sm_scale=sm_scale)
    return _dkv(p, ds, do.float(), qf, k.shape[1])


def chunk_bwd_dkv_tc(q, k, v, do, L, delta, *, causal: bool = True, window: int = 0,
                     q_offset: int = 0, k_offset: int = 0, sm_scale: Optional[float] = None):
    """chunk_bwd_dkv as the bf16 tensor-core flash_bwd_dkv rounds it: dO to
    bf16 before both products that read it, P^T and dS^T (from the fp32 p)
    to bf16 before dV and dK."""
    do16 = _bf16(do)
    p, ds, _, qf = _bwd_terms(q, k, v, do16, L, delta, causal=causal, window=window,
                              q_offset=q_offset, k_offset=k_offset, sm_scale=sm_scale)
    return _dkv(_bf16(p), _bf16(ds), do16, qf, k.shape[1])


def _dkv(p, ds, do, q, hkv):
    """dv = p^T do and dk = ds^T q, summed over each kv group's q heads."""
    b, hq, _, d = q.shape
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q)
    if hq != hkv:  # GQA: sum the q-head group
        dk = dk.reshape(b, hkv, hq // hkv, -1, d).sum(2)
        dv = dv.reshape(b, hkv, hq // hkv, -1, d).sum(2)
    return dk, dv
