"""Chunk-level flash-attention primitives that FPDT schedules.

  chunk_fwd      (q_i, kv_j, carry) -> running (acc, m, l)
  chunk_bwd_dq   one pair's dq, given the final row LSE and delta
  chunk_bwd_dkv  one pair's (dk, dv), GQA-summed
plus ``flash_attention``, a single-call attention whose backward runs the
two backward ops (the JAX package's ``custom_vjp`` as a
``torch.autograd.Function``).

Each op is picked by the tensors' device alone: the hand-written CUDA
kernel (``kernel.py``) for CUDA tensors, the plain PyTorch version
(``ref.py``) for CPU tensors.  Tensors on mixed devices, or on any other
device, raise, so a CUDA tensor never silently takes the plain path.  On
the card the input dtype alone picks the kernel: bf16 inputs run
tensor-core kernels (bf16 operands, fp32 accumulation; P, dO and dS
rounded to bf16 before their products), fp32 inputs the CUDA-core kernels
in fp32.  Neither is a fallback for the other: a kernel that fails to
build or launch raises.
The kernels tile by their own compile-time sizes (64 q rows and 64 keys;
32-key tiles for bf16 ``chunk_fwd`` and 32-row tiles for fp32 at head_dim
256) and mask ragged tails; the plain versions do not tile; all compute
the same function, to fp32 rounding (bf16 rounding at those points for
the tensor-core kernels).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.online_softmax import SoftmaxState, finalize, lse
from repro_torch.kernels import on_card
from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention import ref as _ref


def chunk_fwd(q, k, v, carry=None, *, causal=True, window=0, q_offset=0, k_offset=0,
              sm_scale=None):
    """Online-softmax state ``(acc, m, l)`` of q (at q_offset) over k/v (at
    k_offset), continuing ``carry``.  q [b, hq, sq, d], k/v [b, hkv, sk, d]."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, k_offset=k_offset,
              sm_scale=sm_scale)
    if on_card("flash-attention", q, k, v, *(carry or ())):
        return _k.flash_fwd(q, k, v, carry, **kw)
    st = _ref.attend_chunk(q, k, v, carry=SoftmaxState(*carry) if carry is not None else None,
                           **kw)
    return tuple(st)


def chunk_bwd_dq(q, k, v, do, L, delta, *, causal=True, window=0, q_offset=0, k_offset=0,
                 sm_scale=None):
    """dq [b, hq, sq, d] fp32 of one pair; do fp32 [b, hq, sq, d], L and
    delta fp32 [b, hq, sq]."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, k_offset=k_offset,
              sm_scale=sm_scale)
    if on_card("flash-attention", q, k, v, do, L, delta):
        return _k.flash_bwd_dq(q, k, v, do, L, delta, **kw)
    return _ref.chunk_bwd_dq(q, k, v, do, L, delta, **kw)


def chunk_bwd_dkv(q, k, v, do, L, delta, *, causal=True, window=0, q_offset=0, k_offset=0,
                  sm_scale=None):
    """(dk, dv) [b, hkv, sk, d] fp32 of one pair, summed over each kv group."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, k_offset=k_offset,
              sm_scale=sm_scale)
    if on_card("flash-attention", q, k, v, do, L, delta):
        return _k.flash_bwd_dkv(q, k, v, do, L, delta, **kw)
    return _ref.chunk_bwd_dkv(q, k, v, do, L, delta, **kw)


class _FlashAttention(torch.autograd.Function):
    """Forward through chunk_fwd; backward through chunk_bwd_dq/dkv from the
    saved (q, k, v, o, L), as the JAX package's ``_make_flash``."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        st = SoftmaxState(*chunk_fwd(q, k, v, **kw))
        o = finalize(st)  # fp32
        ctx.kw = kw
        ctx.save_for_backward(q, k, v, o, lse(st))
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, L = ctx.saved_tensors
        dof = do.float().contiguous()
        delta = (dof * o).sum(-1)
        dq = chunk_bwd_dq(q, k, v, dof, L, delta, **ctx.kw)
        dk, dv = chunk_bwd_dkv(q, k, v, dof, L, delta, **ctx.kw)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def flash_attention(q, k, v, *, causal=True, window=0, sm_scale: Optional[float] = None):
    """Attention [b, h, s, d] (GQA-aware) in q's dtype, differentiable
    through the backward kernels."""
    return _FlashAttention.apply(q, k, v, dict(causal=causal, window=window,
                                               sm_scale=sm_scale))
