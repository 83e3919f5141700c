"""Online-softmax running statistics and their merge operator.

The FPDT chunk pipeline continues a *single* softmax across sequence chunks:
each chunk's attention produces an unnormalized accumulator ``acc`` together
with running row-max ``m`` and row-sum ``l``.  ``merge`` combines two such
partial states; it is associative and commutative, so any chunk schedule
yields the same result.

State convention (all fp32):
  m:   [..., sq]      running row max of logits
  l:   [..., sq]      running sum of exp(logits - m)
  acc: [..., sq, d]   running sum of exp(logits - m) @ V  (unnormalized)

``finalize(acc, l) = acc / l`` is the attention output.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30  # avoid actual -inf: exp(-inf - -inf) = nan


class SoftmaxState(NamedTuple):
    acc: torch.Tensor  # [..., sq, d] fp32
    m: torch.Tensor  # [..., sq] fp32
    l: torch.Tensor  # [..., sq] fp32


def zero_state(shape_sq_d, device=None, dtype=torch.float32) -> SoftmaxState:
    """Identity element of ``merge``: m=NEG_INF, l=0, acc=0."""
    *lead, sq, d = shape_sq_d
    return SoftmaxState(
        acc=torch.zeros((*lead, sq, d), dtype=dtype, device=device),
        m=torch.full((*lead, sq), NEG_INF, dtype=dtype, device=device),
        l=torch.zeros((*lead, sq), dtype=dtype, device=device),
    )


def zero_state_like(q: torch.Tensor) -> SoftmaxState:
    """Identity state shaped for a query block ``q [..., sq, d]`` (fp32
    whatever q's dtype: the running statistics always accumulate in fp32)."""
    return zero_state(q.shape, device=q.device)


def merge(a: SoftmaxState, b: SoftmaxState) -> SoftmaxState:
    """Associative merge of two partial online-softmax states."""
    m = torch.maximum(a.m, b.m)
    ea = torch.exp(a.m - m)
    eb = torch.exp(b.m - m)
    l = a.l * ea + b.l * eb
    acc = a.acc * ea[..., None] + b.acc * eb[..., None]
    return SoftmaxState(acc=acc, m=m, l=l)


def finalize(state: SoftmaxState, eps: float = 0.0) -> torch.Tensor:
    """Normalized attention output. Rows with l == 0 (fully masked) -> 0."""
    l = state.l
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return state.acc / (safe[..., None] + eps)


def lse(state: SoftmaxState) -> torch.Tensor:
    """Row log-sum-exp (the quantity flash backward needs)."""
    return state.m + torch.log(torch.where(state.l == 0.0, torch.ones_like(state.l), state.l))
