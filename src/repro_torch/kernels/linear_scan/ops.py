"""The linear scan h_t = a_t h_{t-1} + b_t as a differentiable op.

``linear_scan`` is a ``torch.autograd.Function``, the JAX package's
``custom_vjp``: the forward keeps (a, h, h0), and the adjoint of a linear
scan is another linear scan run in reverse,
  g_t = dL/dh_t (total) = dout_t + a_{t+1} g_{t+1}
  db_t = g_t;  da_t = g_t * h_{t-1};  dh0 = a_0 * g_0.
On the card the backward is one fused kernel (``kernel.linear_scan_bwd``),
which reads a shifted and h_{t-1} by index; on the CPU it is the plain
chain (``ref.linear_scan_bwd``).

The implementation is picked by the tensors' device alone: the
hand-written CUDA kernels (``kernel.py``) for CUDA tensors, the plain
PyTorch versions (``ref.py``) for CPU tensors; mixed or other devices raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import on_card
from repro_torch.kernels.linear_scan import kernel as _k
from repro_torch.kernels.linear_scan import ref as _ref


def scan(a, b, h0=None, *, reverse: bool = False) -> torch.Tensor:
    """Every inclusive state, fp32 (no autograd).  ``reverse`` runs the
    recurrence from the last step to the first: h_t = a_t h_{t+1} + b_t."""
    if on_card("linear-scan", a, b, h0):
        return _k.linear_scan(a.contiguous(), b.contiguous(),
                              None if h0 is None else h0.float().contiguous(), reverse=reverse)
    if reverse:
        return _ref.linear_scan(a.flip(1), b.flip(1), h0).flip(1)
    return _ref.linear_scan(a, b, h0)


class _LinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, h0):
        h = scan(a, b, h0)
        ctx.b_dtype = b.dtype
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dout):
        a, h, h0 = ctx.saved_tensors
        if not on_card("linear-scan", a, h, h0, dout):
            return _ref.linear_scan_bwd(a, h, h0, dout, ctx.b_dtype)
        da, db, dh0 = _k.linear_scan_bwd(a.contiguous(), h,
                                         None if h0 is None else h0.float().contiguous(),
                                         dout.float().contiguous(), ctx.b_dtype)
        return da, db, None if h0 is None else dh0.to(h0.dtype)


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable inclusive linear scan h_t = a_t h_{t-1} + b_t.
    a, b [batch, seq, chan]; h0 [batch, chan] or None (zeros).  fp32 out."""
    return _LinearScan.apply(a, b, h0)
