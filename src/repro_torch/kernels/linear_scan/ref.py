"""Plain PyTorch versions of the linear scan: h_t = a_t * h_{t-1} + b_t.

Elementwise over channels, with initial state h0.  Shapes: a, b
[batch, seq, chan]; h0 [batch, chan] or None (zeros).  ``linear_scan``
returns every inclusive state [batch, seq, chan] in fp32: a loop over the
sequence, for the CPU path, the tests and ``chip_smoke.py``'s comparison
with the CUDA kernel.  ``linear_scan_bwd`` is the backward of it, the
chain the fused CUDA backward replaces.  ``linear_scan_naive`` is the same
recurrence in float64 numpy, for tiny tests.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    bsz, seq, chan = a.shape
    h = (torch.zeros((bsz, chan), dtype=torch.float32, device=a.device) if h0 is None
         else h0.float())
    af, bf = a.float(), b.float()
    hs = []
    for t in range(seq):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def _reverse_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return linear_scan(a.flip(1), b.flip(1)).flip(1)


def linear_scan_bwd(a: torch.Tensor, h: torch.Tensor, h0: Optional[torch.Tensor],
                    dout: torch.Tensor, b_dtype: torch.dtype,
                    reverse_scan: Callable = _reverse_scan):
    """(da, db, dh0) of h = linear_scan(a, b, h0) given dL/dh = dout: the
    adjoint scan g_t = dout_t + a_{t+1} g_{t+1} (a_seq = 1) run from the
    last step to the first by ``reverse_scan(a, b)`` (the plain loop; the
    card's checks pass the CUDA kernel's reverse mode to build the unfused
    chain), then db = g in ``b_dtype``, da = g h_{t-1} (h_{-1} = h0, or 0)
    in a's dtype, dh0 = a_0 g_0 in h0's (None without h0)."""
    af = a.float()
    a_next = torch.cat([af[:, 1:], torch.ones_like(af[:, :1])], dim=1)
    g = reverse_scan(a_next, dout.float())
    first = h0.float()[:, None] if h0 is not None else torch.zeros_like(h[:, :1])
    h_prev = torch.cat([first, h[:, :-1]], dim=1)
    da = (g * h_prev).to(a.dtype)
    db = g.to(b_dtype)
    dh0 = (af[:, 0] * g[:, 0]).to(h0.dtype) if h0 is not None else None
    return da, db, dh0


def linear_scan_naive(a, b, h0=None) -> np.ndarray:
    """Python-loop recurrence in float64 numpy (tiny tests only)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    bsz, seq, chan = a.shape
    h = np.zeros((bsz, chan)) if h0 is None else np.asarray(h0, np.float64).copy()
    out = np.zeros_like(a)
    for t in range(seq):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out
