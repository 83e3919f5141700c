"""Plain PyTorch versions of the linear scan: h_t = a_t * h_{t-1} + b_t.

Elementwise over channels, with initial state h0.  Shapes: a, b
[batch, seq, chan]; h0 [batch, chan] or None (zeros).  ``linear_scan``
returns every inclusive state [batch, seq, chan] in fp32: a loop over the
sequence, for the CPU path, the tests and ``chip_smoke.py``'s comparison
with the CUDA kernel.  ``linear_scan_naive`` is the same recurrence in
float64 numpy, for tiny tests.
"""
from __future__ import annotations

from typing import Optional

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
