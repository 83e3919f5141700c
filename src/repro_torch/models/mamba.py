"""Pieces of the Mamba family that other blocks share.

Only ``causal_conv1d`` is ported so far: the RG-LRU block runs its input
through it.  The Mamba-1 mixer itself (selective scan over the
``linear_scan`` kernel) comes with its own slice.
"""
from __future__ import annotations

from typing import Optional

import torch


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x [b, s, c]; w [k, c].  Returns (y, new_state).

    ``state`` is the last k-1 inputs of the previous chunk ([b, k-1, c]),
    the FPDT chunk handoff for the conv; zeros when None."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return y + b, new_state
