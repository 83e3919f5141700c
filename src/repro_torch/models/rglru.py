"""RG-LRU recurrent block (recurrentgemma-9b), over the ``linear_scan`` op.

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
a_t = exp(-c * softplus(Lambda) * sigmoid(r_t)),  c = 8
with per-channel input gate i_t and recurrence gate r_t.  The recurrence
runs through ``kernels/linear_scan/ops.py`` (the hand-written CUDA kernel
on the card); ``rglru_decode_step`` takes one token at a time.  Single
device only: the sequence-parallel ``dist_linear_scan`` comes with the
distribution slice, and ``rglru_chunk_step`` with chunked prefill.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.kernels.linear_scan import ops as scan_ops
from repro_torch.models.layers import _dense_init
from repro_torch.models.mamba import _softplus, causal_conv1d

Params = Dict[str, Any]
C_FACTOR = 8.0


def init_rglru(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> Params:
    """Random parameters from ``gen``, in the JAX package's layout and
    scales; the gate biases and Lambda stay fp32 whatever ``dtype`` is."""
    d = cfg.d_model
    di = cfg.d_inner  # lru_width (expand=1 for RG-9B -> di == d)
    # Lambda init so a^c in (0.9, 0.999) at r=1
    lo, hi = 0.9 ** 2, 0.999 ** 2
    u = lo + (hi - lo) * torch.rand((di,), generator=gen, device=device)
    lam = torch.log(torch.expm1(-torch.log(u) / (2 * C_FACTOR)))  # softplus^-1
    return {
        "w_y": _dense_init(gen, (d, di), dtype, device),
        "w_gate": _dense_init(gen, (d, di), dtype, device),
        "conv_w": _dense_init(gen, (cfg.d_conv, di), dtype, device, fan_in=cfg.d_conv),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "w_a": _dense_init(gen, (di, di), dtype, device),
        "b_a": torch.zeros((di,), dtype=torch.float32, device=device),
        "w_i": _dense_init(gen, (di, di), dtype, device),
        "b_i": torch.zeros((di,), dtype=torch.float32, device=device),
        "lam": lam.float(),
        "w_out": _dense_init(gen, (di, d), dtype, device),
    }


def _gates(p: Params, x: torch.Tensor):
    """(a, gated input) of the recurrence, fp32 [b, s, di]."""
    r = torch.sigmoid((x @ p["w_a"]).float() + p["b_a"])
    i = torch.sigmoid((x @ p["w_i"]).float() + p["b_i"])
    log_a = -C_FACTOR * _softplus(p["lam"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * x.float())
    return a, gated


def rglru_mixer(cfg: ModelConfig, p: Params, x: torch.Tensor,
                state: Optional[dict] = None, n_shards: int = 1):
    """x [b, s, d] -> (y [b, s, d], new_state {conv, h}); ``state`` carries
    the conv inputs and h across chunks (None: zeros)."""
    if n_shards > 1:
        raise NotImplementedError("the sequence-parallel RG-LRU (dist_linear_scan) is not yet "
                                  "ported (distribution slice)")
    y = x @ p["w_y"]
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")  # jax.nn.gelu's default
    y, conv_state = causal_conv1d(y, p["conv_w"], p["conv_b"],
                                  state["conv"] if state else None)
    a, gated = _gates(p, y)
    h0 = state["h"] if state else None
    h = scan_ops.linear_scan(a, gated, h0)  # [b, s, di] fp32
    out = (h.to(x.dtype) * gate) @ p["w_out"]
    return out, {"conv": conv_state, "h": h[:, -1]}


def rglru_decode_step(cfg: ModelConfig, p: Params, x: torch.Tensor, state: dict):
    """Single-token decode. x [b, 1, d]; ``state`` {conv, h}.  Returns
    (y [b, 1, d], new_state)."""
    y = x @ p["w_y"]
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    y, conv_state = causal_conv1d(y, p["conv_w"], p["conv_b"], state["conv"])
    a, gated = _gates(p, y)
    h = a[:, 0] * state["h"] + gated[:, 0]
    out = (h[:, None].to(x.dtype) * gate) @ p["w_out"]
    return out, {"conv": conv_state, "h": h}
