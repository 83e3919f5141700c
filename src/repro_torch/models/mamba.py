"""Mamba-1 selective SSM mixer (falcon-mamba-7b), over the ``linear_scan`` op.

h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t,  y_t = <h_t, C_t> + D x_t
per channel of d_inner, with a d_state-wide state.  As in the JAX package
the O(b s d_inner d_state) discretised transition is never held for the
whole sequence: ``selective_scan`` walks 256-token blocks, forms a and b
of one block, and carries the [b, d_inner, d_state] state between blocks.
Within a block the recurrence runs through
``kernels/linear_scan/ops.linear_scan`` over d_inner * d_state channels
(the hand-written CUDA kernel on the card), with the carry as its h0.
Each block is a non-reentrant checkpoint, as the reference's block step is
a ``jax.checkpoint``, so a backward keeps only the carries between blocks.
Single device only: the sequence-parallel ``selective_scan_dist`` comes
with the distribution slice, and ``mamba_chunk_step`` with chunked prefill.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig
from repro_torch.kernels.linear_scan import ops as scan_ops
from repro_torch.models.layers import _dense_init

Params = Dict[str, Any]

BLOCK_S = 256  # tokens of one block of ``selective_scan``, as in the JAX package


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) = logaddexp(x, 0) everywhere
    (``F.softplus`` turns linear above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_mamba(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> Params:
    """Random parameters from ``gen``, in the JAX package's layout and
    scales; b_dt, A_log and D stay fp32 whatever ``dtype`` is."""
    d, di, ds, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_actual
    u = torch.rand((di,), generator=gen, device=device)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        "w_in": _dense_init(gen, (d, 2 * di), dtype, device),
        "conv_w": _dense_init(gen, (cfg.d_conv, di), dtype, device, fan_in=cfg.d_conv),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "w_x": _dense_init(gen, (di, dtr + 2 * ds), dtype, device),
        "w_dt": _dense_init(gen, (dtr, di), dtype, device),
        # softplus^-1(dt_init)
        "b_dt": torch.log(torch.expm1(dt_init)).float(),
        "A_log": torch.log(torch.arange(1, ds + 1, dtype=torch.float32, device=device)
                           ).repeat(di, 1),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "w_out": _dense_init(gen, (di, d), dtype, device),
    }


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


def _scan_block(x, dt, B, C, A, h):
    """One block of the selective scan, all fp32: x, dt [b, bs, di]; B, C
    [b, bs, ds]; A [di, ds]; h [b, di, ds] the carry.  Returns (y [b, bs,
    di], the block's last state [b, di, ds])."""
    b, bs, di = x.shape
    ds = A.shape[1]
    a = torch.exp(dt[..., None] * A)  # [b, bs, di, ds]
    bb = (dt * x)[..., None] * B[:, :, None, :]
    hs = scan_ops.linear_scan(a.reshape(b, bs, di * ds), bb.reshape(b, bs, di * ds),
                              h.reshape(b, di * ds)).reshape(b, bs, di, ds)
    y = torch.einsum("bsdn,bsn->bsd", hs, C)
    # a copy: a view would keep the block's whole hs alive as the next
    # block's saved input
    return y, hs[:, -1].clone()


def selective_scan(xc: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xc, dt [b, s, di] (dt post-softplus); A_log [di, ds]; B, C [b, s, ds];
    h0 [b, di, ds] or None (zeros).  Returns (y [b, s, di] fp32, h_last
    [b, di, ds] fp32).  ``min(BLOCK_S, s)`` must divide s (ValueError)."""
    b, s, di = xc.shape
    ds = A_log.shape[1]
    A = -torch.exp(A_log.float())
    h = (torch.zeros((b, di, ds), dtype=torch.float32, device=xc.device) if h0 is None
         else h0.float())
    block_s = min(BLOCK_S, s)
    if s % block_s:
        raise ValueError(f"the selective scan's block of {block_s} tokens must divide the "
                         f"sequence length {s}")
    # split, not sliced: a slice's backward fills a zero tensor of the
    # whole sequence for every block, split's backward concatenates once
    blocks = zip(*(t.float().split(block_s, dim=1) for t in (xc, dt, B, C)))
    ys = []
    for xj, dtj, Bj, Cj in blocks:
        # under no_grad (serving) the checkpoint runs the block once and saves nothing
        y, h = checkpoint(_scan_block, xj, dtj, Bj, Cj, A, h, use_reentrant=False,
                          preserve_rng_state=False)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _in_proj(cfg: ModelConfig, p: Params, x: torch.Tensor, conv_state):
    """The mixer up to the scan: (xc after conv and silu, z, conv state, dt
    fp32, B, C)."""
    dtr, ds = cfg.dt_rank_actual, cfg.ssm_state
    xc, z = (x @ p["w_in"]).chunk(2, dim=-1)
    xc, conv_state = causal_conv1d(xc, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)
    dbc = xc @ p["w_x"]
    dt = _softplus(dbc[..., :dtr] @ p["w_dt"] + p["b_dt"])
    return xc, z, conv_state, dt, dbc[..., dtr:dtr + ds], dbc[..., dtr + ds:]


def mamba_mixer(cfg: ModelConfig, p: Params, x: torch.Tensor,
                state: Optional[dict] = None, n_shards: int = 1):
    """x [b, s, d] -> (y [b, s, d], new_state {conv [b, k-1, di], ssm [b, di,
    ds] fp32}); ``state`` carries them in (None: zeros)."""
    if n_shards > 1:
        raise NotImplementedError("the sequence-parallel selective scan (selective_scan_dist) "
                                  "is not yet ported (distribution slice)")
    xc, z, conv_state, dt, B, C = _in_proj(cfg, p, x, state["conv"] if state else None)
    y, h_last = selective_scan(xc, dt, p["A_log"], B, C, state["ssm"] if state else None)
    y = y + p["D"] * xc.float()
    out = (y.to(x.dtype) * F.silu(z)) @ p["w_out"]
    return out, {"conv": conv_state, "ssm": h_last}


def mamba_decode_step(cfg: ModelConfig, p: Params, x: torch.Tensor, state: dict):
    """Single-token decode. x [b, 1, d]; ``state`` {conv, ssm}.  Returns
    (y [b, 1, d], new_state); the casts are the reference's, dt * xc
    included."""
    xc, z, conv_state, dt, B, C = _in_proj(cfg, p, x, state["conv"])
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt[:, 0, :, None].float() * A)  # [b, di, ds]
    bb = (dt * xc)[:, 0, :, None].float() * B[:, 0, None, :].float()
    h = a * state["ssm"] + bb
    y = torch.einsum("bdn,bn->bd", h, C[:, 0].float()) + p["D"] * xc[:, 0].float()
    y = y[:, None].to(x.dtype) * F.silu(z)
    return y @ p["w_out"], {"conv": conv_state, "ssm": h}
