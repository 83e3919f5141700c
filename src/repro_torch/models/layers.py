"""Common model layers: norms, RoPE, the sinusoidal table, attention
projections, MLP.

Plain functions over explicit parameter dicts, in the JAX package's
layouts (``x @ w`` with ``w [d_in, d_out]``), so converted parameters drop
in unchanged.  Initialisers take a ``torch.Generator`` and a device.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig

Params = Dict[str, Any]


def _dense_init(gen: torch.Generator, shape, dtype, device, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (w / math.sqrt(fan_in)).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, dtype, device) -> Params:
    if cfg.norm == "layernorm":
        return {"w": torch.ones(cfg.d_model, dtype=dtype, device=device),
                "b": torch.zeros(cfg.d_model, dtype=dtype, device=device)}
    return {"w": torch.ones(cfg.d_model, dtype=dtype, device=device)}


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        return (y * p["w"].float() + p["b"].float()).to(x.dtype)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + 1e-6)
    return (y * p["w"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [b, s, h, d]; positions: [s] or [b, s] global token positions."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # [d/2]
    ang = positions.float()[..., None] * freqs  # [..., s, d/2]
    if ang.dim() == 2:  # [s, d/2] -> broadcast over batch
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]  # [b, s, 1, d/2]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos_emb(seq_len, d_model: int, offset: int = 0, device=None) -> torch.Tensor:
    """The fp32 sinusoidal table: sin on the even columns, cos on the odd
    ones, at positions ``offset .. offset + seq_len - 1`` -> [seq_len,
    d_model]; ``seq_len`` may instead be a tensor of positions of any shape
    [...] (a decode step's per-row positions, a rank's global positions
    under a mesh) -> [..., d_model]."""
    if isinstance(seq_len, torch.Tensor):
        pos, device = seq_len.float(), seq_len.device
    else:
        pos = torch.arange(offset, offset + seq_len, dtype=torch.float32, device=device)
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
    ang = pos[..., None] / torch.pow(torch.tensor(10000.0, device=device), dim / d_model)
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(*pos.shape, d_model)


# ---------------------------------------------------------------------------
# Attention projections
# ---------------------------------------------------------------------------


def init_attn(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> Params:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": _dense_init(gen, (d, qd), dtype, device),
        "wk": _dense_init(gen, (d, kvd), dtype, device),
        "wv": _dense_init(gen, (d, kvd), dtype, device),
        "wo": _dense_init(gen, (qd, d), dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(qd, dtype=dtype, device=device)
        p["bk"] = torch.zeros(kvd, dtype=dtype, device=device)
        p["bv"] = torch.zeros(kvd, dtype=dtype, device=device)
    return p


def qkv_proj(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """x [b,s,d] -> q [b,s,hq,dh], k,v [b,s,hkv,dh]."""
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


# ---------------------------------------------------------------------------
# MLP, chunked along the sequence per the paper §5.4
# ---------------------------------------------------------------------------


def init_mlp(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp_act == "swiglu":
        return {
            "wg": _dense_init(gen, (d, ff), dtype, device),
            "wu": _dense_init(gen, (d, ff), dtype, device),
            "wd": _dense_init(gen, (ff, d), dtype, device),
        }
    return {"wu": _dense_init(gen, (d, ff), dtype, device),
            "wd": _dense_init(gen, (ff, d), dtype, device)}


def mlp_block(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_act == "swiglu":
        return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    return F.gelu(x @ p["wu"], approximate="tanh") @ p["wd"]  # jax.nn.gelu's default


def _mlp_chunk(cfg: ModelConfig, names, x: torch.Tensor, *ws) -> torch.Tensor:
    return mlp_block(cfg, dict(zip(names, ws)), x)


def mlp_chunked(cfg: ModelConfig, p: Params, x: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """Paper §5.4: the token-wise MLP over ``n_chunks`` sequence chunks, so
    the d_ff-wide intermediate is bounded by one chunk.  When grad is
    enabled each chunk is checkpointed (non-reentrant) and recomputed in the
    backward, as the JAX package's ``jax.checkpoint`` scan does; under
    no_grad (serving) there is nothing to recompute.  The weights reach the
    checkpoint as tensor arguments: a surrounding checkpoint's first pass
    (remat full) then discards its references to them, where a dict would
    keep them, and with them a layer's gathered ZeRO-3 weights, until the
    backward."""
    if n_chunks <= 1 or x.shape[1] % n_chunks != 0:
        return mlp_block(cfg, p, x)
    if not torch.is_grad_enabled():
        return torch.cat([mlp_block(cfg, p, xc) for xc in x.chunk(n_chunks, dim=1)], dim=1)
    names = tuple(p)
    return torch.cat([checkpoint(_mlp_chunk, cfg, names, xc, *p.values(), use_reentrant=False,
                                 preserve_rng_state=False)
                      for xc in x.chunk(n_chunks, dim=1)], dim=1)
