"""Plain reference of a Mamba-1 language model (the configuration's
``family`` "ssm"): pre-norm residual blocks of the selective SSM mixer,
a final RMSNorm, an untied output head, mean next-token cross-entropy.

The mixer (Gu and Dao, arXiv:2312.00752, Algorithm 2): x, z = x W_in;
x <- silu(causal depthwise conv(x)); (dt_r, B, C) = x W_x;
dt = softplus(dt_r W_dt + b_dt); per channel and state
h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t, A = -exp(A_log);
y_t = <h_t, C_t> + D x_t; out = (y * silu(z)) W_out.
Departure from Falcon-Mamba, as the configuration states it: no RMSNorm
of B, C and dt inside the mixer.  The recurrence runs in blocks of
``BLOCK`` tokens, each recomputed in the backward, and within a block one
step at a time.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from bench.reference import common as C

BLOCK = 512  # tokens of one block of the scan


def _scan_part(x, dt, B, Cm, A, h):
    """One block: x, dt [b, L, di]; B, C [b, L, ds]; A [di, ds]; h [b, di,
    ds].  Returns (y [b, L, di], the block's last state)."""
    a = torch.exp(dt[..., None] * A)
    bb = (dt * x)[..., None] * B[:, :, None, :]
    hs = C.LinearScan.apply(a, bb, h)
    return torch.einsum("bldn,bln->bld", hs, Cm), hs[:, -1]


def selective_scan(x, dt, A, B, Cm):
    h = x.new_zeros((x.shape[0], x.shape[2], A.shape[1]))
    ys = []
    for i in range(0, x.shape[1], BLOCK):
        sl = slice(i, i + BLOCK)
        y, h = checkpoint(_scan_part, x[:, sl], dt[:, sl], B[:, sl], Cm[:, sl], A, h,
                          use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, 1)


def _layer(m: dict, prec: C.Prec, x, norm_w, w_in, conv_w, conv_b, w_x, w_dt, b_dt, A_log, D,
           w_out):
    di, ds = m["expand"] * m["d_model"], m["ssm_state"]
    dtr = m["dt_rank"] or -(-m["d_model"] // 16)
    k = conv_w.shape[0]
    hn = C.rmsnorm(x, norm_w)
    xi, z = prec.mm(hn, w_in).split(di, -1)
    xp = torch.cat([xi.new_zeros((xi.shape[0], k - 1, di)), xi], 1)
    xc = sum(xp[:, j:j + xi.shape[1]] * conv_w[j] for j in range(k)) + conv_b
    xc = C.silu(xc)
    dbc = prec.mm(xc, w_x)
    dt = C.softplus(prec.mm(dbc[..., :dtr], w_dt) + b_dt)
    y = selective_scan(xc, dt, -torch.exp(A_log), dbc[..., dtr:dtr + ds], dbc[..., dtr + ds:])
    y = y + D * xc
    return x + prec.mm(y * C.silu(z), w_out)


NAMES = ("norm.w", "mixer.w_in", "mixer.conv_w", "mixer.conv_b", "mixer.w_x", "mixer.w_dt",
         "mixer.b_dt", "mixer.A_log", "mixer.D", "mixer.w_out")


def loss(m: dict, params: dict, batch: dict, prec: C.Prec):
    """Mean cross-entropy of ``batch`` {"tokens", "labels"} [b, s]."""
    if m.get("tie_embeddings"):
        raise NotImplementedError("the Mamba reference has an untied head")
    x = params["embed"][batch["tokens"].long()]
    for c in range(m["num_layers"]):
        ws = [params[f"cycles.{c}.pos0.{n}"] for n in NAMES]
        x = checkpoint(_layer, m, prec, x, *ws, use_reentrant=False)
    h = C.rmsnorm(x, params["final_norm.w"])
    return C.mean_nll(h.reshape(-1, h.shape[-1]), params["head"],
                      batch["labels"].reshape(-1).long(), prec)
