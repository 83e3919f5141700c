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

Sequence-parallel (a ``ParallelContext`` with sp > 1), in FPDT's
chunk-interleaved layout (``core/parallel.py``): model rank m holds span
(i, m) of each of the u = ``cfg.fpdt_chunks`` chunks, span g = i*sp + m of
n = u*sp in global order.  The mixer stays sequence-sharded, and is the
JAX package's two-pass ``selective_scan_dist`` over those n spans:
  * conv halo: span g's causal conv needs the last d_conv - 1 inputs of
    span g - 1 (rank m - 1's span i, or for m = 0 rank sp - 1's span
    i - 1).  One ``gather_spans`` of every rank's [b, u, k-1, di] tails (in
    x's dtype; its backward a reduce-scatter) hands each span its halo,
    and the conv runs per span (``causal_conv1d_spans``);
  * pass 1: the rank scans its u spans at once, b*u rows, from zero state
    (``selective_scan`` with its 256-token blocks inside each span), and
    keeps each span's sum of dt and last state;
  * one ``gather_spans`` of those fp32 summaries; every rank forms each
    span's transition exp(sum(dt) A), prefix-combines the n spans in
    global order, folds in a given h0 and takes the state entering each of
    its own spans (``span_entry_states``);
  * pass 2: each span is scanned again from its entering state (the
    ``linear_scan`` op's h0, whose gradient the op returns).
The new state is the global last span's, on every rank.  ``mamba_chunk_step``
(chunked prefill) is not yet ported.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig
from repro_torch.core import parallel as P
from repro_torch.core.parallel import ParallelContext
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


def causal_conv1d_spans(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        state: Optional[torch.Tensor], par: ParallelContext, u: int):
    """``causal_conv1d`` of a sequence-parallel rank's u spans (x [b, u*c,
    ch], span i at tokens [i*c, (i+1)*c)), each span's halo the last k-1
    inputs of the span before it in global order (``gather_spans`` of every
    rank's tails); the first global span's is ``state`` (None: zeros).
    Returns (y, the global sequence's last k-1 inputs [b, k-1, ch])."""
    k = w.shape[0]
    bsz, s, ch = x.shape
    c = s // u
    if c < k - 1:
        raise ValueError(f"a span of {c} tokens is shorter than the conv's halo of {k - 1}: "
                         f"each of the {u} chunks needs at least {k - 1} tokens a rank")
    xs = x.reshape(bsz, u, c, ch)
    tails = P.gather_spans(xs[:, :, c - (k - 1):], par.sp_group)  # [b, u*sp, k-1, ch]
    first = (x.new_zeros((bsz, 1, k - 1, ch)) if state is None
             else state.to(x.dtype)[:, None])
    halo = torch.cat([first, tails[:, :-1]], dim=1)[:, par.sp_rank::par.sp]  # [b, u, k-1, ch]
    y, _ = causal_conv1d(xs.reshape(bsz * u, c, ch), w, b, halo.reshape(bsz * u, k - 1, ch))
    return y.reshape(bsz, s, ch), tails[:, -1]


def span_entry_states(par: ParallelContext, summary: torch.Tensor, n_last: int, transition,
                      h0: Optional[torch.Tensor]):
    """The prefix combine of a two-pass scan.  ``summary`` [b, u, f] fp32
    holds, per span of this rank, f - n_last numbers that ``transition``
    turns into the span's transition and its n_last-wide last state from
    zero (flattened).  One ``gather_spans`` puts every rank's spans in
    global order; the states are combined in that order from h0 (None:
    zeros).  Returns (the state entering each of this rank's u spans [b,
    u, *shape], the state after the global last span [b, *shape]), shape
    that of the transition."""
    every = P.gather_spans(summary, par.sp_group)  # [b, n, f]
    A = transition(every[..., :-n_last])  # [b, n, *shape]
    H = every[..., -n_last:].reshape(A.shape)
    h = torch.zeros_like(A[:, 0]) if h0 is None else h0.float()
    entering = []
    for g in range(A.shape[1]):
        entering.append(h)
        h = A[:, g] * h + H[:, g]
    return torch.stack(entering, dim=1)[:, par.sp_rank::par.sp], h


def _scan_block(x, dt, B, C, A, h):
    """One block of the selective scan, all fp32: x, dt [b, bs, di]; B, C
    [b, bs, ds] (C None: no output); A [di, ds]; h [b, di, ds] the carry.
    Returns (y [b, bs, di] or None, the block's last state [b, di, ds])."""
    b, bs, di = x.shape
    ds = A.shape[1]
    a = torch.exp(dt[..., None] * A)  # [b, bs, di, ds]
    bb = (dt * x)[..., None] * B[:, :, None, :]
    hs = scan_ops.linear_scan(a.reshape(b, bs, di * ds), bb.reshape(b, bs, di * ds),
                              h.reshape(b, di * ds)).reshape(b, bs, di, ds)
    y = None if C is None else torch.einsum("bsdn,bsn->bsd", hs, C)
    # a copy: a view would keep the block's whole hs alive as the next
    # block's saved input
    return y, hs[:, -1].clone()


def selective_scan(xc: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                   B: torch.Tensor, C: Optional[torch.Tensor],
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """xc, dt [b, s, di] (dt post-softplus); A_log [di, ds]; B, C [b, s, ds];
    h0 [b, di, ds] or None (zeros).  Returns (y [b, s, di] fp32, h_last
    [b, di, ds] fp32); with C None, y is None (the last state alone).
    ``min(BLOCK_S, s)`` must divide s (ValueError)."""
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
    parts = [t.float().split(block_s, dim=1) for t in (xc, dt, B)]
    parts.append([None] * len(parts[0]) if C is None else C.float().split(block_s, dim=1))
    ys = []
    for xj, dtj, Bj, Cj in zip(*parts):
        # under no_grad (serving) the checkpoint runs the block once and saves nothing
        y, h = checkpoint(_scan_block, xj, dtj, Bj, Cj, A, h, use_reentrant=False,
                          preserve_rng_state=False)
        ys.append(y)
    return (None if C is None else torch.cat(ys, dim=1)), h


def _spans(t: torch.Tensor, u: int) -> torch.Tensor:
    """[b, u*c, f] -> [b*u, c, f]: one row a span."""
    b, s, f = t.shape
    return t.reshape(b * u, s // u, f)


def span_summaries(xc, dt, A_log, B, u: int) -> torch.Tensor:
    """Pass 1 of ``selective_scan_dist``: each of this rank's u spans (xc,
    dt [b, u*c, di]; B [b, u*c, ds]) scanned as one row from zero state,
    in ``selective_scan``'s blocks.  Returns [b, u, di + di*ds] fp32: each
    span's sum of dt, then its last state flattened."""
    b, di = xc.shape[0], xc.shape[2]
    dts = _spans(dt, u)
    _, h_loc = selective_scan(_spans(xc, u), dts, A_log, _spans(B, u), None)  # [b*u, di, ds]
    return torch.cat([dts.float().sum(1), h_loc.reshape(b * u, -1)], dim=-1).reshape(b, u, -1)


def selective_scan_dist(xc, dt, A_log, B, C, h0, par: ParallelContext, u: int):
    """The two-pass sequence-parallel ``selective_scan`` over this rank's u
    spans (xc, dt [b, u*c, di]; B, C [b, u*c, ds]; h0 [b, di, ds] or None):
    pass 1 (``span_summaries``), the summaries' prefix combine
    (``span_entry_states``; a span's transition exp(sum(dt) A)), pass 2
    from each span's entering state.  Returns (y [b, u*c, di] fp32 of this
    rank's tokens, the state after the global last span [b, di, ds] fp32)."""
    b, s, di = xc.shape
    ds = A_log.shape[1]
    A = -torch.exp(A_log.float())
    h_in, h_last = span_entry_states(par, span_summaries(xc, dt, A_log, B, u), di * ds,
                                     lambda sum_dt: torch.exp(sum_dt[..., None] * A), h0)
    y, _ = selective_scan(_spans(xc, u), _spans(dt, u), A_log, _spans(B, u), _spans(C, u),
                          h_in.reshape(b * u, di, ds))
    return y.reshape(b, s, di), h_last


def sharded(par: Optional[ParallelContext]) -> bool:
    """Does a mixer run sequence-parallel (two-pass) under ``par``?"""
    return P.distributed(par) and par.sp > 1


def _conv(cfg: ModelConfig, p: Params, x, conv_state, par):
    if sharded(par):
        return causal_conv1d_spans(x, p["conv_w"], p["conv_b"], conv_state, par,
                                   cfg.fpdt_chunks)
    return causal_conv1d(x, p["conv_w"], p["conv_b"], conv_state)


def _in_proj(cfg: ModelConfig, p: Params, x: torch.Tensor, conv_state, par=None):
    """The mixer up to the scan: (xc after conv and silu, z, conv state, dt
    fp32, B, C)."""
    dtr, ds = cfg.dt_rank_actual, cfg.ssm_state
    xc, z = (x @ p["w_in"]).chunk(2, dim=-1)
    xc, conv_state = _conv(cfg, p, xc, conv_state, par)
    xc = F.silu(xc)
    dbc = xc @ p["w_x"]
    dt = _softplus(dbc[..., :dtr] @ p["w_dt"] + p["b_dt"])
    return xc, z, conv_state, dt, dbc[..., dtr:dtr + ds], dbc[..., dtr + ds:]


def mamba_mixer(cfg: ModelConfig, p: Params, x: torch.Tensor,
                state: Optional[dict] = None, par: Optional[ParallelContext] = None):
    """x [b, s, d] -> (y [b, s, d], new_state {conv [b, k-1, di], ssm [b, di,
    ds] fp32}); ``state`` carries them in (None: zeros).  Under ``par``
    with sp > 1, x is this rank's tokens in the chunk-interleaved layout
    (u = ``cfg.fpdt_chunks``) and the scan runs in two passes
    (``selective_scan_dist``); the new state is the global sequence's."""
    xc, z, conv_state, dt, B, C = _in_proj(cfg, p, x, state["conv"] if state else None, par)
    h0 = state["ssm"] if state else None
    if sharded(par):
        y, h_last = selective_scan_dist(xc, dt, p["A_log"], B, C, h0, par, cfg.fpdt_chunks)
    else:
        y, h_last = selective_scan(xc, dt, p["A_log"], B, C, h0)
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
