"""RG-LRU recurrent block (recurrentgemma-9b), over the ``linear_scan`` op.

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
a_t = exp(-c * softplus(Lambda) * sigmoid(r_t)),  c = 8
with per-channel input gate i_t and recurrence gate r_t.  The recurrence
runs through ``kernels/linear_scan/ops.py`` (the hand-written CUDA kernel
on the card); ``rglru_decode_step`` takes one token at a time.

Sequence-parallel (a ``ParallelContext`` with sp > 1) the mixer stays
sequence-sharded in FPDT's chunk-interleaved layout and runs the JAX
package's ``dist_linear_scan`` over the n = u*sp spans (u =
``cfg.fpdt_chunks``; span (i, m) of rank m is g = i*sp + m in global
order), as ``models/mamba.py`` describes: the conv takes its d_conv - 1
token halo from the span before (``causal_conv1d_spans``); pass 1 scans
the rank's u spans as b*u rows from zero state and keeps each span's
sum of log a and last h; one gather of those summaries and a prefix
combine in global order give each span's entering state
(``span_entry_states``, the transition exp(sum log a)); pass 2 rescans
each span from it through the op's h0.  The new state is the global last
span's.  ``rglru_chunk_step`` (chunked prefill) is not yet ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.core.parallel import ParallelContext
from repro_torch.kernels.linear_scan import ops as scan_ops
from repro_torch.models.layers import _dense_init
from repro_torch.models.mamba import (_conv, _softplus, _spans, causal_conv1d, sharded,
                                      span_entry_states)

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
    """(a, gated input, log a) of the recurrence, fp32 [b, s, di]."""
    r = torch.sigmoid((x @ p["w_a"]).float() + p["b_a"])
    i = torch.sigmoid((x @ p["w_i"]).float() + p["b_i"])
    log_a = -C_FACTOR * _softplus(p["lam"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * x.float())
    return a, gated, log_a


def span_summaries(a, b, log_a, u: int) -> torch.Tensor:
    """Pass 1 of ``dist_linear_scan``: each of this rank's u spans (a, b,
    log a [bsz, u*c, ch] fp32) scanned as one row from zero state.  Returns
    [bsz, u, 2*ch] fp32: each span's sum of log a, then its last h."""
    h_loc = scan_ops.linear_scan(_spans(a, u), _spans(b, u))[:, -1]  # [bsz*u, ch]
    return torch.cat([_spans(log_a, u).sum(1), h_loc], dim=-1).reshape(a.shape[0], u, -1)


def dist_linear_scan(a, b, log_a, h0, par: ParallelContext, u: int):
    """The two-pass sequence-parallel linear scan over this rank's u spans
    (a, b, log a [bsz, u*c, ch] fp32; h0 [bsz, ch] or None): pass 1
    (``span_summaries``), the summaries' prefix combine
    (``span_entry_states``; a span's transition exp(sum log a)), pass 2
    from each span's entering state.  Returns (h [bsz, u*c, ch] fp32 of
    this rank's tokens, the state after the global last span [bsz, ch])."""
    bsz, s, ch = a.shape
    h_in, h_last = span_entry_states(par, span_summaries(a, b, log_a, u), ch, torch.exp, h0)
    h = scan_ops.linear_scan(_spans(a, u), _spans(b, u), h_in.reshape(bsz * u, ch))
    return h.reshape(bsz, s, ch), h_last


def rglru_mixer(cfg: ModelConfig, p: Params, x: torch.Tensor,
                state: Optional[dict] = None, par: Optional[ParallelContext] = None):
    """x [b, s, d] -> (y [b, s, d], new_state {conv, h}); ``state`` carries
    the conv inputs and h across chunks (None: zeros).  Under ``par`` with
    sp > 1, x is this rank's tokens in the chunk-interleaved layout and the
    scan runs in two passes (``dist_linear_scan``); the new state is the
    global sequence's."""
    y = x @ p["w_y"]
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")  # jax.nn.gelu's default
    y, conv_state = _conv(cfg, p, y, state["conv"] if state else None, par)
    a, gated, log_a = _gates(p, y)
    h0 = state["h"] if state else None
    if sharded(par):
        h, h_last = dist_linear_scan(a, gated, log_a, h0, par, cfg.fpdt_chunks)
    else:
        h = scan_ops.linear_scan(a, gated, h0)  # [b, s, di] fp32
        h_last = h[:, -1]
    out = (h.to(x.dtype) * gate) @ p["w_out"]
    return out, {"conv": conv_state, "h": h_last}


def rglru_decode_step(cfg: ModelConfig, p: Params, x: torch.Tensor, state: dict):
    """Single-token decode. x [b, 1, d]; ``state`` {conv, h}.  Returns
    (y [b, 1, d], new_state)."""
    y = x @ p["w_y"]
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    y, conv_state = causal_conv1d(y, p["conv_w"], p["conv_b"], state["conv"])
    a, gated, _ = _gates(p, y)
    h = a[:, 0] * state["h"] + gated[:, 0]
    out = (h[:, None].to(x.dtype) * gate) @ p["w_out"]
    return out, {"conv": conv_state, "h": h}
