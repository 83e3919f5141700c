"""Serving path: cache init, prefill, and single-token decode.

Cache layout (stacked over layer cycles C, as in the JAX package):
  attn        {"k","v": [C, b, S, hkv, dh], "kpos": [C, b, S] int32 filled positions}
  local_attn  same with S = window (ring buffer; slot = pos % window)
  rglru       {"conv": [C, b, k-1, di] param dtype, "h": [C, b, di] fp32}
  ssm         {"conv": [C, b, k-1, di] param dtype, "ssm": [C, b, di, ds] fp32}

Decode positions are per-sequence: ``pos`` is a scalar or a ``[b]``
vector, so a batch may hold sequences at different depths.  ``kpos``
entries of ``-1`` mark unfilled or invalid slots, and attention masks on
``kpos`` rather than on slot index, which is what makes position-masked
(padded) prefill exact.

Prefill runs FPDT attention (``core/fpdt.py``), whose chunk pairs go
through the hand-written CUDA ``flash_fwd`` on the card, and the recurrent
mixers over the whole prompt, whose scans go through the CUDA
``linear_scan``; their final states fill the cache.  Decode attention is
gather-then-dense PyTorch, as the JAX package's is jnp, and the recurrent
blocks take one step of their recurrence.  Unlike the JAX functions,
``decode_step`` writes the new token's K/V and every recurrent state into
the cache tensors in place (``copy_`` at fixed shapes, no copy of the cache
per step) and returns the same cache dict.  An MoE model's attention
blocks run the MoE FFN as the JAX package's do: unchunked ``moe_ffn`` in
decode (the batch's b tokens are one group) and ``moe_ffn_chunked`` over
``cfg.mlp_chunks`` in prefill, where a padded prompt's pad tokens route
and take queue places too.  The modality frontends are the JAX package's
stubs: an audio model's prompt and decode steps take frame embeddings
(decode adds the sinusoidal table at each row's position), a vision
model's prompt puts its patch embeddings before its tokens and decodes
tokens.  Host-streamed KV chunks and the paged pool are not yet ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core import fpdt
from repro_torch.core.online_softmax import NEG_INF, SoftmaxState, finalize
from repro_torch.core.parallel import ParallelContext
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as R
from repro_torch.models import transformer as T

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------


def _attn_cache(cfg: ModelConfig, b: int, s: int, dtype, device, lead=()):
    return {
        "k": torch.zeros((*lead, b, s, cfg.num_kv_heads, cfg.head_dim), dtype=dtype, device=device),
        "v": torch.zeros((*lead, b, s, cfg.num_kv_heads, cfg.head_dim), dtype=dtype, device=device),
        "kpos": torch.full((*lead, b, s), -1, dtype=torch.int32, device=device),
    }


def _block_cache(cfg: ModelConfig, kind: str, b: int, max_len: int, dtype, device, lead=()):
    if kind == "attn":
        return _attn_cache(cfg, b, max_len, dtype, device, lead)
    if kind == "local_attn":
        return _attn_cache(cfg, b, min(cfg.window, max_len), dtype, device, lead)
    conv = torch.zeros((*lead, b, cfg.d_conv - 1, cfg.d_inner), dtype=dtype, device=device)
    if kind == "ssm":
        return {"conv": conv, "ssm": torch.zeros((*lead, b, cfg.d_inner, cfg.ssm_state),
                                                 dtype=torch.float32, device=device)}
    if kind == "rglru":
        return {"conv": conv, "h": torch.zeros((*lead, b, cfg.d_inner), dtype=torch.float32,
                                               device=device)}
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, b: int, max_len: int, device="cuda") -> Params:
    dtype = getattr(torch, cfg.param_dtype)
    pat, n_cycles, tail = T.layout_of(cfg)
    cache = {f"pos{i}": _block_cache(cfg, kind, b, max_len, dtype, device, lead=(n_cycles,))
             for i, kind in enumerate(pat)}
    if tail:
        cache["tail"] = [_block_cache(cfg, kind, b, max_len, dtype, device) for kind in tail]
    return cache


# ---------------------------------------------------------------------------
# decode attention (single new token against the cache)
# ---------------------------------------------------------------------------


def _decode_attention(cfg: ModelConfig, par: Optional[ParallelContext], p: Params,
                      x: torch.Tensor, cache: Params, pos: torch.Tensor, *, window: int = 0):
    """x [b, 1, d]; pos int64 [b]; writes the token into ``cache`` in place.
    Returns attn_out [b, 1, d]."""
    b = x.shape[0]
    q, k, v = L.qkv_proj(cfg, p, x)  # [b, 1, h, dh]
    q = L.apply_rope(q, pos[:, None], cfg.rope_theta)
    k = L.apply_rope(k, pos[:, None], cfg.rope_theta)
    ck, cv, kpos = cache["k"], cache["v"], cache["kpos"]
    S = ck.shape[1]
    slot = pos % S if window > 0 else torch.clamp(pos, max=S - 1)  # [b]
    bi = torch.arange(b, device=x.device)
    ck[bi, slot] = k[:, 0].to(ck.dtype)
    cv[bi, slot] = v[:, 0].to(cv.dtype)
    kpos[bi, slot] = pos.to(kpos.dtype)

    g = cfg.num_heads // cfg.num_kv_heads
    qf = q[:, 0].float()  # [b, hq, dh]
    ke = ck.float().repeat_interleave(g, dim=2) if g > 1 else ck.float()
    ve = cv.float().repeat_interleave(g, dim=2) if g > 1 else cv.float()
    s = torch.einsum("bhd,bshd->bhs", qf, ke) * cfg.head_dim ** -0.5
    ok = (kpos >= 0) & (kpos <= pos[:, None])
    if window:
        ok = ok & (kpos > (pos - window)[:, None])
    s = torch.where(ok[:, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    pr = torch.where(s <= NEG_INF / 2, torch.zeros_like(s), torch.exp(s - m[..., None]))
    st = SoftmaxState(torch.einsum("bhs,bshd->bhd", pr, ve), m, pr.sum(dim=-1))
    o = finalize(st).reshape(b, 1, cfg.q_dim).to(x.dtype)
    return o @ p["wo"]


def _keep_state(cache: Params, state: Params):
    """Copy a recurrent mixer's new state into its cache tensors in place."""
    for k, v in state.items():
        cache[k].copy_(v)


def _decode_block(cfg, par, kind, p, h, cache, pos):
    if kind == "ssm":
        y, st = M.mamba_decode_step(cfg, p["mixer"], L.apply_norm(cfg, p["norm"], h), cache)
        _keep_state(cache, st)
        return h + y
    hn = L.apply_norm(cfg, p["norm1"], h)
    if kind == "rglru":
        y, st = R.rglru_decode_step(cfg, p["mixer"], hn, cache)
        _keep_state(cache, st)
        h = h + y
    else:
        window = cfg.window if kind == "local_attn" else 0
        h = h + _decode_attention(cfg, par, p["attn"], hn, cache, pos, window=window)
    hn2 = L.apply_norm(cfg, p["norm2"], h)
    if "moe" in p:
        return h + MOE.moe_ffn(cfg, p["moe"], hn2)[0]
    return h + L.mlp_block(cfg, p["mlp"], hn2)


def _positions(pos, b: int, device) -> torch.Tensor:
    return torch.as_tensor(pos, dtype=torch.int64, device=device).expand(b)


@torch.no_grad()
def decode_step(cfg: ModelConfig, par: Optional[ParallelContext], params: Params,
                cache: Params, inp: Dict[str, torch.Tensor], pos):
    """One decode step: advance every sequence in the batch by one token.

    Contract:
      inp    — {"tokens": [b, 1] integer ids} or, for the audio frontend,
               {"frame_embeds": [b, 1, d]}: the frame plus the fp32
               sinusoidal table at each row's position, cast to the
               frame's dtype.
      pos    — scalar or integer [b]: the position each sequence's incoming
               token occupies.  The token is written into its cache slot
               (``kpos[slot] = pos``) and attends to entries with
               ``0 <= kpos <= pos``, so batch rows may sit at different
               depths.
      cache  — dict from ``init_cache``/``prefill_step``, updated in place
               at exactly the ``pos`` slot of every attention layer and in
               every recurrent layer's state.

    Returns (logits [b, padded_vocab] fp32, cache)."""
    if cfg.frontend == "audio_frames":
        h = inp["frame_embeds"]
        pos = _positions(pos, h.shape[0], h.device)
        h = h + L.sinusoidal_pos_emb(pos, cfg.d_model).to(h.dtype)[:, None]
    else:
        tokens = inp["tokens"]
        pos = _positions(pos, tokens.shape[0], tokens.device)
        h = params["embed"][tokens].to(getattr(torch, cfg.param_dtype))
    pat, n_cycles, tail = T.layout_of(cfg)
    for c in range(n_cycles):
        cyc_p, cyc_cache = T.cycle(params["cycles"], c), T.cycle(
            {k: cache[k] for k in cache if k != "tail"}, c)
        for i, kind in enumerate(pat):
            h = _decode_block(cfg, par, kind, cyc_p[f"pos{i}"], h, cyc_cache[f"pos{i}"], pos)
    for i, kind in enumerate(tail):
        h = _decode_block(cfg, par, kind, params["tail"][i], h, cache["tail"][i], pos)
    h = L.apply_norm(cfg, params["final_norm"], h)
    logits = (h[:, 0] @ T.head_matrix(cfg, params)).float()
    return logits, cache


# ---------------------------------------------------------------------------
# prefill: forward + cache population
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill_step(cfg: ModelConfig, par: Optional[ParallelContext], params: Params,
                 batch: Dict[str, torch.Tensor], max_len: int,
                 lengths: Optional[torch.Tensor] = None):
    """Forward over the prompt batch, returning (logits, filled cache).

    Contract:
      batch   — {"tokens": [b, s]} or a frontend's ({"frame_embeds": [b, s,
                d]}; {"patch_embeds": [b, P, d], "tokens": [b, s - P]}, the
                patches first: ``transformer.embed_input``); every row runs
                the full s-length forward.
      max_len — cache capacity (prompt + generation budget); the returned
                cache is ready for ``decode_step`` at ``pos = s`` (or
                ``pos = lengths`` per row).
      lengths — optional integer [b] of true prompt lengths for
                *position-masked* prefill of RIGHT-padded prompts: cache
                entries at positions >= ``lengths[i]`` are marked invalid
                (``kpos = -1``) and row i's logits are taken at position
                ``lengths[i] - 1``.  Exact for global attention only, so
                layouts with a local_attn ring or a recurrent block raise
                ValueError.

    Returns (logits [b, padded_vocab] fp32 at each row's last real token, cache).
    """
    T._check_ported(cfg)
    h = T.embed_input(cfg, params, batch).to(getattr(torch, cfg.param_dtype))
    b, s, _ = h.shape
    device = h.device
    pat, n_cycles, tail = T.layout_of(cfg)
    if lengths is not None:
        bad = {k for k in (*pat, *tail) if k != "attn"}
        if bad:
            raise ValueError(
                f"position-masked prefill (lengths=...) only supports pure "
                f"global-attention layouts; {cfg.name} contains {sorted(bad)} "
                f"blocks whose state integrates pad tokens — prefill those "
                f"at exact length instead")
        lengths = torch.as_tensor(lengths, dtype=torch.int64, device=device)
    if s > max_len:
        raise ValueError(f"prompt length {s} exceeds the cache capacity max_len={max_len}")
    cache = init_cache(cfg, b, max_len, device)

    def fill_kv(kind, pa, hn, bc):
        """Write the prompt's roped k/v (recomputed: cheap beside attention)
        into an attention block's cache."""
        _, k, v = L.qkv_proj(cfg, pa, hn)
        k = L.apply_rope(k, torch.arange(s, device=device), cfg.rope_theta)
        W = bc["k"].shape[1]
        take = min(W, s)
        pvec = torch.arange(s - take, s, device=device)
        # ring slots follow the decode invariant slot = pos % W
        slots = pvec % W if kind == "local_attn" else pvec
        kp = pvec[None].expand(b, take)
        if lengths is not None:  # mask pad-token slots as never-filled
            kp = torch.where(kp < lengths[:, None], kp, torch.full_like(kp, -1))
        bc["k"][:, slots] = k[:, s - take:].to(bc["k"].dtype)
        bc["v"][:, slots] = v[:, s - take:].to(bc["v"].dtype)
        bc["kpos"][:, slots] = kp.to(torch.int32)

    def prefill_block(kind, p, h, bc):
        if kind == "ssm":
            y, st = M.mamba_mixer(cfg, p["mixer"], L.apply_norm(cfg, p["norm"], h))
            _keep_state(bc, st)
            return h + y
        hn = L.apply_norm(cfg, p["norm1"], h)
        if kind == "rglru":
            y, st = R.rglru_mixer(cfg, p["mixer"], hn)
            _keep_state(bc, st)
            h = h + y
        else:
            window = cfg.window if kind == "local_attn" else 0
            o = fpdt.fpdt_attention(cfg, par, p["attn"], hn, window=window)
            h = h + o @ p["attn"]["wo"]
            fill_kv(kind, p["attn"], hn, bc)
        hn2 = L.apply_norm(cfg, p["norm2"], h)
        if "moe" in p:
            return h + MOE.moe_ffn_chunked(cfg, p["moe"], hn2, cfg.mlp_chunks)[0]
        return h + L.mlp_chunked(cfg, p["mlp"], hn2, cfg.mlp_chunks)

    for c in range(n_cycles):
        cyc_p = T.cycle(params["cycles"], c)
        for i, kind in enumerate(pat):
            h = prefill_block(kind, cyc_p[f"pos{i}"], h, T.cycle(cache[f"pos{i}"], c))
    for i, kind in enumerate(tail):
        h = prefill_block(kind, params["tail"][i], h, cache["tail"][i])
    h = L.apply_norm(cfg, params["final_norm"], h)
    last = h[:, -1] if lengths is None else h[torch.arange(b, device=device), lengths - 1]
    logits = (last @ T.head_matrix(cfg, params)).float()
    return logits, cache
