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
tokens.

``chunk_step`` is the continuous-batching engines' fused mixed step
(``runtime/decode_loop.py``): every row takes a window of cp tokens at
its own offset, ``live`` of them real (a prefill chunk, a decode token
at live 1, or nothing at live 0).  Its attention is plain PyTorch, as the
JAX package's is jnp: the window against the pre-write cache, masked on
``kpos``, merged with the window against its own live keys under a causal
mask; only then are the live keys written, at fixed shapes and with no
host read (``_write_rows``: a dead, evicted or out-of-capacity column
writes back the value its slot already holds, and no two columns of a
pass share a slot, so the scatter has no collision).  The recurrent
blocks take ``mamba_chunk_step`` / ``rglru_chunk_step`` (the
state-at-length gather), so every layout joins variable-length
continuous batching.

Host-streamed decode KV (``n_host_chunks > 0``, FPDT's Fig. 6 pipeline
applied to inference): the full-attention layers' ``k`` and ``v`` live in
pinned host memory (``offload_kv``, through ``runtime/placement.py``'s
``HostOffload``; ``kpos`` stays on the device) and ``decode_step`` and
``chunk_step`` stream them in ``n_host_chunks`` slabs of S / n positions,
slab c + 1's copy running under slab c's merge (``double_buffered``).
A slab whose first position lies past every row's highest position is
neither fetched nor merged: a fully masked slab is the merge's identity,
so any upper bound is exact.  The bound and each row's write span come
from ``bounds``, positions the caller knows on the host; the new keys are
written into the device copy of the slab that holds them as it passes
and copied back into the pinned rows on the copy stream, before any later
fetch.  On the CPU the offload is the identity but the slab loop, the
live skip and the write-back still run.  ``host_kv`` counts the slabs.

Paged layout (``init_paged_cache`` and ``table=...`` on ``decode_step``
and ``chunk_step``; ``runtime/paged.py`` owns the tables): the
full-attention blocks swap their per-slot ``[b, S]`` rows for one
slot-shared pool ``pk``/``pv`` ``[C, n_pages + 1, page_size, hkv, dh]``
(+ ``pkpos [C, n_pages + 1, page_size]``) read through a per-slot page
table ``[b, max_pages]`` (``-1``: unmapped, masked out of attention).
The last physical page is the trash page: a FREE slot's row points every
logical page at it.  Attention gathers the mapped range in one index per
leaf, as the JAX package's on-device branch does; a chunk's history
reads the pool before the window is written.  JAX drops dead and
unmapped writes (``mode="drop"``, an out-of-bounds index); here they go
to the trash page, which only FREE or paused rows map and whose outputs
are thrown away, so an index never leaves the pool and no mask is read
on the host; two live writes never share a page (copy-on-write).  The
local_attn rings and the recurrent states stay dense per slot.  The
host-streamed pool (``n_host_chunks`` with a table) is not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core import fpdt
from repro_torch.core.online_softmax import NEG_INF, SoftmaxState, finalize, merge, zero_state
from repro_torch.core.parallel import ParallelContext
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as R
from repro_torch.models import transformer as T
from repro_torch.runtime import placement as PL
from repro_torch.tree import tree_leaves_with_path

Params = Dict[str, Any]

# slabs of host-streamed KV merged ("fetched") and skipped by the live
# bound, over every attention layer, since the last ``reset_host_kv``
host_kv = {"fetched": 0, "skipped": 0}


def reset_host_kv():
    host_kv.update(fetched=0, skipped=0)


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


def _paged_attn_cache(cfg: ModelConfig, n_pages: int, page_size: int, dtype, device, lead=()):
    """Slot-shared page pool of one attention layer: ``n_pages + 1``
    physical pages, the last one the trash page; ``pkpos = -1`` marks
    unfilled entries, as the dense ``kpos`` does."""
    shape = (*lead, n_pages + 1, page_size, cfg.num_kv_heads, cfg.head_dim)
    return {"pk": torch.zeros(shape, dtype=dtype, device=device),
            "pv": torch.zeros(shape, dtype=dtype, device=device),
            "pkpos": torch.full(shape[:-2], -1, dtype=torch.int32, device=device)}


def init_paged_cache(cfg: ModelConfig, b: int, n_pages: int, page_size: int,
                     device="cuda") -> Params:
    """Paged twin of ``init_cache``: the full-attention blocks share one
    page pool across the ``b`` slots (bytes scale with the pages mapped,
    not ``slots x worst-case length``); the local_attn rings and the
    recurrent states keep their per-slot layouts, a ring bounded by the
    pool's token capacity."""
    dtype = getattr(torch, cfg.param_dtype)
    pat, n_cycles, tail = T.layout_of(cfg)
    cap = n_pages * page_size

    def make(kind, lead):
        if kind == "attn":
            return _paged_attn_cache(cfg, n_pages, page_size, dtype, device, lead)
        return _block_cache(cfg, kind, b, cap, dtype, device, lead)

    cache = {f"pos{i}": make(kind, (n_cycles,)) for i, kind in enumerate(pat)}
    if tail:
        cache["tail"] = [make(kind, ()) for kind in tail]
    return cache


def pool_leaves(cache: Params):
    """(key, leaf, stacked) of every page-pool leaf (``pk``, ``pv``,
    ``pkpos``) in the JAX package's leaf order.  ``key`` is the JAX
    ``pool_leaf_key`` (``pos0/pk``, ``tail/0/pkpos``): the spill tier's and
    the ``.npz`` store's names.  A stacked leaf's page dim is 1, a tail
    leaf's 0."""
    for path, leaf in tree_leaves_with_path(cache):
        if path[-1] in ("pk", "pv", "pkpos"):
            yield "/".join(path), leaf, path[0] != "tail"


def page_of(leaf: torch.Tensor, stacked: bool, pid):
    """Physical page ``pid`` of a pool leaf (a view)."""
    return leaf[:, pid] if stacked else leaf[pid]


def page_rows(cache: Params, pid: int) -> Dict[str, torch.Tensor]:
    """One physical page's payload as CPU tensors keyed by pool leaf
    (``[C, ps, hkv, dh]`` / ``[C, ps]``, tail leaves without ``C``): the
    spill tier's demotion read and the store's.  A device-to-host copy,
    so it waits for the work queued on the pool."""
    return {key: page_of(leaf, stacked, int(pid)).to("cpu", copy=True)
            for key, leaf, stacked in pool_leaves(cache)}


def _full_attn_blocks(cfg: ModelConfig, cache: Params):
    """The cache dicts of the full-attention ("attn") blocks: the only ones
    whose KV streams from the host (a local_attn ring is small)."""
    pat, _, tail = T.layout_of(cfg)
    yield from (cache[f"pos{i}"] for i, kind in enumerate(pat) if kind == "attn")
    yield from (c for c, kind in zip(cache.get("tail", []), tail) if kind == "attn")


def offload_kv(cfg: ModelConfig, cache: Params, device) -> Params:
    """Move the full-attention blocks' ``k`` and ``v`` to pinned host memory
    (``HostOffload.to_host``; the identity on the CPU), in place in
    ``cache``, for host-streamed decode (``n_host_chunks``).  ``kpos`` and
    every recurrent state stay on ``device``."""
    policy = PL.host_offload(device)
    for bc in _full_attn_blocks(cfg, cache):
        bc["k"], bc["v"] = policy.to_host(bc["k"]), policy.to_host(bc["v"])
    return cache


def _write_rows(buf: torch.Tensor, base: int, slot: torch.Tensor, val: torch.Tensor,
                mask: torch.Tensor):
    """``buf[i, slot[i, j] - base] = val[i, j]`` wherever ``mask[i, j]`` and
    the slot falls in buf's positions [base, base + n) (buf [b, n, ...],
    slot and mask [b, w], val [b, w, ...]), in place.

    The columns go in passes of n, and every column of a pass points at
    slot mod n, so as long as a pass's slots are distinct mod n (each
    window's positions are consecutive, a ring's are positions mod its
    size) no two of its writes share an index; a masked column writes
    back what its index already holds (``torch.where``).  No boolean
    indexing, no ``nonzero``: nothing is read on the host."""
    b, n = buf.shape[:2]
    bi = torch.arange(b, device=buf.device)[:, None]
    for j0 in range(0, slot.shape[1], n):
        sl = slot[:, j0:j0 + n] - base
        m = mask[:, j0:j0 + n] & (sl >= 0) & (sl < n)
        idx = torch.remainder(sl, n)
        old = buf[bi, idx]
        m = m.reshape(*m.shape, *([1] * (old.dim() - 2)))
        buf[bi, idx] = torch.where(m, val[:, j0:j0 + n].to(buf.dtype), old)


def _expand(t: torch.Tensor, g: int) -> torch.Tensor:
    """fp32 K or V [b, s, hkv, d] with each kv head repeated for its g q heads."""
    t = t.float()
    if g == 1:
        return t
    b, s, h, d = t.shape  # expand + reshape: repeat_interleave may read its count on the host
    return t[:, :, :, None].expand(b, s, h, g, d).reshape(b, s, h * g, d)


def _masked_state(s: torch.Tensor, ok: torch.Tensor, ve: torch.Tensor, eq: str):
    """Partial online-softmax state of scores ``s`` under mask ``ok``."""
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    pr = torch.where(s <= NEG_INF / 2, torch.zeros_like(s), torch.exp(s - m[..., None]))
    return SoftmaxState(torch.einsum(eq, pr, ve), m, pr.sum(dim=-1))


def _spans(bounds, lo: int, hi: int):
    """(row, start, end) of each row's write span [a, e] in ``bounds``
    clipped to positions [lo, hi), end exclusive; empty ones dropped."""
    out = []
    for i, (a, e) in enumerate(bounds):
        a, e = max(a, lo), min(e + 1, hi)
        if a < e:
            out.append((i, a, e))
    return out


def _stream_kv(cache: Params, n_host_chunks: int, device, bounds, attend, zero,
               writes=None, write_first: bool = False) -> SoftmaxState:
    """FPDT-for-inference: the merge of ``attend(k slab, v slab, kpos
    slab)`` over the live slabs of ``cache``'s [b, S] rows in order, each
    slab's host copy started one slab ahead (``double_buffered``).

    ``bounds`` holds per row the span [lo, hi] of positions the step may
    write (host ints; lo > hi for none): a slab starting past every hi is
    skipped.  ``writes`` (slot [b, w], k, v [b, w, hkv, d], mask [b, w])
    go into each slab's device copy before its attend (``write_first``:
    decode) or after it (a chunk's pre-write history), and the rows' spans
    of that slab are copied back to the host cache.  ``zero`` is the
    merge's identity."""
    ck, cv, kpos = cache["k"], cache["v"], cache["kpos"]
    S = ck.shape[1]
    cs = S // n_host_chunks
    hi = max((e for a, e in bounds if a <= e), default=-1)
    live = [c for c in range(n_host_chunks) if c * cs <= hi]
    host_kv["fetched"] += len(live)
    host_kv["skipped"] += n_host_chunks - len(live)
    policy = PL.host_offload(device)
    # a cache resident on the card streams as views of itself, written in
    # place; a host cache (and on the CPU any cache) through the policy
    resident = ck.device.type == "cuda"

    def fetch(c):
        if resident:
            return ck[:, c * cs:(c + 1) * cs], cv[:, c * cs:(c + 1) * cs]
        return policy.fetch_rows(ck, c * cs, cs), policy.fetch_rows(cv, c * cs, cs)

    def write(c, kc, vc):
        slot, k, v, mask = writes
        _write_rows(kc, c * cs, slot, k, mask)
        _write_rows(vc, c * cs, slot, v, mask)
        spans = _spans(bounds, c * cs, (c + 1) * cs)
        if spans and not resident:
            policy.write_rows(ck, kc, spans, c * cs)
            policy.write_rows(cv, vc, spans, c * cs)

    state = zero
    for c, (kc, vc) in zip(live, PL.double_buffered(live, fetch)):
        if writes is not None and write_first:
            write(c, kc, vc)
        state = merge(state, attend(kc, vc, kpos[:, c * cs:(c + 1) * cs]))
        if writes is not None and not write_first:
            write(c, kc, vc)
    return state


def _streams(cache: Params, n_host_chunks: int, window: int, device) -> bool:
    """Does this attention block stream its KV from the host?  As in the
    JAX package: a full-attention block whose S the chunk count divides;
    a cache held on the host must (ValueError otherwise)."""
    S = cache["k"].shape[1]
    on_host = cache["k"].device != torch.device(device)
    if n_host_chunks and not window and S % n_host_chunks == 0:
        return True
    if on_host:
        raise ValueError(f"the KV cache lives on the host but n_host_chunks={n_host_chunks} "
                         f"does not stream it (it must divide the cache length {S})")
    return False


def _default_bounds(b: int, S: int):
    """Every position of every row: no slab skipped, whole rows written back."""
    return [(0, S - 1)] * b


# ---------------------------------------------------------------------------
# decode attention (single new token against the cache)
# ---------------------------------------------------------------------------


def _decode_attention(cfg: ModelConfig, par: Optional[ParallelContext], p: Params,
                      x: torch.Tensor, cache: Params, pos: torch.Tensor, *, window: int = 0,
                      n_host_chunks: int = 0, bounds=None):
    """x [b, 1, d]; pos int64 [b]; writes the token into ``cache`` in place.
    With ``n_host_chunks`` (full attention only) the KV streams from the
    host in slabs (``_stream_kv``); ``bounds`` are the rows' host-known
    position spans.  Returns attn_out [b, 1, d]."""
    b = x.shape[0]
    q, k, v = L.qkv_proj(cfg, p, x)  # [b, 1, h, dh]
    q = L.apply_rope(q, pos[:, None], cfg.rope_theta)
    k = L.apply_rope(k, pos[:, None], cfg.rope_theta)
    ck, cv, kpos = cache["k"], cache["v"], cache["kpos"]
    S = ck.shape[1]
    slot = pos % S if window > 0 else torch.clamp(pos, max=S - 1)  # [b]
    bi = torch.arange(b, device=x.device)
    kpos[bi, slot] = pos.to(kpos.dtype)

    g = cfg.num_heads // cfg.num_kv_heads
    qf = q[:, 0].float()  # [b, hq, dh]
    scale = cfg.head_dim ** -0.5

    def attend(kc, vc, kp):
        """Partial state [b, hq, dh] of the token against a KV slab."""
        s = torch.einsum("bhd,bshd->bhs", qf, _expand(kc, g)) * scale
        ok = (kp >= 0) & (kp <= pos[:, None])
        if window:
            ok = ok & (kp > (pos - window)[:, None])
        return _masked_state(s, ok[:, None, :], _expand(vc, g), "bhs,bshd->bhd")

    if _streams(cache, n_host_chunks, window, x.device):
        bounds = _default_bounds(b, S) if bounds is None else [
            (min(a, S - 1), min(e, S - 1)) for a, e in bounds]
        ones = torch.ones((b, 1), dtype=torch.bool, device=x.device)
        zero = SoftmaxState(qf.new_zeros(qf.shape), qf.new_full(qf.shape[:2], NEG_INF),
                            qf.new_zeros(qf.shape[:2]))
        st = _stream_kv(cache, n_host_chunks, x.device, bounds, attend, zero,
                        writes=(slot[:, None], k, v, ones), write_first=True)
    else:
        ck[bi, slot] = k[:, 0].to(ck.dtype)
        cv[bi, slot] = v[:, 0].to(cv.dtype)
        st = attend(ck, cv, kpos)
    o = finalize(st).reshape(b, 1, cfg.q_dim).to(x.dtype)
    return o @ p["wo"]


def _paged_write_ids(table: torch.Tensor, pos: torch.Tensor, page_size: int, trash: int,
                     live: Optional[torch.Tensor] = None):
    """(physical page, in-page offset) of writes at positions ``pos`` ([b]
    or [b, w]) through the page table [b, max_pages].  An unmapped entry
    (-1), and a dead column where ``live`` [b, w] is false, go to the
    ``trash`` page, where JAX's ``mode="drop"`` scatter drops them: live
    positions are always mapped (the manager reserves a slot's pages at
    admission), so no live page takes a dead write."""
    b, max_pages = table.shape
    j = torch.clamp(torch.div(pos, page_size, rounding_mode="floor"), max=max_pages - 1)
    pid = torch.gather(table, 1, j.reshape(b, -1)).reshape(pos.shape)
    dead = pid < 0 if live is None else (pid < 0) | ~live
    return torch.where(dead, trash, pid), pos % page_size


def _paged_gather(cache: Params, table: torch.Tensor):
    """The mapped range of every row, one index per leaf: k and v [b,
    max_pages * ps, hkv, dh], their positions and the mapped mask [b,
    max_pages * ps] (an unmapped entry reads page 0, masked out here)."""
    b, max_pages = table.shape
    ps = cache["pkpos"].shape[1]
    safe = torch.clamp(table, min=0)

    def take(leaf):
        return leaf[safe].reshape(b, max_pages * ps, *leaf.shape[2:])

    mapped = (table >= 0)[:, :, None].expand(b, max_pages, ps).reshape(b, max_pages * ps)
    return take(cache["pk"]), take(cache["pv"]), take(cache["pkpos"]), mapped


def _paged_write(cache: Params, pid: torch.Tensor, off: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, pos: torch.Tensor):
    cache["pk"][pid, off] = k.to(cache["pk"].dtype)
    cache["pv"][pid, off] = v.to(cache["pv"].dtype)
    cache["pkpos"][pid, off] = pos.to(torch.int32)


def _decode_attention_paged(cfg: ModelConfig, p: Params, x: torch.Tensor, cache: Params,
                            pos: torch.Tensor, table: torch.Tensor):
    """Paged twin of ``_decode_attention``: the token's K/V go into its
    page (the trash page for a row whose position is unmapped), then it
    attends to its row's gathered pages.  x [b, 1, d]; pos int64 [b];
    table [b, max_pages].  Returns attn_out [b, 1, d]."""
    b = x.shape[0]
    q, k, v = L.qkv_proj(cfg, p, x)  # [b, 1, h, dh]
    q = L.apply_rope(q, pos[:, None], cfg.rope_theta)
    k = L.apply_rope(k, pos[:, None], cfg.rope_theta)
    n_phys, ps = cache["pkpos"].shape
    pid, off = _paged_write_ids(table, pos, ps, n_phys - 1)
    _paged_write(cache, pid, off, k[:, 0], v[:, 0], pos)
    kall, vall, kpall, mapped = _paged_gather(cache, table)
    g = cfg.num_heads // cfg.num_kv_heads
    qf = q[:, 0].float()  # [b, hq, dh]
    s = torch.einsum("bhd,bshd->bhs", qf, _expand(kall, g)) * cfg.head_dim ** -0.5
    ok = mapped & (kpall >= 0) & (kpall <= pos[:, None])
    st = _masked_state(s, ok[:, None, :], _expand(vall, g), "bhs,bshd->bhd")
    o = finalize(st).reshape(b, 1, cfg.q_dim).to(x.dtype)
    return o @ p["wo"]


def _keep_state(cache: Params, state: Params):
    """Copy a recurrent mixer's new state into its cache tensors in place."""
    for k, v in state.items():
        cache[k].copy_(v)


def _ffn(cfg, p, h):
    """The attention block's second half: norm2, then the MoE FFN (unchunked,
    as the JAX package's decode and chunk steps run it) or the MLP."""
    hn2 = L.apply_norm(cfg, p["norm2"], h)
    if "moe" in p:
        return h + MOE.moe_ffn(cfg, p["moe"], hn2)[0]
    return h + L.mlp_block(cfg, p["mlp"], hn2)


def _decode_block(cfg, par, kind, p, h, cache, pos, n_host_chunks=0, bounds=None, table=None):
    if kind == "ssm":
        y, st = M.mamba_decode_step(cfg, p["mixer"], L.apply_norm(cfg, p["norm"], h), cache)
        _keep_state(cache, st)
        return h + y
    hn = L.apply_norm(cfg, p["norm1"], h)
    if kind == "rglru":
        y, st = R.rglru_decode_step(cfg, p["mixer"], hn, cache)
        _keep_state(cache, st)
        h = h + y
    elif table is not None and "pk" in cache:  # the paged pool (attn blocks only)
        h = h + _decode_attention_paged(cfg, p["attn"], hn, cache, pos, table)
    else:
        window = cfg.window if kind == "local_attn" else 0
        h = h + _decode_attention(cfg, par, p["attn"], hn, cache, pos, window=window,
                                  n_host_chunks=0 if window else n_host_chunks,
                                  bounds=bounds)
    return _ffn(cfg, p, h)


def _positions(pos, b: int, device) -> torch.Tensor:
    return torch.as_tensor(pos, dtype=torch.int64, device=device).expand(b)


def _check_table(table, n_host_chunks: int):
    if table is not None and n_host_chunks:
        raise ValueError("the host-streamed page pool (a page table with n_host_chunks > 0) "
                         "is not ported; ROADMAP Queue A item 2 keeps it with serving over "
                         "a mesh")


@torch.no_grad()
def decode_step(cfg: ModelConfig, par: Optional[ParallelContext], params: Params,
                cache: Params, inp: Dict[str, torch.Tensor], pos, n_host_chunks: int = 0,
                bounds=None, table: Optional[torch.Tensor] = None):
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
      n_host_chunks — stream each full-attention layer's KV in this many
               slabs (0 = on-device attention; a count that does not divide
               the cache length attends on the device, as in the JAX
               package, and raises if the KV is on the host).
      bounds — with n_host_chunks: per row (lo, hi), host ints, the span
               its ``pos`` lies in; slabs past every hi are skipped and
               each row's span is written back.  None: every position.
      table  — optional integer [b, max_pages] page table on the cache's
               device: the attention blocks read and write the paged pool
               (``init_paged_cache``) through it.

    Returns (logits [b, padded_vocab] fp32, cache)."""
    _check_table(table, n_host_chunks)
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
            h = _decode_block(cfg, par, kind, cyc_p[f"pos{i}"], h, cyc_cache[f"pos{i}"], pos,
                              n_host_chunks, bounds, table)
    for i, kind in enumerate(tail):
        h = _decode_block(cfg, par, kind, params["tail"][i], h, cache["tail"][i], pos,
                          n_host_chunks, bounds, table)
    h = L.apply_norm(cfg, params["final_norm"], h)
    logits = (h[:, 0] @ T.head_matrix(cfg, params)).float()
    return logits, cache


# ---------------------------------------------------------------------------
# fused mixed step: one prefill chunk OR one decode token per batch row
# ---------------------------------------------------------------------------


def _chunk_attention(cfg: ModelConfig, par: Optional[ParallelContext], p: Params,
                     x: torch.Tensor, cache: Params, qpos: torch.Tensor, live: torch.Tensor,
                     *, window: int = 0, n_host_chunks: int = 0, bounds=None):
    """Chunk-window attention against the cache at per-row offsets.

    x [b, cp, d]; qpos [b, cp] int64 the position of each window token;
    live [b] how many leading window tokens are real (0: the row is a
    no-op).  The online-softmax merge of (a) the PRE-write cache masked on
    ``kpos`` (host-streamed in slabs under ``n_host_chunks``) and (b) the
    window against its own live keys under an intra-window causal mask;
    then the live keys are written (ring buffers keep only the last S
    live tokens).  Returns attn out [b, cp, d]; the cache is updated in
    place."""
    b, cp, _ = x.shape
    q, k, v = L.qkv_proj(cfg, p, x)  # [b, cp, h, dh]
    q = L.apply_rope(q, qpos, cfg.rope_theta)
    k = L.apply_rope(k, qpos, cfg.rope_theta)
    S = cache["k"].shape[1]
    if window:
        window = min(window, S)  # ring capacity bounds the visible window
    g = cfg.num_heads // cfg.num_kv_heads
    qt = q.float().transpose(1, 2)  # [b, hq, cp, dh]
    scale = cfg.head_dim ** -0.5
    col = torch.arange(cp, device=x.device)[None, :]
    key_live = col < live[:, None]  # [b, cp]

    def attend(kc, vc, kp):
        """Partial state [b, hq, cp, dh] of the window queries vs a KV slab."""
        s_ = torch.einsum("bhqd,bshd->bhqs", qt, _expand(kc, g)) * scale
        ok = (kp[:, None, :] >= 0) & (kp[:, None, :] <= qpos[:, :, None])
        if window:
            ok = ok & (kp[:, None, :] > (qpos[:, :, None] - window))
        return _masked_state(s_, ok[:, None], _expand(vc, g), "bhqs,bshd->bhqd")

    # the live window's slots: ring buffers drop all but the last S live
    # tokens; full attention drops positions past its capacity
    if window:
        wmask = key_live & (col >= (live[:, None] - S))
    else:
        wmask = key_live & (qpos < S)
    slot = qpos % S
    if _streams(cache, n_host_chunks, window, x.device):
        bounds = _default_bounds(b, S) if bounds is None else bounds
        hist = _stream_kv(cache, n_host_chunks, x.device, bounds, attend,
                          zero_state((b, cfg.num_heads, cp, cfg.head_dim), device=x.device),
                          writes=(slot, k, v, wmask))
    else:
        hist = attend(cache["k"], cache["v"], cache["kpos"])
        _write_rows(cache["k"], 0, slot, k, wmask)
        _write_rows(cache["v"], 0, slot, v, wmask)
    _write_rows(cache["kpos"], 0, slot, qpos.to(torch.int32), wmask)
    o = finalize(merge(hist, _intra_state(cfg, qt, k, v, qpos, key_live, window)))
    o = o.transpose(1, 2).reshape(b, cp, cfg.q_dim).to(x.dtype)
    return o @ p["wo"]


def _intra_state(cfg: ModelConfig, qt, k, v, qpos, key_live, window: int = 0) -> SoftmaxState:
    """Partial state [b, hq, cp, dh] of the window queries qt against the
    window's own live, causal keys: not in the cache yet, so the pre-write
    pass counts nothing twice and a ring's eviction cannot clobber history
    an earlier window token needs."""
    g = cfg.num_heads // cfg.num_kv_heads
    s_ = torch.einsum("bhqd,bkhd->bhqk", qt, _expand(k, g)) * cfg.head_dim ** -0.5
    ok = key_live[:, None, :] & (qpos[:, None, :] <= qpos[:, :, None])
    if window:
        ok = ok & (qpos[:, None, :] > (qpos[:, :, None] - window))
    return _masked_state(s_, ok[:, None], _expand(v, g), "bhqk,bkhd->bhqd")


def _chunk_attention_paged(cfg: ModelConfig, p: Params, x: torch.Tensor, cache: Params,
                           qpos: torch.Tensor, live: torch.Tensor, table: torch.Tensor):
    """Paged twin of ``_chunk_attention``: the window against its rows'
    gathered pages of the PRE-write pool, merged with the window against
    its own live keys; then the live keys go into their pages and the dead
    columns to the trash page.  Pages a row shares (radix prefixes) are
    only read: the manager gives every written page one owner.  Returns
    attn out [b, cp, d]; the pool is updated in place."""
    b, cp, _ = x.shape
    q, k, v = L.qkv_proj(cfg, p, x)  # [b, cp, h, dh]
    q = L.apply_rope(q, qpos, cfg.rope_theta)
    k = L.apply_rope(k, qpos, cfg.rope_theta)
    g = cfg.num_heads // cfg.num_kv_heads
    qt = q.float().transpose(1, 2)  # [b, hq, cp, dh]
    key_live = torch.arange(cp, device=x.device)[None, :] < live[:, None]  # [b, cp]
    kall, vall, kpall, mapped = _paged_gather(cache, table)
    s_ = torch.einsum("bhqd,bshd->bhqs", qt, _expand(kall, g)) * cfg.head_dim ** -0.5
    ok = (mapped & (kpall >= 0))[:, None, :] & (kpall[:, None, :] <= qpos[:, :, None])
    hist = _masked_state(s_, ok[:, None], _expand(vall, g), "bhqs,bshd->bhqd")
    n_phys, ps = cache["pkpos"].shape
    pid, off = _paged_write_ids(table, qpos, ps, n_phys - 1, key_live)
    _paged_write(cache, pid, off, k, v, qpos)
    o = finalize(merge(hist, _intra_state(cfg, qt, k, v, qpos, key_live)))
    o = o.transpose(1, 2).reshape(b, cp, cfg.q_dim).to(x.dtype)
    return o @ p["wo"]


def _chunk_block(cfg, par, kind, p, h, cache, qpos, live, n_host_chunks=0, bounds=None,
                 table=None):
    if kind == "ssm":
        y, st = M.mamba_chunk_step(cfg, p["mixer"], L.apply_norm(cfg, p["norm"], h), cache,
                                   live)
        _keep_state(cache, st)
        return h + y
    hn = L.apply_norm(cfg, p["norm1"], h)
    if kind == "rglru":
        y, st = R.rglru_chunk_step(cfg, p["mixer"], hn, cache, live)
        _keep_state(cache, st)
        h = h + y
    elif table is not None and "pk" in cache:  # the paged pool (attn blocks only)
        h = h + _chunk_attention_paged(cfg, p["attn"], hn, cache, qpos, live, table)
    else:
        window = cfg.window if kind == "local_attn" else 0
        h = h + _chunk_attention(cfg, par, p["attn"], hn, cache, qpos, live, window=window,
                                 n_host_chunks=0 if window else n_host_chunks, bounds=bounds)
    return _ffn(cfg, p, h)


@torch.no_grad()
def chunk_step(cfg: ModelConfig, par: Optional[ParallelContext], params: Params,
               cache: Params, toks: torch.Tensor, offset, live, n_host_chunks: int = 0,
               bounds=None, table: Optional[torch.Tensor] = None):
    """One fused mixed step: every batch row processes a ``cp``-token window.

    Contract (the JAX package's):
      toks   — [b, cp] integer window tokens.  A row consuming a prefill
               chunk passes the chunk (``live`` real tokens, the rest
               padding); a decoding row passes its next token in column 0
               (``live=1``); an idle row passes anything (``live=0``: its
               cache rows, recurrent state and ring are untouched).
      offset — scalar or integer [b]: the position of each row's first
               window token.
      live   — scalar or integer [b] in [0, cp]: real tokens per row.
      cache  — dict from ``init_cache``, updated in place at the live
               positions only, at fixed shapes.
      n_host_chunks, bounds — host-streamed KV, as ``decode_step``'s;
               ``bounds`` per row the span of positions its live window
               covers.
      table  — optional page table for the paged pool, as ``decode_step``'s.

    Recurrent blocks (ssm, rglru, the local_attn ring) take the
    state-at-length gather (``mamba.mamba_chunk_step`` /
    ``rglru.rglru_chunk_step``), so chunked prefill of any length is exact
    for them.  Returns (logits [b, padded_vocab] fp32 at each row's LAST
    live token, cache)."""
    if cfg.frontend == "audio_frames":
        raise ValueError("chunk_step feeds token ids; the audio_frames "
                         "frontend consumes frame embeddings")
    _check_table(table, n_host_chunks)
    b, cp = toks.shape
    device = toks.device
    offset = _positions(offset, b, device)
    live = _positions(live, b, device)
    qpos = offset[:, None] + torch.arange(cp, device=device)[None, :]  # [b, cp]
    h = params["embed"][toks].to(getattr(torch, cfg.param_dtype))
    pat, n_cycles, tail = T.layout_of(cfg)
    for c in range(n_cycles):
        cyc_p, cyc_cache = T.cycle(params["cycles"], c), T.cycle(
            {k: cache[k] for k in cache if k != "tail"}, c)
        for i, kind in enumerate(pat):
            h = _chunk_block(cfg, par, kind, cyc_p[f"pos{i}"], h, cyc_cache[f"pos{i}"], qpos,
                             live, n_host_chunks, bounds, table)
    for i, kind in enumerate(tail):
        h = _chunk_block(cfg, par, kind, params["tail"][i], h, cache["tail"][i], qpos, live,
                         n_host_chunks, bounds, table)
    h = L.apply_norm(cfg, params["final_norm"], h)
    last = h[torch.arange(b, device=device), torch.clamp(live - 1, 0, cp - 1)]
    logits = (last @ T.head_matrix(cfg, params)).float()
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
