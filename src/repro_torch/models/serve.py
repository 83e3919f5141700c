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
local_attn rings and the recurrent states stay dense per slot.

The host-streamed pool (``n_host_chunks > 0`` with a table: the JAX
package's two-tier pool) keeps ``pk``/``pv`` parked in pinned host memory
from the start (``init_paged_cache(..., host=True)``; ``pkpos`` and the
table stay on the device).  A step's plan (``_pool_plan``) comes from the
table as the host holds it (``host_table``) and the rows' host-known
spans (``bounds``), never from a device read: the live logical pages
(up to the rows' highest position; the rest are the merge's identity)
are fetched (``HostOffload.fetch_pages``, one copy a row's run of
consecutive physical pages) and merged at once: the merge differs from
JAX's page-by-page order in the last bits, and a step issues ~30 host ops
a layer instead of ~30 a page and layer.  The step's new keys reach
their host pages by a read-modify-write of the pages the rows' spans
touch (``_host_pool_write``: fetched, written at the device-side
positions, their spans copied back), every copy on the copy stream, so a
later fetch sees them with no host wait: a decode step writes before it
streams (JAX writes before it attends), a chunk step after (its history
is the pre-write pool).  Dead and unmapped writes, and the trash page,
never reach the host.  On the CPU the pool is an ordinary tensor but the
page loop and the write pass run.  ``host_pages`` counts the pages
fetched.

On a mesh (``Shard``: a replica's ``data`` x ``model`` ranks, every rank
holding the whole weight tree as the JAX serve programs do) a rank holds
the cache that ``cache_shardings`` gives it, the JAX package's placement
written out as (data dim, model dim) per leaf: the per-slot rows over
``data`` when the data ranks divide the slots, the attention KV over
``model`` by kv heads when the model ranks divide them, else by position
(a dense row's positions, a page's in-page positions); the paged pool is
whole over ``data``.  Where the KV splits by heads a rank computes q, k
and v for its heads from their weight columns, attends over them and
all-gathers the heads' outputs over ``model`` (an exact concatenation)
before the whole ``wo``; where it splits by position a rank attends over
its positions and the partial online-softmax states are all-gathered and
merged in rank order, and only the rank that holds a position writes it
(the others send the write to the trash page, or mask it).  With the rows
split, a rank steps its own rows; the pool's writes of every row reach
every data rank's copy through one all-gather over ``data`` a layer, and
the MoE FFN runs on every row (gathered), as its groups and capacity are
the batch's.  Norms, the FFN, logits and sampling are replicated over
``model``, so every rank holds the same tokens.  The recurrent blocks
split d_inner over ``model`` where the model ranks divide it
(``Shard.channels``, JAX's ``sp_if``): a rank holds its channels of the
conv and ssm or h states and runs the mixer on them, its activations
all-gathered (``gather_channels``) before the projections that read every
channel (``models/mamba.py``, ``models/rglru.py``).  Host-streamed KV
parks a rank's own shard: dense KV streams the rank's heads, or its own
positions from ``base`` with the ranks' states merged in rank order; the
parked pool is the rank's slice of every page (whole over ``data``, so
each data rank parks its own copy and writes every row's keys into it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core import fpdt
from repro_torch.core.online_softmax import NEG_INF, SoftmaxState, finalize, merge, zero_state
from repro_torch.core import parallel as P
from repro_torch.core.parallel import ParallelContext
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as R
from repro_torch.models import transformer as T
from repro_torch.runtime import placement as PL
from repro_torch.tree import tree_leaves_with_path, tree_map_with_path

Params = Dict[str, Any]

# slabs of host-streamed KV merged ("fetched") and skipped by the live
# bound, and pages of a parked pool fetched (a row's page, its k and
# v one each), over every attention layer, since the last ``reset_host_kv``
host_kv = {"fetched": 0, "skipped": 0}
host_pages = {"fetched": 0}


def reset_host_kv():
    host_kv.update(fetched=0, skipped=0)
    host_pages.update(fetched=0)


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


def init_cache(cfg: ModelConfig, b: int, max_len: int, device="cuda",
               par: Optional[ParallelContext] = None) -> Params:
    """The dense cache of ``b`` rows of ``max_len`` positions; on ``par``'s
    mesh only this rank's shard (``cache_shardings``)."""
    if P.distributed(par):
        return _local_cache(cfg, par, init_cache(cfg, b, max_len, "meta"), device)
    dtype = getattr(torch, cfg.param_dtype)
    pat, n_cycles, tail = T.layout_of(cfg)
    cache = {f"pos{i}": _block_cache(cfg, kind, b, max_len, dtype, device, lead=(n_cycles,))
             for i, kind in enumerate(pat)}
    if tail:
        cache["tail"] = [_block_cache(cfg, kind, b, max_len, dtype, device) for kind in tail]
    return cache


def _pool_zeros(shape, dtype, device, host: bool) -> torch.Tensor:
    """A zeroed pool ``pk``/``pv`` leaf: parked in pinned host memory from
    the start with ``host`` (``HostOffload.host_zeros``), else on ``device``."""
    if host:
        return PL.host_offload(device).host_zeros(shape, dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


def _paged_attn_cache(cfg: ModelConfig, n_pages: int, page_size: int, dtype, device, lead=(),
                      host: bool = False):
    """Slot-shared page pool of one attention layer: ``n_pages + 1``
    physical pages, the last one the trash page; ``pkpos = -1`` marks
    unfilled entries, as the dense ``kpos`` does."""
    shape = (*lead, n_pages + 1, page_size, cfg.num_kv_heads, cfg.head_dim)
    return {"pk": _pool_zeros(shape, dtype, device, host),
            "pv": _pool_zeros(shape, dtype, device, host),
            "pkpos": torch.full(shape[:-2], -1, dtype=torch.int32, device=device)}


def init_paged_cache(cfg: ModelConfig, b: int, n_pages: int, page_size: int,
                     device="cuda", par: Optional[ParallelContext] = None,
                     host: bool = False) -> Params:
    """Paged twin of ``init_cache``: the full-attention blocks share one
    page pool across the ``b`` slots (bytes scale with the pages mapped,
    not ``slots x worst-case length``); the local_attn rings and the
    recurrent states keep their per-slot layouts, a ring bounded by the
    pool's token capacity.  On ``par``'s mesh only this rank's shard.
    With ``host`` the pool's ``pk``/``pv`` are parked in pinned host memory
    (the host-streamed pool, ``n_host_chunks > 0``) and never allocated on
    ``device``."""
    if P.distributed(par):
        return _local_cache(cfg, par, init_paged_cache(cfg, b, n_pages, page_size, "meta"),
                            device, host)
    dtype = getattr(torch, cfg.param_dtype)
    pat, n_cycles, tail = T.layout_of(cfg)
    cap = n_pages * page_size

    def make(kind, lead):
        if kind == "attn":
            return _paged_attn_cache(cfg, n_pages, page_size, dtype, device, lead, host)
        return _block_cache(cfg, kind, b, cap, dtype, device, lead)

    cache = {f"pos{i}": make(kind, (n_cycles,)) for i, kind in enumerate(pat)}
    if tail:
        cache["tail"] = [make(kind, ()) for kind in tail]
    return cache


# ---------------------------------------------------------------------------
# placement on a mesh (the JAX package's cache_shardings)
# ---------------------------------------------------------------------------


def _splits(n: int, parts: int) -> bool:
    """The JAX rule: a dimension splits over an axis whose size divides it."""
    return n % parts == 0 and n >= parts


def dense_kv_spec(dp: int, sp: int, shape) -> Tuple[Optional[int], Optional[int]]:
    """(data dim, model dim) of one dense K/V leaf [b, s, h, dh]: rows over
    data and kv heads over model when they divide, else positions over
    model (context parallel); a dimension nothing divides stays whole."""
    b, s, h, _ = shape
    d = 0 if _splits(b, dp) else None
    if _splits(h, sp):
        return d, 2
    return d, (1 if _splits(s, sp) else None)


def paged_pool_spec(sp: int, page_size: int, hkv: int) -> Optional[int]:
    """Model dim of one pool K/V leaf [n_pages + 1, page_size, hkv, dh]: kv
    heads when the model ranks divide them, else the in-page positions,
    else none.  The page dim never splits (the table maps pages to slots
    freely) and the pool is whole over data."""
    if _splits(hkv, sp):
        return 2
    if _splits(page_size, sp):
        return 1
    return None


def cache_shardings(cfg: ModelConfig, dp: int, sp: int, cache) -> Any:
    """(data dim, model dim) of every leaf of ``cache`` (global shapes; a
    ``device="meta"`` cache will do) on a dp x sp mesh, in ``cache``'s
    structure: the JAX package's ``cache_shardings``.  ``pk``/``pv``
    follow ``paged_pool_spec`` and ``pkpos`` co-splits their in-page dim;
    ``kpos`` splits its rows only (a dense row's positions stay whole);
    the recurrent states split rows over data and channels over model."""

    def spec(path, leaf):
        stacked = path[0] != "tail"
        off = 1 if stacked else 0
        shape, name = tuple(leaf.shape[off:]), path[-1]

        def at(d, m):
            return (None if d is None else d + off, None if m is None else m + off)

        rows = 0 if _splits(shape[0], dp) else None
        if name in ("pk", "pv"):
            return at(None, paged_pool_spec(sp, shape[1], shape[2]))
        if name == "pkpos":
            return at(None, 1 if paged_pool_spec(sp, shape[1], cfg.num_kv_heads) == 1 else None)
        if name == "kpos":
            return at(rows, None)
        if name in ("k", "v"):
            return at(*dense_kv_spec(dp, sp, shape))
        if name == "conv":
            return at(rows, 2 if _splits(shape[2], sp) else None)
        if name == "ssm":
            return at(rows, 1 if _splits(shape[1], sp) else None)
        if name == "h":
            return at(rows, 1 if _splits(shape[1], sp) else None)
        return None, None

    return tree_map_with_path(spec, cache)


def local_shape(shape, dims, dp: int, sp: int) -> Tuple[int, ...]:
    """A leaf's shape on one rank under its (data dim, model dim)."""
    out = list(shape)
    d, m = dims
    if d is not None:
        out[d] //= dp
    if m is not None:
        out[m] //= sp
    return tuple(out)


def _local_cache(cfg: ModelConfig, par: ParallelContext, meta: Params, device,
                 host: bool = False) -> Params:
    """This rank's shard of the cache ``meta`` describes: each leaf at its
    local shape, positions -1 and the rest 0, as ``init_cache`` fills them;
    with ``host`` the pool's ``pk``/``pv`` parked (``init_paged_cache``)."""
    plan = cache_shardings(cfg, par.dp, par.sp, meta)

    def make(path, leaf, dims):
        shape = local_shape(leaf.shape, dims, par.dp, par.sp)
        if host and path[-1] in ("pk", "pv"):
            return _pool_zeros(shape, leaf.dtype, device, True)
        return torch.full(shape, -1 if leaf.dtype == torch.int32 else 0, dtype=leaf.dtype,
                          device=device)

    return tree_map_with_path(make, meta, plan)


@dataclasses.dataclass(frozen=True)
class Shard:
    """A serve step's place on a mesh: ``par`` the replica's mesh, ``slots``
    the engine's rows, ``page_size`` the pool's (0: a dense cache).  A rank
    steps rows [r0, r1): its block when the data ranks divide the slots
    (``rows_split``), else every row.  The KV splits over model by kv heads
    where the model ranks divide them (``heads``), else by position."""

    par: ParallelContext
    slots: int
    page_size: int = 0

    @property
    def rows_split(self) -> bool:
        return self.par.dp > 1 and _splits(self.slots, self.par.dp)

    @property
    def r0(self) -> int:
        return self.par.dp_rank * self.slots // self.par.dp if self.rows_split else 0

    @property
    def r1(self) -> int:
        return self.r0 + (self.slots // self.par.dp if self.rows_split else self.slots)

    def heads(self, cfg: ModelConfig) -> Optional[Tuple[int, int, int, int]]:
        """This model rank's q heads [q0, q1) and kv heads [k0, k1) when the
        KV splits by heads, else None."""
        sp = self.par.sp
        if sp == 1 or not _splits(cfg.num_kv_heads, sp):
            return None
        m, kl, ql = self.par.sp_rank, cfg.num_kv_heads // sp, cfg.num_heads // sp
        return m * ql, (m + 1) * ql, m * kl, (m + 1) * kl

    def channels(self, cfg: ModelConfig):
        """This model rank's channels [c0, c1) of d_inner and the model
        group, the recurrent mixers' ``chan``, where the model ranks divide
        d_inner (the JAX package's ``sp_if``), else None: every rank runs
        every channel."""
        sp = self.par.sp
        if sp == 1 or not _splits(cfg.d_inner, sp):
            return None
        n, m = cfg.d_inner // sp, self.par.sp_rank
        return m * n, (m + 1) * n, self.par.sp_group


def _on_mesh(sh: Optional[Shard]) -> bool:
    return sh is not None and P.distributed(sh.par)


def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, heads):
    """``qkv_proj`` for the q heads [q0, q1) and kv heads [k0, k1) of
    ``heads`` from their weight columns (all heads when None)."""
    if heads is None:
        return L.qkv_proj(cfg, p, x)
    q0, q1, k0, k1 = heads
    b, s, _ = x.shape
    dh = cfg.head_dim
    q = x @ p["wq"][:, q0 * dh:q1 * dh]
    k = x @ p["wk"][:, k0 * dh:k1 * dh]
    v = x @ p["wv"][:, k0 * dh:k1 * dh]
    if cfg.qkv_bias:
        q = q + p["bq"][q0 * dh:q1 * dh]
        k = k + p["bk"][k0 * dh:k1 * dh]
        v = v + p["bv"][k0 * dh:k1 * dh]
    return (q.reshape(b, s, q1 - q0, dh), k.reshape(b, s, k1 - k0, dh),
            v.reshape(b, s, k1 - k0, dh))


def _merge_ranks(st: SoftmaxState, group) -> SoftmaxState:
    """The model ranks' partial states over their positions, all-gathered
    (one call) and merged in rank order: the state over every position."""
    packed = torch.cat([st.acc, st.m[..., None], st.l[..., None]], dim=-1)
    parts = P.gather_state(packed, group)
    out = None
    for part in parts:
        s_ = SoftmaxState(part[..., :-2], part[..., -2], part[..., -1])
        out = s_ if out is None else merge(out, s_)
    return out


def _out(cfg: ModelConfig, p: Params, o: torch.Tensor, heads, sh: Optional[Shard]):
    """The attention output [b, s, heads' width] through ``wo``: the model
    ranks' heads gathered first when the KV splits by heads."""
    if heads is not None:
        o = P.gather_heads(o, sh.par.sp_group)
    return o @ p["wo"]


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


def parked_bytes(cfg: ModelConfig, cache: Params) -> int:
    """Bytes of the KV that host-streaming keeps in host memory: the page
    pool's ``pk``/``pv``, else the full-attention blocks' ``k`` and ``v``."""
    leaves = [leaf for key, leaf, _ in pool_leaves(cache) if not key.endswith("pkpos")]
    if not leaves:
        leaves = [bc[n] for bc in _full_attn_blocks(cfg, cache) for n in ("k", "v")]
    return sum(t.numel() * t.element_size() for t in leaves)


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
               writes=None, write_first: bool = False, base: int = 0) -> SoftmaxState:
    """FPDT-for-inference: the merge of ``attend(k slab, v slab, kpos
    slab)`` over the live slabs of ``cache``'s [b, S] rows in order, each
    slab's host copy started one slab ahead (``double_buffered``).

    ``bounds`` holds per row the span [lo, hi] of positions the step may
    write (host ints; lo > hi for none): a slab starting past every hi is
    skipped.  ``writes`` (slot [b, w], k, v [b, w, hkv, d], mask [b, w])
    go into each slab's device copy before its attend (``write_first``:
    decode) or after it (a chunk's pre-write history), and the rows' spans
    of that slab are copied back to the host cache.  ``zero`` is the
    merge's identity.  The rows hold positions [base, base + S) (a model
    rank's share when the positions split over model)."""
    ck, cv, kpos = cache["k"], cache["v"], cache["kpos"]
    S = ck.shape[1]
    cs = S // n_host_chunks
    hi = max((e for a, e in bounds if a <= e), default=-1)
    live = [c for c in range(n_host_chunks) if base + c * cs <= hi]
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
        _write_rows(kc, base + c * cs, slot, k, mask)
        _write_rows(vc, base + c * cs, slot, v, mask)
        spans = [(i, a - base, e - base)
                 for i, a, e in _spans(bounds, base + c * cs, base + (c + 1) * cs)]
        if spans and not resident:
            policy.write_rows(ck, kc, spans, c * cs)
            policy.write_rows(cv, vc, spans, c * cs)

    state = zero
    for c, (kc, vc) in zip(live, PL.double_buffered(live, fetch)):
        if writes is not None and write_first:
            write(c, kc, vc)
        state = merge(state, attend(kc, vc, kpos[:, base + c * cs:base + (c + 1) * cs]))
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


def _mine(bounds, sh: Optional[Shard]):
    """This rank's rows of ``bounds`` (every row's on a mesh)."""
    return bounds[sh.r0:sh.r1] if _on_mesh(sh) else bounds


# ---------------------------------------------------------------------------
# decode attention (single new token against the cache)
# ---------------------------------------------------------------------------


def _decode_attention(cfg: ModelConfig, par: Optional[ParallelContext], p: Params,
                      x: torch.Tensor, cache: Params, pos: torch.Tensor, *, window: int = 0,
                      n_host_chunks: int = 0, bounds=None, sh: Optional[Shard] = None):
    """x [b, 1, d]; pos int64 [b]; writes the token into ``cache`` in place.
    With ``n_host_chunks`` (full attention only) the KV streams from the
    host in slabs (``_stream_kv``); ``bounds`` are the rows' host-known
    position spans.  On a mesh (``sh``) the rank attends over its heads
    or its positions (``kpos`` is whole, so S is the global length).
    Returns attn_out [b, 1, d]."""
    b = x.shape[0]
    heads = sh.heads(cfg) if _on_mesh(sh) else None
    q, k, v = _qkv(cfg, p, x, heads)  # [b, 1, h, dh]
    q = L.apply_rope(q, pos[:, None], cfg.rope_theta)
    k = L.apply_rope(k, pos[:, None], cfg.rope_theta)
    ck, cv, kpos = cache["k"], cache["v"], cache["kpos"]
    S, S_loc = kpos.shape[1], ck.shape[1]
    base = sh.par.sp_rank * S_loc if S_loc < S else 0
    slot = pos % S if window > 0 else torch.clamp(pos, max=S - 1)  # [b]
    bi = torch.arange(b, device=x.device)
    kpos[bi, slot] = pos.to(kpos.dtype)

    hq = q.shape[2]
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
            (min(a, S - 1), min(e, S - 1)) for a, e in _mine(bounds, sh)]
        ones = torch.ones((b, 1), dtype=torch.bool, device=x.device)
        zero = SoftmaxState(qf.new_zeros(qf.shape), qf.new_full(qf.shape[:2], NEG_INF),
                            qf.new_zeros(qf.shape[:2]))
        st = _stream_kv(cache, n_host_chunks, x.device, bounds, attend, zero,
                        writes=(slot[:, None], k, v, ones), write_first=True, base=base)
        if S_loc < S:  # positions over model: the ranks' states, merged
            st = _merge_ranks(st, sh.par.sp_group)
    elif S_loc < S:  # positions over model: the owner writes, every rank attends its own
        ones = torch.ones((b, 1), dtype=torch.bool, device=x.device)
        _write_rows(ck, base, slot[:, None], k, ones)
        _write_rows(cv, base, slot[:, None], v, ones)
        st = _merge_ranks(attend(ck, cv, kpos[:, base:base + S_loc]), sh.par.sp_group)
    else:
        ck[bi, slot] = k[:, 0].to(ck.dtype)
        cv[bi, slot] = v[:, 0].to(cv.dtype)
        st = attend(ck, cv, kpos)
    o = finalize(st).reshape(b, 1, hq * cfg.head_dim).to(x.dtype)
    return _out(cfg, p, o, heads, sh)


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
    max_pages * ps] (an unmapped entry reads page 0, masked out here).  On
    a mesh ps and hkv are the rank's."""
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


def _gather_writes(sh: Shard, k: torch.Tensor, v: torch.Tensor, qpos: torch.Tensor,
                   live: torch.Tensor):
    """Every data rank's pool writes (k, v [b, w, h, dh], positions and
    live [b, w]), all rows in row order, through ONE all-gather over data:
    the bytes of k, v and the positions (-1 where dead) side by side."""
    b, w = qpos.shape
    pos = torch.where(live, qpos, -1).to(torch.int32)
    parts = [t.reshape(b, -1).contiguous().view(torch.uint8) for t in (k, v, pos)]
    sizes = [t.shape[1] for t in parts]
    full = P.gather_rows(torch.cat(parts, dim=1), sh.par.dp_group)
    kb, vb, pb = torch.split(full, sizes, dim=1)
    B = full.shape[0]
    k = kb.contiguous().view(k.dtype).reshape(B, *k.shape[1:])
    v = vb.contiguous().view(v.dtype).reshape(B, *v.shape[1:])
    pos = pb.contiguous().view(torch.int32).reshape(B, w).long()
    return k, v, torch.clamp(pos, min=0), pos >= 0


def _pool_write(cache: Params, table: torch.Tensor, qpos: torch.Tensor,
                live: Optional[torch.Tensor], k: torch.Tensor, v: torch.Tensor,
                sh: Optional[Shard], plan: Optional["PoolPlan"] = None):
    """Write the rows' K/V at ``qpos`` [b, w] (``live`` [b, w] or None:
    every column) into the pool through ``table``; dead and unmapped
    writes go to the trash page.  On a mesh with the rows split over data
    the writes of every row are gathered first (``table`` is then every
    row's), and with the pool split by in-page position a rank writes the
    offsets it holds and sends the rest to the trash page.  With ``plan``
    (the parked pool) the positions go into the device's ``pkpos`` and the
    keys to their host pages (``_host_pool_write``)."""
    n_phys, ps_loc = cache["pkpos"].shape
    trash = n_phys - 1
    if _on_mesh(sh) and sh.rows_split:
        if live is None:
            live = torch.ones(qpos.shape, dtype=torch.bool, device=qpos.device)
        k, v, qpos, live = _gather_writes(sh, k, v, qpos, live)
    if _by_page(cache, sh):  # in-page positions over model: the owner writes
        pid, off = _paged_write_ids(table, qpos, sh.page_size, trash, live)
        pid = torch.where(off // ps_loc == sh.par.sp_rank, pid, trash)
        off = off % ps_loc
    else:
        pid, off = _paged_write_ids(table, qpos, ps_loc, trash, live)
    if plan is None:
        _paged_write(cache, pid, off, k, v, qpos)
        return
    cache["pkpos"][pid, off] = qpos.to(torch.int32)
    _host_pool_write(cache, plan, k, v, qpos, live, sh)


@dataclasses.dataclass
class PoolPlan:
    """One step of the host-streamed pool, the same in every attention
    layer, made on the host from its copy of the table and the rows'
    spans: ``live`` the logical pages [0, live) fetched and merged,
    ``rows`` this rank's (logical page, page id) pairs a row
    (``HostOffload.fetch_pages``); the write pass's buffer of
    ``wslots`` pages a row, logical page j in slot j mod ``wslots``,
    ``wrows`` its (slot, page id) pairs a row (every row that writes into
    this rank's pool) and ``wspans`` the (row, buffer offset, page id,
    in-page offset, n) slices copied back."""

    live: int
    rows: list
    wslots: int
    wrows: list
    wspans: list


def _pool_plan(cache: Params, table, host_table, bounds, n_host_chunks: int,
               sh: Optional[Shard], device) -> Optional[PoolPlan]:
    """The step's ``PoolPlan`` when the pool streams from the host
    (``n_host_chunks`` and a page table), else None.  ``host_table`` is
    ``table`` as the host holds it (numpy; a streaming step reads no
    table from the device); ``bounds`` every row's span of positions it
    may write (None: every position).  A pool on the card must be parked
    to stream, and a parked pool must stream (ValueError)."""
    pk = next((leaf for key, leaf, _ in pool_leaves(cache) if key.endswith("pk")), None)
    if table is None or pk is None:
        return None
    if torch.device(device).type == "cuda" and bool(n_host_chunks) != (pk.device.type == "cpu"):
        raise ValueError("the page pool streams from the host only when it is parked there: "
                         "n_host_chunks > 0 with init_paged_cache(..., host=True), "
                         f"0 with a device pool (n_host_chunks={n_host_chunks}, pool on "
                         f"{pk.device})")
    if not n_host_chunks:
        return None
    if host_table is None:
        raise ValueError("the parked pool plans its step from the host's copy of the page "
                         "table: pass host_table")
    tab = host_table
    B, max_pages = tab.shape
    n_phys, ps_loc = pk.shape[-4], pk.shape[-3]
    trash = n_phys - 1
    ps = sh.page_size if _on_mesh(sh) else ps_loc
    m0 = sh.par.sp_rank * ps_loc if ps_loc < ps else 0  # the rank's in-page slice
    S = max_pages * ps
    bounds = _default_bounds(B, S) if bounds is None else [(a, min(e, S - 1)) for a, e in bounds]
    r0, r1 = (sh.r0, sh.r1) if _on_mesh(sh) else (0, B)
    hi = max((e for a, e in bounds[r0:r1] if a <= e), default=-1)
    live = hi // ps + 1 if hi >= 0 else 0
    rows = [[(j, int(t) if t >= 0 else trash) for j, t in enumerate(row[:live])]
            for row in tab[r0:r1]]
    pages = [range(a // ps, e // ps + 1) if a <= e else range(0) for a, e in bounds]
    wslots = max((len(r) for r in pages), default=0)
    wrows, wspans = [], []
    for i, ((a, e), js) in enumerate(zip(bounds, pages)):
        pairs = []
        for j in js:
            pid = int(tab[i, j])
            lo = max(max(a, j * ps) - j * ps, m0)
            end = min(min(e, j * ps + ps - 1) - j * ps + 1, m0 + ps_loc)
            if pid < 0 or pid == trash or lo >= end:
                continue
            if any(q == pid for _, q in pairs):
                raise ValueError(f"row {i} maps page {pid} at two logical pages it may write: a "
                                 "parked pool writes a page through one table entry")
            slot = j % wslots
            pairs.append((slot, pid))
            wspans.append((i, slot * ps_loc + lo - m0, pid, lo - m0, end - lo))
        wrows.append(sorted(pairs))
    return PoolPlan(live, rows, wslots, wrows, wspans)


def _stream_pages(cache: Params, plan: PoolPlan, table: torch.Tensor, attend,
                  zero: SoftmaxState) -> SoftmaxState:
    """The parked pool's history pass: ``attend(k, v, kpos, mapped)`` over
    the live logical pages ``plan.live``, fetched in one pass (a row's run
    of consecutive pages is one copy) and merged into ``zero``; ``table``
    is this rank's rows of the page table on the device (``pkpos`` stays
    there)."""
    if not plan.live:
        return zero
    policy = PL.host_offload(table.device)
    b, ps = table.shape[0], cache["pkpos"].shape[1]
    host_pages["fetched"] += 2 * sum(len(r) for r in plan.rows)
    kc, vc = (policy.fetch_pages(cache[key], plan.rows, plan.live) for key in ("pk", "pv"))
    kc, vc = kc.wait(), vc.wait()
    tab = table[:, : plan.live]
    n = plan.live * ps
    kp = cache["pkpos"][torch.clamp(tab, min=0)].reshape(b, n)
    okp = (tab >= 0)[:, :, None].expand(b, plan.live, ps).reshape(b, n)
    return merge(zero, attend(kc, vc, kp, okp))


def _host_pool_write(cache: Params, plan: PoolPlan, k: torch.Tensor, v: torch.Tensor,
                     qpos: torch.Tensor, live: Optional[torch.Tensor], sh: Optional[Shard]):
    """The rows' new K/V (k, v [B, w, h, dh] at ``qpos`` [B, w], ``live``
    or None: every column) into their host pages: the pages the rows'
    spans touch are fetched into a buffer (``plan.wrows``), the keys
    scattered into it at their device-side positions (a column that is
    dead, or whose offset another model rank holds, goes to the buffer's
    last row, never read), and the spans copied back (``plan.wspans``),
    every copy on the copy stream.  The spans are upper bounds: a
    position not written goes back as it came."""
    if not plan.wspans:
        return
    policy = PL.host_offload(k.device)
    ps_loc = cache["pkpos"].shape[1]
    ps = sh.page_size if _on_mesh(sh) else ps_loc
    m0 = sh.par.sp_rank * ps_loc if ps_loc < ps else 0
    host_pages["fetched"] += 2 * sum(len(r) for r in plan.wrows)
    kb = policy.fetch_pages(cache["pk"], plan.wrows, plan.wslots, pad=1)
    vb = policy.fetch_pages(cache["pv"], plan.wrows, plan.wslots, pad=1)
    off = qpos % ps - m0
    idx = torch.remainder(torch.div(qpos, ps, rounding_mode="floor"), plan.wslots) * ps_loc + off
    ok = (off >= 0) & (off < ps_loc)
    if live is not None:
        ok = ok & live
    idx = torch.where(ok, idx, plan.wslots * ps_loc)
    bi = torch.arange(qpos.shape[0], device=qpos.device)[:, None]
    kb, vb = kb.wait(), vb.wait()
    kb[bi, idx] = k.to(kb.dtype)
    vb[bi, idx] = v.to(vb.dtype)
    policy.write_pages(cache["pk"], kb, plan.wspans)
    policy.write_pages(cache["pv"], vb, plan.wspans)


def _by_page(cache: Params, sh: Optional[Shard]) -> bool:
    """Does the pool split its in-page positions over model?"""
    return _on_mesh(sh) and cache["pkpos"].shape[1] < sh.page_size


def _rows(table: torch.Tensor, sh: Optional[Shard]) -> torch.Tensor:
    """This rank's rows of the page table (all rows off a mesh)."""
    return table[sh.r0:sh.r1] if _on_mesh(sh) else table


def _decode_attention_paged(cfg: ModelConfig, p: Params, x: torch.Tensor, cache: Params,
                            pos: torch.Tensor, table: torch.Tensor, sh: Optional[Shard] = None,
                            plan: Optional[PoolPlan] = None):
    """Paged twin of ``_decode_attention``: the token's K/V go into its
    page (the trash page for a row whose position is unmapped), then it
    attends to its row's gathered pages (with ``plan``, the parked pool's,
    fetched from the host).  x [b, 1, d]; pos int64 [b]; table [b,
    max_pages] (on a mesh every row's: the rank's are [r0, r1)).  Returns
    attn_out [b, 1, d]."""
    b = x.shape[0]
    heads = sh.heads(cfg) if _on_mesh(sh) else None
    q, k, v = _qkv(cfg, p, x, heads)  # [b, 1, h, dh]
    q = L.apply_rope(q, pos[:, None], cfg.rope_theta)
    k = L.apply_rope(k, pos[:, None], cfg.rope_theta)
    _pool_write(cache, table, pos[:, None], None, k, v, sh, plan)
    hq = q.shape[2]
    g = cfg.num_heads // cfg.num_kv_heads
    qf = q[:, 0].float()  # [b, hq, dh]

    def attend(kc, vc, kp, okp):
        s = torch.einsum("bhd,bshd->bhs", qf, _expand(kc, g)) * cfg.head_dim ** -0.5
        ok = okp & (kp >= 0) & (kp <= pos[:, None])
        return _masked_state(s, ok[:, None, :], _expand(vc, g), "bhs,bshd->bhd")

    if plan is None:
        st = attend(*_paged_gather(cache, _rows(table, sh)))
    else:
        st = _stream_pages(cache, plan, _rows(table, sh), attend, SoftmaxState(
            qf.new_zeros(qf.shape), qf.new_full(qf.shape[:2], NEG_INF), qf.new_zeros(qf.shape[:2])))
    if _by_page(cache, sh):
        st = _merge_ranks(st, sh.par.sp_group)
    o = finalize(st).reshape(b, 1, hq * cfg.head_dim).to(x.dtype)
    return _out(cfg, p, o, heads, sh)


def _keep_state(cache: Params, state: Params):
    """Copy a recurrent mixer's new state into its cache tensors in place."""
    for k, v in state.items():
        cache[k].copy_(v)


def _ffn(cfg, p, h, sh: Optional[Shard] = None):
    """The attention block's second half: norm2, then the MoE FFN (unchunked,
    as the JAX package's decode and chunk steps run it) or the MLP.  With
    the rows split over data the MoE FFN runs on every row (gathered): its
    groups and capacity are the whole batch's."""
    hn2 = L.apply_norm(cfg, p["norm2"], h)
    if "moe" in p:
        if _on_mesh(sh) and sh.rows_split:
            y = MOE.moe_ffn(cfg, p["moe"], P.gather_rows(hn2, sh.par.dp_group))[0]
            return h + y[sh.r0:sh.r1]
        return h + MOE.moe_ffn(cfg, p["moe"], hn2)[0]
    return h + L.mlp_block(cfg, p["mlp"], hn2)


def _chan(cfg: ModelConfig, sh: Optional[Shard]):
    """The recurrent mixers' ``chan`` on a mesh (``Shard.channels``)."""
    return sh.channels(cfg) if _on_mesh(sh) else None


def _decode_block(cfg, par, kind, p, h, cache, pos, n_host_chunks=0, bounds=None, table=None,
                  sh=None, plan=None):
    if kind == "ssm":
        y, st = M.mamba_decode_step(cfg, p["mixer"], L.apply_norm(cfg, p["norm"], h), cache,
                                    _chan(cfg, sh))
        _keep_state(cache, st)
        return h + y
    hn = L.apply_norm(cfg, p["norm1"], h)
    if kind == "rglru":
        y, st = R.rglru_decode_step(cfg, p["mixer"], hn, cache, _chan(cfg, sh))
        _keep_state(cache, st)
        h = h + y
    elif table is not None and "pk" in cache:  # the paged pool (attn blocks only)
        h = h + _decode_attention_paged(cfg, p["attn"], hn, cache, pos, table, sh, plan)
    else:
        window = cfg.window if kind == "local_attn" else 0
        h = h + _decode_attention(cfg, par, p["attn"], hn, cache, pos, window=window,
                                  n_host_chunks=0 if window else n_host_chunks,
                                  bounds=bounds, sh=sh)
    return _ffn(cfg, p, h, sh)


def _positions(pos, b: int, device) -> torch.Tensor:
    return torch.as_tensor(pos, dtype=torch.int64, device=device).expand(b)


def _check_shard(par, sh: Optional[Shard], table) -> None:
    if P.distributed(par) and not _on_mesh(sh):
        raise ValueError("a serve step on a mesh takes its Shard (shard=): the cache is the "
                         "rank's and the inputs its rows")
    if _on_mesh(sh) and table is not None and not sh.page_size:
        raise ValueError("a paged step on a mesh needs the pool's page_size in its Shard")


@torch.no_grad()
def decode_step(cfg: ModelConfig, par: Optional[ParallelContext], params: Params,
                cache: Params, inp: Dict[str, torch.Tensor], pos, n_host_chunks: int = 0,
                bounds=None, table: Optional[torch.Tensor] = None,
                shard: Optional[Shard] = None, host_table=None):
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
               package, and raises if the KV is on the host); with a table,
               stream the parked pool's live pages.
      bounds — with n_host_chunks: per row (lo, hi), host ints, the span
               its ``pos`` lies in; slabs (pages) past every hi are skipped
               and each row's span is written back.  None: every position.
               On a mesh every row's, as ``table``.
      table  — optional integer [b, max_pages] page table on the cache's
               device: the attention blocks read and write the paged pool
               (``init_paged_cache``) through it.
      shard  — on a serve mesh, the step's ``Shard``: ``cache`` is the
               rank's (``init_cache(..., par=)``), the inputs are its rows
               [r0, r1) and ``table`` holds every row.
      host_table — with n_host_chunks and a table, the table as the host
               holds it (numpy), which the step plans its fetches from
               (required: a step reads nothing from the device); a row's
               run of consecutive pages is one copy and every live page
               is merged at once (the merge order differs from JAX's
               page-by-page one in the last bits).

    Returns (logits [b, padded_vocab] fp32, cache)."""
    _check_shard(par, shard, table)
    if cfg.frontend == "audio_frames":
        h = inp["frame_embeds"]
        pos = _positions(pos, h.shape[0], h.device)
        h = h + L.sinusoidal_pos_emb(pos, cfg.d_model).to(h.dtype)[:, None]
    else:
        tokens = inp["tokens"]
        pos = _positions(pos, tokens.shape[0], tokens.device)
        h = params["embed"][tokens].to(getattr(torch, cfg.param_dtype))
    plan = _pool_plan(cache, table, host_table, bounds, n_host_chunks, shard, h.device)
    pat, n_cycles, tail = T.layout_of(cfg)
    for c in range(n_cycles):
        cyc_p, cyc_cache = T.cycle(params["cycles"], c), T.cycle(
            {k: cache[k] for k in cache if k != "tail"}, c)
        for i, kind in enumerate(pat):
            h = _decode_block(cfg, par, kind, cyc_p[f"pos{i}"], h, cyc_cache[f"pos{i}"], pos,
                              n_host_chunks, bounds, table, shard, plan)
    for i, kind in enumerate(tail):
        h = _decode_block(cfg, par, kind, params["tail"][i], h, cache["tail"][i], pos,
                          n_host_chunks, bounds, table, shard, plan)
    h = L.apply_norm(cfg, params["final_norm"], h)
    logits = (h[:, 0] @ T.head_matrix(cfg, params)).float()
    return logits, cache


# ---------------------------------------------------------------------------
# fused mixed step: one prefill chunk OR one decode token per batch row
# ---------------------------------------------------------------------------


def _chunk_attention(cfg: ModelConfig, par: Optional[ParallelContext], p: Params,
                     x: torch.Tensor, cache: Params, qpos: torch.Tensor, live: torch.Tensor,
                     *, window: int = 0, n_host_chunks: int = 0, bounds=None,
                     sh: Optional[Shard] = None):
    """Chunk-window attention against the cache at per-row offsets.

    x [b, cp, d]; qpos [b, cp] int64 the position of each window token;
    live [b] how many leading window tokens are real (0: the row is a
    no-op).  The online-softmax merge of (a) the PRE-write cache masked on
    ``kpos`` (host-streamed in slabs under ``n_host_chunks``) and (b) the
    window against its own live keys under an intra-window causal mask;
    then the live keys are written (ring buffers keep only the last S
    live tokens).  On a mesh (``sh``) the rank attends over its heads or
    its positions as ``_decode_attention`` does.  Returns attn out [b, cp,
    d]; the cache is updated in place."""
    b, cp, _ = x.shape
    heads = sh.heads(cfg) if _on_mesh(sh) else None
    q, k, v = _qkv(cfg, p, x, heads)  # [b, cp, h, dh]
    q = L.apply_rope(q, qpos, cfg.rope_theta)
    k = L.apply_rope(k, qpos, cfg.rope_theta)
    S, S_loc = cache["kpos"].shape[1], cache["k"].shape[1]
    base = sh.par.sp_rank * S_loc if S_loc < S else 0
    if window:
        window = min(window, S)  # ring capacity bounds the visible window
    hq = q.shape[2]
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
        bounds = _default_bounds(b, S) if bounds is None else _mine(bounds, sh)
        hist = _stream_kv(cache, n_host_chunks, x.device, bounds, attend,
                          zero_state((b, hq, cp, cfg.head_dim), device=x.device),
                          writes=(slot, k, v, wmask), base=base)
        if S_loc < S:  # positions over model: the ranks' states, merged
            hist = _merge_ranks(hist, sh.par.sp_group)
    else:
        hist = attend(cache["k"], cache["v"], cache["kpos"][:, base:base + S_loc])
        if S_loc < S:  # positions over model: every rank's partial state, merged
            hist = _merge_ranks(hist, sh.par.sp_group)
        _write_rows(cache["k"], base, slot, k, wmask)
        _write_rows(cache["v"], base, slot, v, wmask)
    _write_rows(cache["kpos"], 0, slot, qpos.to(torch.int32), wmask)
    o = finalize(merge(hist, _intra_state(cfg, qt, k, v, qpos, key_live, window)))
    o = o.transpose(1, 2).reshape(b, cp, hq * cfg.head_dim).to(x.dtype)
    return _out(cfg, p, o, heads, sh)


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
                           qpos: torch.Tensor, live: torch.Tensor, table: torch.Tensor,
                           sh: Optional[Shard] = None, plan: Optional[PoolPlan] = None):
    """Paged twin of ``_chunk_attention``: the window against its rows'
    gathered pages of the PRE-write pool, merged with the window against
    its own live keys; then the live keys go into their pages and the dead
    columns to the trash page.  Pages a row shares (radix prefixes) are
    only read: the manager gives every written page one owner.  On a mesh
    ``table`` holds every row (the rank's are [r0, r1)).  With ``plan`` the
    parked pool streams its live pages.  Returns attn out [b, cp, d]; the
    pool is updated in place."""
    b, cp, _ = x.shape
    heads = sh.heads(cfg) if _on_mesh(sh) else None
    q, k, v = _qkv(cfg, p, x, heads)  # [b, cp, h, dh]
    q = L.apply_rope(q, qpos, cfg.rope_theta)
    k = L.apply_rope(k, qpos, cfg.rope_theta)
    hq = q.shape[2]
    g = cfg.num_heads // cfg.num_kv_heads
    qt = q.float().transpose(1, 2)  # [b, hq, cp, dh]
    key_live = torch.arange(cp, device=x.device)[None, :] < live[:, None]  # [b, cp]

    def attend(kc, vc, kp, okp):
        s_ = torch.einsum("bhqd,bshd->bhqs", qt, _expand(kc, g)) * cfg.head_dim ** -0.5
        ok = (okp & (kp >= 0))[:, None, :] & (kp[:, None, :] <= qpos[:, :, None])
        return _masked_state(s_, ok[:, None], _expand(vc, g), "bhqs,bshd->bhqd")

    if plan is None:
        hist = attend(*_paged_gather(cache, _rows(table, sh)))
    else:
        hist = _stream_pages(cache, plan, _rows(table, sh), attend,
                             zero_state((b, hq, cp, cfg.head_dim), device=x.device))
    if _by_page(cache, sh):  # in-page positions over model: the ranks' states, merged
        hist = _merge_ranks(hist, sh.par.sp_group)
    _pool_write(cache, table, qpos, key_live, k, v, sh, plan)
    o = finalize(merge(hist, _intra_state(cfg, qt, k, v, qpos, key_live)))
    o = o.transpose(1, 2).reshape(b, cp, hq * cfg.head_dim).to(x.dtype)
    return _out(cfg, p, o, heads, sh)


def _chunk_block(cfg, par, kind, p, h, cache, qpos, live, n_host_chunks=0, bounds=None,
                 table=None, sh=None, plan=None):
    if kind == "ssm":
        y, st = M.mamba_chunk_step(cfg, p["mixer"], L.apply_norm(cfg, p["norm"], h), cache,
                                   live, _chan(cfg, sh))
        _keep_state(cache, st)
        return h + y
    hn = L.apply_norm(cfg, p["norm1"], h)
    if kind == "rglru":
        y, st = R.rglru_chunk_step(cfg, p["mixer"], hn, cache, live, _chan(cfg, sh))
        _keep_state(cache, st)
        h = h + y
    elif table is not None and "pk" in cache:  # the paged pool (attn blocks only)
        h = h + _chunk_attention_paged(cfg, p["attn"], hn, cache, qpos, live, table, sh, plan)
    else:
        window = cfg.window if kind == "local_attn" else 0
        h = h + _chunk_attention(cfg, par, p["attn"], hn, cache, qpos, live, window=window,
                                 n_host_chunks=0 if window else n_host_chunks, bounds=bounds,
                                 sh=sh)
    return _ffn(cfg, p, h, sh)


@torch.no_grad()
def chunk_step(cfg: ModelConfig, par: Optional[ParallelContext], params: Params,
               cache: Params, toks: torch.Tensor, offset, live, n_host_chunks: int = 0,
               bounds=None, table: Optional[torch.Tensor] = None,
               shard: Optional[Shard] = None, host_table=None):
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
      table, host_table — the page table for the paged
               pool and the parked pool's fetch, as ``decode_step``'s.
      shard  — on a serve mesh, the step's ``Shard``, as ``decode_step``'s.

    Recurrent blocks (ssm, rglru, the local_attn ring) take the
    state-at-length gather (``mamba.mamba_chunk_step`` /
    ``rglru.rglru_chunk_step``), so chunked prefill of any length is exact
    for them.  Returns (logits [b, padded_vocab] fp32 at each row's LAST
    live token, cache)."""
    if cfg.frontend == "audio_frames":
        raise ValueError("chunk_step feeds token ids; the audio_frames "
                         "frontend consumes frame embeddings")
    _check_shard(par, shard, table)
    b, cp = toks.shape
    device = toks.device
    offset = _positions(offset, b, device)
    live = _positions(live, b, device)
    qpos = offset[:, None] + torch.arange(cp, device=device)[None, :]  # [b, cp]
    h = params["embed"][toks].to(getattr(torch, cfg.param_dtype))
    plan = _pool_plan(cache, table, host_table, bounds, n_host_chunks, shard, device)
    pat, n_cycles, tail = T.layout_of(cfg)
    for c in range(n_cycles):
        cyc_p, cyc_cache = T.cycle(params["cycles"], c), T.cycle(
            {k: cache[k] for k in cache if k != "tail"}, c)
        for i, kind in enumerate(pat):
            h = _chunk_block(cfg, par, kind, cyc_p[f"pos{i}"], h, cyc_cache[f"pos{i}"], qpos,
                             live, n_host_chunks, bounds, table, shard, plan)
    for i, kind in enumerate(tail):
        h = _chunk_block(cfg, par, kind, params["tail"][i], h, cache["tail"][i], qpos, live,
                         n_host_chunks, bounds, table, shard, plan)
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
