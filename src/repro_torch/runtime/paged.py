"""Paged KV-cache pool with radix-tree prefix reuse, a host spill tier and
the SLO-aware scheduler: the JAX package's ``runtime/paged.py``.

The dense engine gives every slot a ``[b, S]`` cache row, so memory
scales with ``slots x worst-case length`` and two requests that share a
prefix prefill it twice.  Here the full-attention blocks keep one
slot-shared pool of fixed-size pages (``models/serve.py::
init_paged_cache``), read through per-slot page tables:

* ``PagePool`` — free-list allocator with refcounts over ``n_pages``
  physical pages; a page is free iff its refcount is 0.
* ``RadixTree`` — prefix index at full-page granularity, one node a page
  keyed on the page's tokens: a new prompt maps its longest
  already-prefilled full-page prefix onto the pages that hold its KV,
  copy-free.  The tree holds one reference a page, so a cached prefix
  outlives its request until evicted (LRU leaves that nobody else maps).
* ``SpillPool`` — the host tier behind the tree: eviction demotes a cold
  page's payload into it, the next prefix hit promotes it into a fresh
  device page, and ``save``/``restore`` keep the whole prefix cache in a
  ``.npz`` (the JAX package's format: either package reads the other's).
* ``PagedCacheManager`` — page tables (``[slots, max_pages]`` int32; -1
  unmapped, a FREE row on the trash page), admission with a request's
  whole page reserve (so a table is fixed through a segment and running
  dry is an admit-time error), copy-on-write, and the radix lifecycle.
  Host metadata only: what the device must do comes back as an
  ``AdmitPlan``.
* ``paged_reset``, ``copy_page``, ``promote_page`` — the plan's device
  work, in place on the pool's tensors.
* ``PagedServeEngine`` — the fused mixed-step ``ServeEngine`` over the
  pool: admission maps radix hits and prefill starts after them,
  release returns the slot's pages.
* ``SLOPagedServeEngine`` — priority and deadline admission, preemption
  by publish-and-release, prefill-budget pauses on the trash row.

Everything but the engines' segments is pure Python and numpy on the
host; the page programs and the demotion read run at admission, outside a
segment.  The spill tier keeps its payloads as CPU tensors (the pool's
dtype, bf16 included).

On a serve mesh (``par``; ``models/serve.py::cache_shardings``) every rank
runs the same host metadata (tables, tree, spill slots: the same
decisions), and holds its slice of the pool (kv heads, or in-page
positions, over ``model``; whole over ``data``): the page programs and
the demotion read work on the rank's slice, and the spill tier keeps the
rank's slice of a demoted page.  ``save_kv_store`` all-gathers the slices
over ``model`` and the replica's first rank writes whole pages in the
JAX layout; ``restore_kv_store`` gives each rank its slice of the file's
pages, so a store written on any mesh (or by the JAX package) restores on
any other.  ``SLOPagedServeEngine`` stays on one rank, as the JAX CLI keeps
``--sched`` off a mesh.

With ``n_host_chunks > 0`` the pool is the JAX package's two-tier pool:
its ``pk``/``pv`` are parked in pinned host memory from the start and the
segments stream their live pages (``models/serve.py``); ``pkpos`` and the
table stay on the device.  On a mesh each rank parks only its data share
of its model slice (``SV.host_shardings``: the slice's in-page positions,
else its kv heads, else its pages, split over data; where the model slice
is the whole pool, its pages split over every rank of the mesh), so the
replica parks the pool once over all its ranks, as the JAX package shards
a parked pool over every mesh axis; a step all-gathers the shares of the
pages it reads.  The page programs and the demotion read work on the
rank's share as on a device slice, after ``HostOffload.settle`` has
waited for the segment's write-backs; the spill tier keeps the share, and
the store's save gathers the shares over data before the slices over
model.  A pool split by pages reads a page from the rank that parks it
(an all-gather over the ranks the pages split over, ``_read_page``), so a
COW copy is a read and a promote, and only the owner writes a page.  On a
mesh none of whose pool dims (in-page positions, kv heads, pages) its
ranks divide, the JAX package keeps the pool in device memory and warns
once: so does the engine (``pool_on_device``; ``SV.pool_share_dim``), at
its ``cache_shardings`` slice, streaming nothing (``host_kv_bytes`` 0).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ModelConfig
from repro_torch.core import parallel as PAR
from repro_torch.core.parallel import ParallelContext
from repro_torch.models import serve as SV
from repro_torch.models.transformer import layout_of
from repro_torch.runtime import decode_loop as DL
from repro_torch.runtime import placement as PL
from repro_torch.runtime import telemetry as TM

Params = Dict[str, Any]
Rows = Dict[str, torch.Tensor]


class PoolExhausted(ValueError):
    """No free pages for an admission.  A ``ValueError``, but caught apart
    so that the engine can defer a request while other slots hold pages."""


# ---------------------------------------------------------------------------
# page allocator
# ---------------------------------------------------------------------------


class PagePool:
    """Free-list page allocator with refcounts: a page is on the free list
    iff its refcount is 0; ``alloc`` never hands out a live page;
    ``share``/``release`` touch live pages only."""

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        self.n_pages = n_pages
        self.refcount = np.zeros(n_pages, np.int64)
        self._free = list(range(n_pages - 1, -1, -1))  # stack: page 0 first

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise PoolExhausted(f"all {self.n_pages} pages in use")
        pid = self._free.pop()
        self.refcount[pid] = 1
        return pid

    def share(self, pid: int) -> None:
        if self.refcount[pid] <= 0:
            raise ValueError(f"share of free page {pid}")
        self.refcount[pid] += 1

    def release(self, pid: int) -> None:
        rc = int(self.refcount[pid])
        if rc <= 0:
            raise ValueError(f"release of free page {pid}")
        self.refcount[pid] = rc - 1
        if rc == 1:
            self._free.append(pid)


# ---------------------------------------------------------------------------
# host-resident spill tier
# ---------------------------------------------------------------------------


class SpillPool:
    """``n_spill`` page-payload slots on the host, one CPU buffer a pool
    leaf, allocated from the first payload written so the tier knows no
    model shapes.  The radix tree owns every entry (no refcounts)."""

    def __init__(self, n_spill: int):
        if n_spill < 1:
            raise ValueError(f"n_spill must be >= 1, got {n_spill}")
        self.n_spill = n_spill
        self._free = list(range(n_spill - 1, -1, -1))  # stack: slot 0 first
        self.data: Dict[str, torch.Tensor] = {}  # leaf key -> [n_spill, ...]
        self.demotions = 0  # payload writes to date (demotes + restores)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.n_spill - len(self._free)

    def alloc(self) -> int:
        """A free slot, or ``-1`` when the tier is full: the caller then
        drops the page, so spill never blocks eviction."""
        return self._free.pop() if self._free else -1

    def free(self, sid: int) -> None:
        if sid in self._free:
            raise ValueError(f"free of unallocated spill slot {sid}")
        self._free.append(sid)

    def write(self, sid: int, rows: Rows) -> None:
        """Store one page's rows (``models/serve.py::page_rows`` keys)."""
        for k, row in rows.items():
            buf = self.data.get(k)
            if buf is None:
                buf = self.data[k] = torch.zeros((self.n_spill, *row.shape), dtype=row.dtype)
            buf[sid] = row
        self.demotions += 1

    def read(self, sid: int) -> Rows:
        return {k: buf[sid] for k, buf in self.data.items()}


# ---------------------------------------------------------------------------
# radix tree (full-page prefix index)
# ---------------------------------------------------------------------------


def _page_key(tokens) -> bytes:
    """Exact content key of one page of prompt tokens."""
    return np.asarray(tokens, np.int32).tobytes()


class _Node:
    __slots__ = ("children", "parent", "key", "page", "spill", "last_used")

    def __init__(self, parent: Optional["_Node"] = None, key: Optional[bytes] = None):
        self.children: Dict[bytes, "_Node"] = {}
        self.parent, self.key = parent, key
        self.page = -1   # device page, or -1 when demoted to the spill tier
        self.spill = -1  # spill slot, or -1 when device-resident
        self.last_used = 0


# bit-cast carriers of the dtypes numpy has no type for (bf16, fp8), by width
_CARRIER = {1: (np.uint8, np.uint8), 2: (np.int16, np.uint16)}


def _to_numpy(t: torch.Tensor, name: str, out: Dict[str, np.ndarray]) -> None:
    """``out["rows/<name>"]`` = ``t``; a dtype numpy lacks is stored as the
    unsigned int of its width beside ``out["dtype/<name>"]``, its name, as
    the JAX package stores ml_dtypes' types."""
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
        signed, unsigned = _CARRIER[t.element_size()]
        out[f"dtype/{name}"] = np.str_(str(t.dtype).split(".")[-1])
        out[f"rows/{name}"] = t.view(getattr(torch, np.dtype(signed).name)).numpy().view(unsigned)
    else:
        out[f"rows/{name}"] = t.numpy()


def _from_numpy(a: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    if dtype_name is None:
        return torch.from_numpy(np.array(a))
    signed, _ = _CARRIER[a.dtype.itemsize]
    return torch.from_numpy(np.array(a).view(signed)).view(getattr(torch, dtype_name))


class RadixTree:
    """Full-page prefix index over a ``PagePool``.

    Only full pages are indexed: a prompt's partial tail page is its
    slot's own, so shared pages are never written (writes go to the
    suffix a request prefills itself, or through copy-on-write).  The tree
    owns one refcount a page it references.  With a ``SpillPool`` a node
    is device-resident (``page >= 0``) or spilled (``spill >= 0``), and
    along any root-to-leaf path the resident nodes form a prefix (demotion
    runs leaf-first, promotion re-admits a matched chain).  Demotion reads
    a page's payload through ``read_page`` (the engine's read of the live
    pool) at evict time, before the freed page can be reallocated."""

    def __init__(self, page_size: int, pool: PagePool, spill: Optional[SpillPool] = None):
        self.page_size, self.pool = page_size, pool
        self.spill = spill
        self.read_page: Optional[Callable[[int], Rows]] = None
        self.root = _Node()
        self._clock = 0
        self.pages = 0  # device pages the tree references
        self.telemetry: Optional[TM.Telemetry] = None  # the owning engine's

    @property
    def spilled(self) -> int:
        return self.spill.used_count if self.spill is not None else 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match_nodes(self, tokens: Sequence[int]) -> List[_Node]:
        """Node chain of the longest indexed full-page prefix of ``tokens``
        (resident or spilled); touches LRU stamps, takes no refcount."""
        ps = self.page_size
        node, out, t = self.root, [], self._tick()
        for i in range(len(tokens) // ps):
            child = node.children.get(_page_key(tokens[i * ps:(i + 1) * ps]))
            if child is None:
                break
            child.last_used = t
            out.append(child)
            node = child
        return out

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Physical pages of the longest indexed full-page prefix (a
        spilled entry reads -1)."""
        return [nd.page for nd in self.match_nodes(tokens)]

    def insert(self, tokens: Sequence[int], pids: Sequence[int]) -> int:
        """Index ``pids`` as the leading full pages of ``tokens``.  A resident
        node wins (first prefill published) and takes no extra reference; a
        spilled twin is re-pointed at the fresh page and its host copy
        dropped.  Returns the pages newly device-indexed."""
        ps = self.page_size
        node, t, added = self.root, self._tick(), 0
        for i, pid in enumerate(pids):
            key = _page_key(tokens[i * ps:(i + 1) * ps])
            child = node.children.get(key)
            if child is None:
                child = _Node(parent=node, key=key)
                child.page = int(pid)
                node.children[key] = child
                self.pool.share(int(pid))
                self.pages += 1
                added += 1
            elif child.page < 0:
                child.page = int(pid)
                self.pool.share(int(pid))
                self.pages += 1
                if self.spill is not None:
                    self.spill.free(child.spill)
                child.spill = -1
                added += 1
            child.last_used = t
            node = child
        return added

    def promote(self, nd: _Node, pid: int) -> int:
        """Re-admit spilled ``nd`` at device page ``pid`` (the tree takes
        over the caller's fresh reference).  Returns the spill slot whose
        payload goes into ``pid``; the caller frees it after that copy."""
        sid = nd.spill
        nd.page, nd.spill = int(pid), -1
        self.pages += 1
        return sid

    def _evictable(self, nd: _Node) -> bool:
        """Resident, referenced by the tree alone, with no resident child."""
        return (nd.page >= 0
                and int(self.pool.refcount[nd.page]) == 1
                and not any(c.page >= 0 for c in nd.children.values()))

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` least-recently-used device pages that only
        the tree references, in one pass over a heap of the evictable
        leaves (a parent joins when its last resident child leaves; no two
        evictable nodes share a stamp, so the order is the JAX package's).
        With a spill tier each victim's payload is demoted through
        ``read_page`` and its node survives spilled; without one, or with
        the tier full, the node is dropped (a node whose spilled children
        a drop would strand stays).  Returns the pages freed."""
        heap: List[Tuple[int, int, _Node]] = []
        n = 0

        def push(nd: _Node) -> None:
            nonlocal n
            if nd is not self.root and self._evictable(nd):
                n += 1
                heapq.heappush(heap, (nd.last_used, n, nd))

        stack = [self.root]
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            push(nd)
        can_spill = self.spill is not None and self.read_page is not None
        freed = 0
        while freed < n_pages and heap:
            _, _, victim = heapq.heappop(heap)
            if not self._evictable(victim):
                continue  # stale heap entry
            sid = self.spill.alloc() if can_spill else -1
            if sid >= 0:
                self.spill.write(sid, self.read_page(victim.page))
                if self.telemetry is not None:
                    self.telemetry.registry.counter("pool_demotions").inc()
                    self.telemetry.event("pool.demote", page=int(victim.page), spill=int(sid))
                self.pool.release(victim.page)
                victim.page, victim.spill = -1, sid
            elif victim.children:
                continue  # a drop would strand spilled descendants: keep
            else:
                if self.telemetry is not None:
                    self.telemetry.registry.counter("pool_evictions").inc()
                    self.telemetry.event("pool.evict", page=int(victim.page))
                del victim.parent.children[victim.key]
                self.pool.release(victim.page)
            self.pages -= 1
            freed += 1
            push(victim.parent)
        return freed

    # -- persistence -----------------------------------------------------
    def save(self, path: str, read_page: Optional[Callable[[int], Rows]] = None,
             whole: Optional[Callable[[Rows], Rows]] = None, write: bool = True) -> int:
        """Write the prefix cache to one ``.npz``, the JAX package's format:
        ``page_size``; ``parent`` [N] int64 node indices (-1: root; parents
        before children); ``tokens`` [N, ps] int32 page keys; ``last_used``
        [N] int64; one ``rows/<leaf key>`` [N, ...] a pool leaf (spilled
        payloads from the tier, resident ones through ``read_page``), a
        dtype numpy lacks bit-cast to an unsigned int of its width with
        its name in ``dtype/<leaf key>``.  ``whole`` maps the stacked rows
        to whole pages (a mesh rank's slices, gathered); ``write=False``
        skips the file (a rank that only gathers).  Returns the pages
        saved."""
        read_page = read_page or self.read_page
        order: List[_Node] = []
        index: Dict[int, int] = {id(self.root): -1}
        stack = [self.root]
        while stack:
            nd = stack.pop()
            for c in nd.children.values():
                index[id(c)] = len(order)
                order.append(c)
                stack.append(c)
        ps = self.page_size
        payload: Dict[str, List[torch.Tensor]] = {}
        for nd in order:
            if nd.page >= 0:
                if read_page is None:
                    raise ValueError("save needs a read_page callback to fetch "
                                     "device-resident pages (the engine's page reader)")
                rows = read_page(nd.page)
            else:
                rows = self.spill.read(nd.spill)
            for k, v in rows.items():
                payload.setdefault(k, []).append(v)
        rows = {k: torch.stack(v) for k, v in payload.items()}
        if whole is not None:
            rows = whole(rows)
        if not write:
            return len(order)
        stacks: Dict[str, np.ndarray] = {}
        for k, v in rows.items():
            _to_numpy(v, k, stacks)
        np.savez(
            path, page_size=np.int64(ps),
            parent=np.array([index[id(nd.parent)] for nd in order], np.int64),
            tokens=(np.stack([np.frombuffer(nd.key, np.int32) for nd in order])
                    if order else np.zeros((0, ps), np.int32)),
            last_used=np.array([nd.last_used for nd in order], np.int64),
            **stacks)
        return len(order)

    def restore(self, path: str, part: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
                ) -> int:
        """Load a saved prefix cache into the spill tier (no device page is
        touched; payloads promote at their first hit).  A live entry wins
        over its saved twin; entries past the tier's free slots are
        dropped, their descendants with them.  ``part(key, row)`` cuts a
        whole page's row to what this rank holds (a mesh rank's slice).
        Returns the pages restored."""
        if self.spill is None:
            raise ValueError("restore needs a spill tier (spill_pages > 0): restored "
                             "pages are host-resident until their first prefix hit")
        with np.load(path) as data:
            ps = int(data["page_size"])
            if ps != self.page_size:
                raise ValueError(f"kv store was saved at page_size={ps}; this "
                                 f"pool uses page_size={self.page_size}")
            parents, tokens = data["parent"], data["tokens"]
            stamps = data["last_used"]
            rows = {k[len("rows/"):]: data[k] for k in data.files if k.startswith("rows/")}
            dtypes = {k: str(data[f"dtype/{k}"]) for k in rows if f"dtype/{k}" in data.files}
        nodes: List[Optional[_Node]] = [None] * len(parents)
        restored = 0
        for i in range(len(parents)):
            pnode = self.root if parents[i] < 0 else nodes[int(parents[i])]
            if pnode is None:  # parent dropped: drop the subtree
                continue
            key = tokens[i].tobytes()
            child = pnode.children.get(key)
            if child is not None:  # the live entry wins over its stored twin
                nodes[i] = child
                continue
            sid = self.spill.alloc()
            if sid < 0:
                continue  # tier full: drop (descendants follow)
            page = {k: _from_numpy(a[i], dtypes.get(k)) for k, a in rows.items()}
            self.spill.write(sid, page if part is None else
                             {k: part(k, row) for k, row in page.items()})
            child = _Node(parent=pnode, key=key)
            child.spill = sid
            child.last_used = int(stamps[i])
            pnode.children[key] = child
            nodes[i] = child
            restored += 1
        if len(stamps):
            self._clock = max(self._clock, int(stamps.max()) + 1)
        return restored


# ---------------------------------------------------------------------------
# page tables + admission + COW
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdmitPlan:
    """What the engine must do on the device before the slot's first
    segment.  Demotions never appear: eviction copies payloads to the host
    at once (a freed page may be reallocated within this very plan)."""

    resume: int                        # prompt tokens already cached (skipped)
    fresh_pages: List[int]             # newly allocated: to invalidate
    cow: List[Tuple[int, int]]         # (src, dst) page copies
    hit_pages: int                     # full pages served from the tree
    # (spill slot, dst page, keep-below offset): promotes of spilled prefix
    # pages (keep = page_size) and the spilled-COW case (keep = resume % ps)
    promote: List[Tuple[int, int, int]] = dataclasses.field(default_factory=list)
    # spill slots to free once the promotes are done
    free_spill: List[int] = dataclasses.field(default_factory=list)


class PagedCacheManager:
    """Page tables, admission control, COW and the radix lifecycle, on the
    host.  ``admit`` returns an ``AdmitPlan``; ``table`` is the int32 numpy
    array the engine ships to the device when it changes.  A request's
    worst-case reserve (``ceil((plen + budget) / ps)`` pages) is allocated
    at admission, so the pool never runs dry mid-segment."""

    def __init__(self, n_pages: int, page_size: int, use_radix: bool = True,
                 spill_pages: int = 0):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.pool = PagePool(n_pages)
        self.page_size = page_size
        self.spill = SpillPool(spill_pages) if use_radix and spill_pages > 0 else None
        self.radix = RadixTree(page_size, self.pool, spill=self.spill) if use_radix else None
        self.trash = n_pages  # physical index of the FREE rows' write sink
        self.table: Optional[np.ndarray] = None
        self._slot_pages: List[List[int]] = []

    def set_page_reader(self, read_page: Callable[[int], Rows]) -> None:
        """Register the engine's device-to-host page read (demotion, save)."""
        if self.radix is not None:
            self.radix.read_page = read_page

    def begin(self, slots: int, max_pages: int) -> None:
        """Start a workload with all-FREE tables.  Slots an aborted workload
        left admitted are released; radix-indexed pages persist."""
        for s, pages in enumerate(self._slot_pages):
            if pages:
                self.release(s)
        self.table = np.full((slots, max_pages), self.trash, np.int32)
        self._slot_pages = [[] for _ in range(slots)]

    # -- admission -------------------------------------------------------
    def admit(self, slot: int, tokens: Sequence[int], budget: int,
              label: str = "request") -> AdmitPlan:
        """Map ``slot`` for ``tokens`` plus ``budget`` generated tokens:
        radix-matched prefix pages shared (copy-free), the rest of the
        reserve fresh.  A match over the whole prompt takes its last page
        by copy-on-write: the resumed prefill rewrites the final token (for
        the first-token logits) and a shared page is never written."""
        if self._slot_pages[slot]:
            raise ValueError(f"slot {slot} admitted twice without release")
        ps = self.page_size
        plen = len(tokens)
        need = max(-(-(plen + budget) // ps), 1)
        if need > self.table.shape[1]:
            raise ValueError(
                f"{label}: needs {need} pages ({plen} prompt + {budget} new "
                f"tokens at page_size={ps}) but the table is only "
                f"{self.table.shape[1]} pages wide")
        nodes = self.radix.match_nodes(tokens) if self.radix is not None else []
        m = len(nodes)
        resume = min(m * ps, max(plen - 1, 0))
        n_shared = m if resume == m * ps else m - 1
        shared = nodes[:n_shared]
        cow_src = nodes[n_shared:]  # 0 or 1 node (the full-cover case)
        # references on every resident matched page first (the COW source's
        # is dropped once its copy is recorded), so eviction cannot free a
        # page this plan reads
        for nd in (*shared, *cow_src):
            if nd.page >= 0:
                self.pool.share(nd.page)
        fresh_needed = need - n_shared + sum(1 for nd in shared if nd.page < 0)
        if self.pool.free_count < fresh_needed and self.radix is not None:
            self.radix.evict(fresh_needed - self.pool.free_count)
        if self.pool.free_count < fresh_needed:
            for nd in (*shared, *cow_src):
                if nd.page >= 0:
                    self.pool.release(nd.page)
            raise PoolExhausted(
                f"{label}: needs {fresh_needed} free pages ({plen} prompt + "
                f"{budget} new tokens at page_size={ps}, {n_shared} prefix "
                f"pages shared) but only {self.pool.free_count} of "
                f"{self.pool.n_pages} are free")
        promote: List[Tuple[int, int, int]] = []
        free_spill: List[int] = []
        pids: List[int] = []
        for nd in shared:
            if nd.page < 0:  # spilled prefix page: promote it back
                pid = self.pool.alloc()        # the tree's reference
                sid = self.radix.promote(nd, pid)
                promote.append((sid, pid, ps))  # keep the whole page
                free_spill.append(sid)
                self.pool.share(pid)           # the slot's reference
            pids.append(nd.page)
        cow: List[Tuple[int, int]] = []
        if cow_src:
            nd = cow_src[0]
            dst = self.pool.alloc()
            if nd.page < 0:  # spilled COW source: straight into the slot's page
                promote.append((nd.spill, dst, resume % ps))
            else:
                cow.append((nd.page, dst))
                self.pool.release(nd.page)  # drop the protective reference
            pids.append(dst)
        fresh = [self.pool.alloc() for _ in range(need - len(pids))]
        pids.extend(fresh)
        self.table[slot, :] = -1
        self.table[slot, :need] = pids
        self._slot_pages[slot] = pids
        return AdmitPlan(resume=resume, fresh_pages=fresh, cow=cow, hit_pages=m,
                         promote=promote, free_spill=free_spill)

    def release(self, slot: int) -> None:
        """Return the slot's pages (tree-shared ones live on by the tree's
        reference) and park its row on the trash page."""
        for pid in self._slot_pages[slot]:
            self.pool.release(pid)
        self._slot_pages[slot] = []
        self.table[slot, :] = self.trash

    # -- copy-on-write ---------------------------------------------------
    def ensure_writable(self, slot: int, logical_j: int) -> Optional[Tuple[int, int]]:
        """Make logical page ``logical_j`` of ``slot`` its own: the (src,
        dst) copy to make when it was shared, else None."""
        pid = int(self.table[slot, logical_j])
        if pid < 0 or pid == self.trash:
            raise ValueError(f"slot {slot} logical page {logical_j} unmapped")
        if int(self.pool.refcount[pid]) <= 1:
            return None
        dst = self.pool.alloc()
        self.pool.release(pid)
        self.table[slot, logical_j] = dst
        self._slot_pages[slot][logical_j] = dst
        return pid, dst

    # -- radix lifecycle -------------------------------------------------
    def complete_prefill(self, slot: int, tokens: Sequence[int]) -> int:
        """Publish the prompt's full pages for later requests to map."""
        if self.radix is None:
            return 0
        full = len(tokens) // self.page_size
        if not full:
            return 0
        return self.radix.insert(list(tokens)[: full * self.page_size],
                                 self._slot_pages[slot][:full])

    @property
    def pages_in_use(self) -> int:
        return self.pool.used_count

    @property
    def spilled_pages(self) -> int:
        return self.spill.used_count if self.spill is not None else 0

    # -- persistence -----------------------------------------------------
    def save(self, path: str, read_page: Optional[Callable[[int], Rows]] = None,
             **kw) -> int:
        """Persist the prefix cache (``RadixTree.save``'s format and hooks)."""
        if self.radix is None:
            raise ValueError("save: this pool has no radix prefix cache (use_radix=False)")
        return self.radix.save(path, read_page, **kw)

    def restore(self, path: str, **kw) -> int:
        """Load a persisted prefix cache into the spill tier."""
        if self.radix is None:
            raise ValueError("restore: this pool has no radix prefix cache (use_radix=False)")
        return self.radix.restore(path, **kw)


# ---------------------------------------------------------------------------
# page programs (in place on the pool's tensors)
# ---------------------------------------------------------------------------


def paged_reset(cache: Params, i: Optional[int], page_ids: Sequence[int]) -> Params:
    """Slot ``i``'s per-slot rows reset as ``reset_slot`` does (dense
    ``kpos`` -1, recurrent states 0; None: a row another data rank holds)
    and the pool's ``pkpos`` at ``page_ids`` (the real fresh pages) to -1:
    a new page may hold a former owner's entries, which must not alias the
    new sequence's positions."""
    if i is not None:
        DL.reset_slot(cache, i)
    for key, leaf, stacked in SV.pool_leaves(cache):
        if key.endswith("pkpos"):
            ids = torch.as_tensor(list(page_ids), dtype=torch.long, device=leaf.device)
            if stacked:
                leaf[:, ids] = -1
            else:
                leaf[ids] = -1
    return cache


def _masked_row(row: torch.Tensor, key: str, keep_below: int, base: int) -> torch.Tensor:
    """A page's row with its ``pkpos`` entries at in-page offsets ``>=
    keep_below`` invalidated (k and v rows as they are); the row's first
    entry sits at offset ``base``."""
    if not key.endswith("pkpos"):
        return row
    keep = base + torch.arange(row.shape[-1], device=row.device) < keep_below
    return torch.where(keep, row, torch.full_like(row, -1))


def copy_page(cache: Params, src: int, dst: int, drop_from: int, base: int = 0) -> Params:
    """Copy physical page ``src`` into ``dst`` in every attention layer
    (the COW primitive).  Entries at offsets ``>= drop_from`` are
    invalidated in the copy: the resumed prefill recomputes and rewrites
    them, and a valid stale entry would count twice against the chunk's
    own keys.  ``base`` is the in-page offset of the pool's first entry
    (a model rank's when the pool splits its in-page positions)."""
    for key, leaf, stacked in SV.pool_leaves(cache):
        row = _masked_row(SV.page_of(leaf, stacked, src), key, drop_from, base)
        SV.page_of(leaf, stacked, dst).copy_(row)
    return cache


def promote_page(cache: Params, dst: int, rows: Rows, keep_below: int,
                 base: int = 0, local: Optional[Callable[[str, int], Optional[int]]] = None
                 ) -> Params:
    """Scatter one spilled page's host rows (keyed as ``page_rows``'s) into
    physical page ``dst``, the inverse of the demotion read; ``pkpos``
    entries at offsets ``>= keep_below`` are invalidated (a plain promote
    keeps the whole page, the spilled-COW case drops the tail the resumed
    prefill recomputes, as ``copy_page``'s ``drop_from``; ``base`` as
    there).  ``local(key, pid)``, where a leaf holds only some pages (a
    parked pool split by pages), is page ``pid``'s index in the
    leaf, None where another rank holds it."""
    for key, leaf, stacked in SV.pool_leaves(cache):
        pid = dst if local is None else local(key, dst)
        if pid is None:
            continue
        row = _masked_row(rows[key].to(leaf.device), key, keep_below, base)
        SV.page_of(leaf, stacked, pid).copy_(row)
    return cache


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class PagedServeEngine(DL.ServeEngine):
    """Continuous batching over the slot-shared paged pool.

    The fused mixed-step scheduler is ``ServeEngine``'s; its segments read
    and write K/V through the page table, which goes to the device only
    after it changes.  What changes is the slot lifecycle:

      admit   — radix-match the prompt, map the shared prefix pages
                copy-free (prefill resumes after them; spilled ones are
                promoted into fresh pages first), allocate the rest of the
                reserve, invalidate the fresh pages, make the COW copies.
                A request that does not fit defers while other slots hold
                pages and raises ``ValueError`` (naming it) when the pool
                could never take it.
      release — return the slot's pages; radix-published prefixes stay.

    With ``spill_pages > 0`` eviction demotes cold radix pages into the
    host ``SpillPool``, and ``save_kv_store``/``restore_kv_store`` keep
    the prefix cache across engines.  ``radix`` takes effect only for
    pure global-attention layouts: a recurrent block (ssm, rglru, a
    local_attn ring) folds the whole prefix into per-slot state that a
    mapped page cannot restore, so those get the pool with ``resume = 0``.
    The pool and its radix-indexed pages persist across ``generate``
    calls.  On a serve mesh (``par``) the engine is one rank of a sharded
    replica: its pool is the rank's slice (module docstring).  With
    ``n_host_chunks > 0`` the pool is parked in pinned host memory and
    its live pages stream through the steps (module docstring).
    """

    def __init__(self, cfg: ModelConfig, params: Params, *, slots: int, bucket: int,
                 max_new_tokens: int, page_size: int = 16, n_pages: int = 0,
                 radix: bool = True, spill_pages: int = 0, prefill_chunk: int = 0,
                 n_host_chunks: int = 0, sampling: DL.SamplingConfig = DL.GREEDY,
                 stop_tokens: Sequence[int] = (), pad_id: int = 0, segment: int = 8,
                 par: Optional[ParallelContext] = None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if n_pages <= 0:  # dense-equivalent capacity
            n_pages = slots * -(-(bucket + max_new_tokens) // page_size)
        # a mesh none of whose pool dims its ranks divide: the pool stays in
        # device memory, as the JAX package keeps it, and streams nothing
        self.pool_on_device = bool(n_host_chunks) and PAR.distributed(par) and (
            SV.pool_share_dim(par.dp, par.sp, page_size, cfg.num_kv_heads, n_pages + 1)
            == SV.POOL_ON_DEVICE)
        if self.pool_on_device:
            PL.warn_once(f"pool offload skipped: no pool dim (page_size={page_size}, "
                         f"kv_heads={cfg.num_kv_heads}, pages+1={n_pages + 1}) divides mesh "
                         f"size {par.dp * par.sp}; the pool stays in device memory")
        super().__init__(cfg, params, slots=slots, bucket=bucket,
                         max_new_tokens=max_new_tokens, prefill_chunk=prefill_chunk,
                         n_host_chunks=0 if self.pool_on_device else n_host_chunks,
                         sampling=sampling, stop_tokens=stop_tokens, pad_id=pad_id,
                         segment=segment, par=par)
        self.slab_chunks = n_host_chunks  # S rounds as the JAX engine's, the pool kept too
        self.page_size = int(page_size)
        self.n_pages = int(n_pages)
        pat, _, tail = layout_of(cfg)
        self.radix_enabled = bool(radix) and all(k == "attn" for k in (*pat, *tail))
        self.kv = PagedCacheManager(self.n_pages, self.page_size, use_radix=self.radix_enabled,
                                    spill_pages=spill_pages if self.radix_enabled else 0)
        self.kv.set_page_reader(self._read_page)
        if self.kv.radix is not None:
            self.kv.radix.telemetry = self.telemetry
        if self.cp % self.page_size and self.page_size % self.cp:
            raise ValueError(
                f"prefill_chunk={self.cp} and page_size={self.page_size} "
                f"must divide one another: radix prefix hits resume prefill "
                f"at a page boundary, and only a mutually-dividing grid "
                f"keeps every chunk window inside the slot's allocated page "
                f"reserve")
        if self.shard is not None:
            self.shard = SV.Shard(par, slots, self.page_size)
        # the one pool (on a mesh the rank's slice), updated in place by
        # every segment and page program: demotion and save read it live
        self._pool = SV.init_paged_cache(cfg, slots, self.n_pages, self.page_size, self.device,
                                         par=par, host=bool(self.n_host_chunks))
        # on a mesh, each pool leaf's model dim (None: whole) and the dim of a
        # page's data share a rank parks (None: none), by leaf key; the keys
        # of the leaves a parked pool splits by pages instead, over the data
        # ranks or, where the model slice is the whole pool, over the mesh
        # (the group, this rank's index in it and the pages it parks)
        self._pool_dims: Dict[str, Optional[int]] = {}
        self._share_dims: Dict[str, Optional[int]] = {}
        self._by_pages: set = set()
        self._page_group, self._page_rank, owners = None, 0, 1
        if self.shard is not None:
            self._page_group, self._page_rank, owners = par.dp_group, par.dp_rank, par.dp
            meta = SV.init_paged_cache(cfg, slots, self.n_pages, self.page_size, "meta")
            plan = SV.host_shardings(cfg, par.dp, par.sp, meta, self.n_host_chunks)
            for key, _, stacked in SV.pool_leaves(meta):
                dims = plan
                for k in key.split("/"):
                    dims = dims[int(k)] if isinstance(dims, list) else dims[k]
                self._share_dims[key], self._pool_dims[key] = dims
                if dims[0] is not None and dims[0] == int(stacked):  # the page dim
                    self._share_dims[key] = None
                    self._by_pages.add(key)
                    if dims[1] == dims[0]:  # the pages over the mesh
                        self._pool_dims[key] = None
                        self._page_group, self._page_rank = par.mesh_group, par.rank
                        owners = par.dp * par.sp
        self._pages_local = (self.n_pages + 1) // owners if self._by_pages else 0
        # the in-page offset of this rank's first pool entry: its share of
        # the page when the pool splits the in-page positions over model
        split = any(d is not None for k, d in self._pool_dims.items() if k.endswith("pkpos"))
        self._page_base = par.sp_rank * (self.page_size // par.sp) if split else 0
        self._table_dev: Optional[torch.Tensor] = None  # device copy, None when stale
        self._inserted = [True] * slots
        self._prompts: List[List[int]] = [[] for _ in range(slots)]

    def _settle(self) -> None:
        """A parked pool: wait for the write-backs still on the copy stream
        before the host reads or writes the pool itself."""
        if self.n_host_chunks:
            PL.host_offload(self.device).settle()

    def _host_kv_stats(self, stats, cache, mark) -> None:
        super()._host_kv_stats(stats, cache, mark)
        if self.pool_on_device:  # asked to park, kept on the device: nothing parked
            stats.update(host_kv_bytes=0, host_kv_slabs=0, host_kv_pages=0,
                         pool_on_device=True)

    def _local_page(self, key: str, pid: int) -> Optional[int]:
        """Physical page ``pid``'s index in this rank's pool leaf ``key``
        (None: another rank parks it)."""
        if key not in self._by_pages:
            return pid
        owner, i = divmod(pid, self._pages_local)
        return i if owner == self._page_rank else None

    def _read_page(self, pid: int) -> Rows:
        """One physical page's rows on the host (demotion, save, and the
        COW read of a pool split by pages): a leaf split by pages gathers
        the page from the rank that parks it (one call a leaf)."""
        self._settle()
        if not self._by_pages:
            return SV.page_rows(self._pool, int(pid))
        rows = {}
        for key, leaf, stacked in SV.pool_leaves(self._pool):
            if key not in self._by_pages:
                rows[key] = SV.page_of(leaf, stacked, int(pid)).to("cpu", copy=True)
                continue
            mine = self._local_page(key, int(pid))
            page = SV.page_of(leaf, stacked, 0 if mine is None else mine)
            parts = PAR.gather_rows(page[None].to(self.device), self._page_group,
                                    "gather_pages")
            rows[key] = parts[int(pid) // self._pages_local].to("cpu", copy=True)
        return rows

    # -- prefix-cache persistence ----------------------------------------
    def _whole_pages(self, rows: Rows) -> Rows:
        """Stacked page rows [N, ...] of this rank's slices -> whole pages:
        each leaf's data shares (a parked pool's) all-gathered over data,
        then each leaf split over model over model (one call a leaf and
        axis), put together along the split dim in rank order."""
        out = {}
        for key, t in rows.items():
            for dim, n, group in ((self._share_dims[key], self.par.dp, self.par.dp_group),
                                  (self._pool_dims[key], self.par.sp, self.par.sp_group)):
                if dim is None or not len(t):
                    continue
                parts = PAR.gather_rows(t.to(self.device), group, "gather_pages")
                t = torch.cat(parts.view(n, *t.shape).unbind(0), dim=dim).cpu()
            out[key] = t
        return out

    def _part(self, key: str, row: torch.Tensor) -> torch.Tensor:
        """This rank's slice of one whole page's row (dims without N): its
        model slice, then its data share of that where it parks one."""
        for dim, n, i in ((self._pool_dims[key], self.par.sp, self.par.sp_rank),
                          (self._share_dims[key], self.par.dp, self.par.dp_rank)):
            if dim is not None:
                size = row.shape[dim - 1] // n
                row = row.narrow(dim - 1, i * size, size)
        return row.clone()

    def _replica_barrier(self) -> None:
        """Every rank of the replica waits for every other (the model group,
        then the data group, reach all of them)."""
        dist.barrier(group=self.par.sp_group)
        dist.barrier(group=self.par.dp_group)

    def save_kv_store(self, path: str) -> int:
        """Persist the radix tree and every cached page's payload to ``path``.
        On a mesh every rank of the replica calls it: the slices are
        gathered, the replica's first rank writes and every rank returns
        once the file is whole."""
        if self.shard is not None:
            n = self.kv.save(path, self._read_page, whole=self._whole_pages,
                             write=self.par.rank == 0)
            self._replica_barrier()
        else:
            n = self.kv.save(path, self._read_page)
        self.kv_store_saved_pages = getattr(self, "kv_store_saved_pages", 0) + n
        self.telemetry.registry.counter("kvstore_saved_pages").inc(n)
        self.telemetry.event("kvstore.save", pages=n)
        return n

    def restore_kv_store(self, path: str) -> int:
        """Load a persisted prefix cache into the spill tier (pages promote
        to the device at their first radix hit); on a mesh each rank keeps
        its slice of every page."""
        n = self.kv.restore(path, part=self._part if self.shard is not None else None)
        self.kv_store_restored_pages = getattr(self, "kv_store_restored_pages", 0) + n
        self.telemetry.registry.counter("kvstore_restored_pages").inc(n)
        self.telemetry.event("kvstore.restore", pages=n)
        return n

    # -- slot lifecycle --------------------------------------------------
    def _begin(self, B: int, P: int, S: int):
        max_pages = -(-(P + self.max_new) // self.page_size)
        self.kv.begin(B, max_pages)
        self._table_dev = None
        self._inserted = [True] * B
        self.last_stats.update({
            "page_size": self.page_size, "n_pages": self.n_pages,
            "max_pages": max_pages, "radix": self.radix_enabled,
            "prompt_tokens": 0, "prefilled_tokens": 0,
            "prefix_hit_tokens": 0, "cow_copies": 0, "deferrals": 0,
            "pages_peak": 0, "radix_pages": 0,
            "spill_pages": 0 if self.kv.spill is None else self.kv.spill.n_spill,
            "spill_promotes": 0, "spilled_pages": self.kv.spilled_pages,
        })
        return self._pool

    def _admit(self, cache, s: int, idx: int, prompt, active: bool,
               budget: Optional[int] = None):
        st = self.last_stats
        budget = self.max_new if budget is None else int(budget)
        prompt = list(prompt)
        try:
            plan = self.kv.admit(s, prompt, budget, label=f"request {idx}")
        except PoolExhausted as e:
            if active:  # running slots will release pages: retry next round
                st["deferrals"] += 1
                self.telemetry.event("pool.defer", request=idx, slot=s)
                return None
            raise ValueError(str(e)) from None
        paged_reset(cache, self._local_slot(s), plan.fresh_pages)
        local = self._local_page if self._by_pages else None
        for sid, dst, keep in plan.promote:
            promote_page(cache, dst, self.kv.spill.read(sid), keep, self._page_base, local)
            st["spill_promotes"] += 1
        if plan.promote:
            self.telemetry.event("pool.promote", request=idx, slot=s, n=len(plan.promote))
        for sid in plan.free_spill:  # the copies are made: the slots are free
            self.kv.spill.free(sid)
        for src, dst in plan.cow:
            if self._by_pages:  # the source may be another rank's: read it from there
                promote_page(cache, dst, self._read_page(src), plan.resume % self.page_size,
                             self._page_base, local)
            else:
                copy_page(cache, src, dst, plan.resume % self.page_size, self._page_base)
            st["cow_copies"] += 1
            self.telemetry.event("pool.cow", request=idx, slot=s, src=int(src), dst=int(dst))
        self._table_dev = None  # the table changed: ship it at the next dispatch
        st["resets"] += 1
        st["prompt_tokens"] += len(prompt)
        st["prefilled_tokens"] += len(prompt) - plan.resume
        st["prefix_hit_tokens"] += plan.resume
        st["pages_peak"] = max(st["pages_peak"], self.kv.pages_in_use)
        self._inserted[s] = False
        self._prompts[s] = prompt  # what complete_prefill publishes: pend is on the device
        return cache, plan.resume

    def _dispatch(self, cache, mode, tok, pos, gen, rem, pfill, pend, plen, table=None,
                  host_table=None):
        if self._table_dev is None:
            self._table_dev = torch.as_tensor(self.kv.table, dtype=torch.long,
                                              device=self.device)
        return super()._dispatch(cache, mode, tok, pos, gen, rem, pfill, pend, plen,
                                 self._table_dev, self.kv.table)

    def _post_dispatch(self, mode, pfill, plen, pend, owner) -> None:
        self._settle()
        for s in range(self.slots):
            if owner[s] is None or self._inserted[s] or pfill[s] < plen[s]:
                continue
            self._inserted[s] = True
            self.kv.complete_prefill(s, self._prompts[s][: int(plen[s])])

    def _release(self, s: int) -> None:
        self.kv.release(s)
        self._table_dev = None  # the table changed: ship it at the next dispatch

    def _end(self, cache) -> None:
        if self.kv.radix is not None:
            self.last_stats["radix_pages"] = self.kv.radix.pages
            self.last_stats["spilled_pages"] = self.kv.spilled_pages


# ---------------------------------------------------------------------------
# SLO-aware scheduling
# ---------------------------------------------------------------------------


class SLOPagedServeEngine(PagedServeEngine):
    """Priority- and deadline-aware admission with preemption over the
    paged pool; the segments are ``PagedServeEngine``'s, the scheduling is
    host Python around them:

      * **Preempt = publish + release.**  A decoding slot's cached KV holds
        ``prompt + emitted`` up to ``pos`` (a mid-prefill slot's up to
        ``pfill``), so preemption publishes that prefix's full pages into
        the radix tree and releases the slot; under pressure the pages
        demote to the spill tier as any radix page does.  Resume is a
        re-admission of ``prompt + emitted`` with the remaining budget: the
        radix match maps the pages back and prefill restarts at the match
        boundary.  Under greedy sampling the output is the uninterrupted
        run's.
      * **Pause = the row on the trash page.**  A mid-prefill slot that
        has used its prefill-chunk budget while others decode has its
        table row saved and trashed and its mode set FREE, so the next
        dispatch is decode only; the row is restored a round later.

    ``policy`` ``"slo"`` admits by ``(priority, itl_slo, arrival)``,
    preempts a strictly less urgent slot for a waiting request and applies
    the budgets (``Request.prefill_chunks`` or ``prefill_budget``);
    ``"fifo"`` admits by arrival with neither, the baseline with the same
    greedy outputs.  Both see a request only from its ``arrival`` (on the
    dispatch-step clock).  Recurrent layouts are refused: a page cannot
    restore a recurrent state.
    """

    def __init__(self, cfg: ModelConfig, params: Params, *, policy: str = "slo",
                 prefill_budget: int = 0, **kw):
        if policy not in ("slo", "fifo"):
            raise ValueError(f"policy must be 'slo' or 'fifo', got {policy!r}")
        kw.setdefault("radix", True)
        if PAR.distributed(kw.get("par")):
            raise ValueError("SLOPagedServeEngine runs on one rank (the JAX CLI keeps --sched "
                             "off a mesh): route QoS requests to sharded replicas through "
                             "launch/router.py")
        super().__init__(cfg, params, **kw)
        if not self.radix_enabled:
            pat, _, tail = layout_of(cfg)
            kinds = sorted({k for k in (*pat, *tail) if k != "attn"})
            if kinds:
                raise ValueError(
                    f"SLOPagedServeEngine: layout contains recurrent blocks "
                    f"{kinds}; preemption resumes a request from its mapped "
                    f"KV pages, but recurrent state is integrated over the "
                    f"whole prefix and cannot be restored from a page — "
                    f"resumed output would silently diverge.  Serve this "
                    f"layout with PagedServeEngine (FIFO, no preemption); "
                    f"see the carried ROADMAP item 'radix reuse for "
                    f"recurrent layouts'")
            raise ValueError("SLOPagedServeEngine requires radix=True: preempted "
                             "requests resume through radix prefix matching")
        self.policy = policy
        self.prefill_budget = int(prefill_budget)

    def _capacity(self, prompts: Sequence[Sequence[int]]) -> Tuple[int, int]:
        """A preempted request re-admits ``prompt + emitted``, so the
        pending buffer covers ``longest + max_new`` (S whole host-KV slabs
        under ``n_host_chunks``, as the JAX engine rounds it)."""
        longest = max((len(p) for p in prompts), default=1)
        P = -(-max(self.bucket, longest + self.max_new) // self.cp) * self.cp
        return P, self._slabs(P + self.max_new)

    def _key(self, r: DL.Request, seq: int, ridx: int) -> Tuple:
        if self.policy == "slo":
            return (r.priority, r.itl_slo, seq, ridx)
        return (seq, ridx)

    # -- the scheduler ---------------------------------------------------
    def generate(self, prompts: Sequence[Union[DL.Request, Sequence[int]]],
                 generator: Optional[torch.Generator] = None) -> List[List[int]]:
        """Run every request to completion under arrivals, priorities and
        budgets.  Returns one token list per request, in input order (a
        preempted request's stitched over its incarnations).

        ``last_stats`` gains ``policy``, ``preemptions``,
        ``prefill_pauses`` and per request a ``requests`` record
        ({arrival, admit_step, first_emit, last_emit, max_gap,
        preemptions, n_emitted, priority, tier, prompt_len}, on the
        dispatch-step clock)."""
        reqs = [DL.as_request(p) for p in prompts]
        self._validate([r.tokens for r in reqs])
        n = len(reqs)
        B = self.slots
        P, S = self._capacity([r.tokens for r in reqs])
        stats = self.telemetry.stats_view({
            "steps": self.telemetry.steps_ring(), "dispatches": 0,
            "resets": 0, "capacity": S,
            "pending_len": P, "policy": self.policy, "preemptions": 0,
            "prefill_pauses": 0,
            "requests": [{"arrival": int(r.arrival), "priority": r.priority,
                          "tier": r.tier, "prompt_len": len(r.tokens),
                          "admit_step": None, "first_emit": None,
                          "last_emit": None, "max_gap": 0, "preemptions": 0,
                          "n_emitted": 0} for r in reqs]})
        self.last_stats = stats
        rstat = stats["requests"]
        cache = self._begin(B, P, S)
        mark = self._mark()
        mode = np.full(B, DL.FREE, np.int32)
        tok = np.zeros((B, 1), np.int32)
        pos = np.zeros(B, np.int32)
        rem = np.zeros(B, np.int32)
        pfill = np.zeros(B, np.int32)
        plen = np.ones(B, np.int32)
        pend_dev = torch.full((B, P), self.pad_id, dtype=torch.int32, device=self.device)
        plen_dev = torch.ones(B, dtype=torch.int32, device=self.device)
        owner: List[Optional[int]] = [None] * B
        emitted: List[List[int]] = [[] for _ in reqs]
        paused = [False] * B        # mid-prefill, parked on the trash row
        saved_rows: List[Optional[np.ndarray]] = [None] * B
        skip = [0] * B              # paused rounds left before resume
        burst = [0] * B             # prefill chunks since admit/resume
        order = sorted(range(n), key=lambda i: (reqs[i].arrival, i))
        fptr = 0
        ready: List[Tuple] = []     # heap of self._key(...) entries
        seq = n                     # requeue seqnos, past all initial ones
        step = 0                    # dispatch-step clock

        def preempt(s: int) -> None:
            nonlocal seq
            ridx = owner[s]
            stream = list(reqs[ridx].tokens) + emitted[ridx]
            # the KV of positions [0, pos) when decoding, [0, pfill) mid-
            # prefill: publish its full pages, then release
            cached = int(pos[s]) if mode[s] == DL.DECODE else int(pfill[s])
            self.kv.complete_prefill(s, stream[:cached])
            self._release(s)
            owner[s] = None
            mode[s] = DL.FREE
            burst[s] = 0
            rstat[ridx]["preemptions"] += 1
            stats["preemptions"] += 1
            self.telemetry.event("request.preempt", request=ridx, slot=s, step=step,
                                 session=reqs[ridx].session, cached=cached)
            heapq.heappush(ready, self._key(reqs[ridx], seq, ridx))
            seq += 1

        def preempt_for(head_pri: int) -> bool:
            if self.policy != "slo":
                return False
            cands = [s for s in range(B)
                     if owner[s] is not None and not paused[s]
                     and mode[s] in (DL.DECODE, DL.PREFILL)
                     and reqs[owner[s]].priority > head_pri]
            if not cands:
                return False
            preempt(max(cands, key=lambda s: (reqs[owner[s]].priority, s)))
            return True

        while True:
            # resume paused prefills (one whole round parked first)
            for s in range(B):
                if not paused[s]:
                    continue
                if skip[s] > 0:
                    skip[s] -= 1
                    continue
                self.kv.table[s, :] = saved_rows[s]
                self._table_dev = None
                mode[s] = DL.PREFILL
                paused[s] = False
                burst[s] = 0
                self.telemetry.event("request.pause_resume", request=owner[s], slot=s,
                                     step=step)
            # arrivals up to the current step become schedulable
            while fptr < n and reqs[order[fptr]].arrival <= step:
                ridx = order[fptr]
                fptr += 1
                self.telemetry.event("request.queued", request=ridx,
                                     session=reqs[ridx].session, step=int(reqs[ridx].arrival),
                                     priority=reqs[ridx].priority, tier=reqs[ridx].tier)
                heapq.heappush(ready, self._key(reqs[ridx], ridx, ridx))
            # admission: fill free slots from the ready heap, preempting
            # less urgent slots when the head outranks them
            progress = True
            while ready and progress:
                progress = False
                free = [s for s in range(B) if owner[s] is None]
                if not free:
                    progress = preempt_for(reqs[ready[0][-1]].priority)
                    continue
                s = free[0]
                entry = heapq.heappop(ready)
                ridx = entry[-1]
                r = reqs[ridx]
                pending = list(r.tokens) + emitted[ridx]
                budget = self.max_new - len(emitted[ridx])
                active = any(o is not None for o in owner)
                admitted = self._admit(cache, s, ridx, pending, active, budget=budget)
                if admitted is None:  # pool exhausted: retry after a preemption
                    heapq.heappush(ready, entry)
                    progress = preempt_for(r.priority)
                    continue
                cache, resume = admitted
                owner[s] = ridx
                np_ = len(pending)
                self._stage(pend_dev, plen_dev, s, pending)
                plen[s], pfill[s], mode[s] = np_, resume, DL.PREFILL
                rem[s], pos[s], tok[s] = budget, 0, self.pad_id
                burst[s] = 0
                first_admit = rstat[ridx]["admit_step"] is None
                if first_admit:
                    rstat[ridx]["admit_step"] = step
                self.telemetry.event("request.admit" if first_admit else "request.resume",
                                     request=ridx, slot=s, step=step, session=r.session,
                                     prompt_len=np_, prefix_hit=int(resume))
                progress = True
            if all(o is None for o in owner):
                if fptr < n:  # idle: jump the clock to the next arrival
                    step = max(step, int(reqs[order[fptr]].arrival))
                    continue
                break
            n_prefilling = int((mode == DL.PREFILL).sum())
            with TM.timed_dispatch(self.telemetry, stats, prefilling=n_prefilling,
                                   step=step) as td:
                emits, valids, aux = self._dispatch(cache, mode, tok, pos, generator, rem,
                                                    pfill, pend_dev, (plen_dev, plen))
                cache = aux["cache"]
                mode, tok, pos, rem, pfill, em, va = DL.harvest(aux, emits, valids)
                td.emitted = int(va.sum())
            self._post_dispatch(mode, pfill, plen, pend_dev, owner)
            for s in range(B):
                if owner[s] is None:
                    continue
                ridx = owner[s]
                toks = [int(t) for t, v in zip(em[s], va[s]) if v]
                if toks:
                    rs = rstat[ridx]
                    if rs["first_emit"] is None:
                        rs["first_emit"] = step
                    if rs["last_emit"] is not None:
                        rs["max_gap"] = max(rs["max_gap"], step - rs["last_emit"])
                    rs["last_emit"] = step
                    emitted[ridx].extend(toks)
                    self.telemetry.event("request.emit", request=ridx, slot=s, step=step,
                                         session=reqs[ridx].session, n=len(toks))
                if paused[s]:  # parked: FREE on the device, still owned
                    continue
                if mode[s] == DL.FREE:
                    self._release(s)
                    self.telemetry.event("request.complete", request=ridx, slot=s, step=step,
                                         session=reqs[ridx].session, n=len(emitted[ridx]))
                    owner[s] = None
            # prefill-chunk budgets: park a long prefill so that co-resident
            # decodes get a decode-only dispatch before it goes on
            if self.policy == "slo":
                any_decode = any(int(m) == DL.DECODE for m in mode)
                for s in range(B):
                    if owner[s] is None or paused[s] or mode[s] != DL.PREFILL:
                        continue
                    burst[s] += 1
                    r = reqs[owner[s]]
                    b = r.prefill_chunks or self.prefill_budget
                    if b and burst[s] >= b and any_decode:
                        saved_rows[s] = self.kv.table[s].copy()
                        self.kv.table[s, :] = self.kv.trash
                        self._table_dev = None
                        mode[s] = DL.FREE
                        paused[s] = True
                        skip[s] = 1
                        stats["prefill_pauses"] += 1
                        self.telemetry.event("request.pause", request=owner[s], slot=s,
                                             step=step, session=r.session)
            step += 1
        self._host_kv_stats(stats, cache, mark)
        self._end(cache)
        for i in range(n):
            rstat[i]["n_emitted"] = len(emitted[i])
        return emitted
