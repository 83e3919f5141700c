"""Host offload of idle FPDT chunks and their double-buffered fetch (Fig. 6).

The paper's memory headroom comes from moving chunks that are idle (the
KV and query chunks a later pair or the backward will need) to host memory
and fetching each back just ahead of the kernel that reads it.

``HostOffload(device)`` is the policy for one device (also used by
``remat="offload"``, ``models/transformer.py``, for each layer cycle's
input):

  * on a CUDA device, ``to_host(t)`` copies ``t`` into a **pinned** host
    tensor on a side copy stream, after the copy stream has waited for what
    the compute stream has queued so far (so ``t`` is complete), and
    ``to_device(t)`` starts copying a pinned tensor back with
    ``non_blocking=True`` on the same copy stream and returns it as a
    ``Pending`` copy: the compute stream waits for that copy only when
    ``Pending.wait()`` is called, just before the first kernel that reads
    the chunk.  One copy stream orders each chunk's fetch after its
    offload, so nothing reads a pinned buffer before its copy has
    completed; the caching host allocator records each copy and reuses a
    freed pinned buffer only after it.  There is no quiet identity on the
    card: a failure to pin or copy raises;
  * on the CPU both are identities (``to_device`` returns a ``Pending``
    with nothing to wait for), as the JAX package's policy is on a backend
    with no host pool (``src/repro/runtime/placement.py``).

``double_buffered`` starts the fetch of item k+1 before it yields item k,
and waits for item k's copies only as it yields them, so the copy of the
next chunk runs on the copy stream while the compute stream works on this
one.  ``no_offload()`` turns the offload off in a forward whose saved
tensors are thrown away (the first pass of a non-reentrant checkpoint).
Eager PyTorch has one loop, so the JAX package's scan-carry variant
(``fori_double_buffered``) has no twin here.

Serving's host-streamed decode KV (``models/serve.py``) keeps a cache
leaf ``[b, S, ...]`` in pinned memory (``to_host``) and reads and writes
it by rows: ``fetch_rows`` starts copying positions [start, start + n)
of every row to the device (one contiguous copy a row, so the copy is a
DMA from pinned memory and never a staged host copy), and
``write_rows`` copies spans of a device slab back into the pinned rows
after the compute stream's writes to it.  Both run on the copy stream,
so a span written back is ordered before any later fetch of it.

The host-streamed page pool (``runtime/paged.py``) is parked from the
start (``host_zeros``: pinned, never on the device) and read and written
by pages: ``fetch_pages`` starts copying a set of page ids into one
device buffer (a copy a run of consecutive pages), ``write_pages`` copies
page slices of a device buffer back into their host pages.  Both run on
the copy stream, so a fetch is ordered after every earlier write-back
with no host wait; ``settle`` is the one host wait, between segments,
before the host touches the pool itself (a page program, a demotion).
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Callable, Dict, Iterable, Iterator, Optional, TypeVar

import torch

T = TypeVar("T")
U = TypeVar("U")


class Pending:
    """A host->device copy that may still be in flight: ``wait()`` makes
    the current stream wait for it and returns the device tensor."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor: torch.Tensor, event: Optional[torch.cuda.Event] = None):
        self.tensor, self.event = tensor, event

    def wait(self) -> torch.Tensor:
        if self.event is not None:
            torch.cuda.current_stream(self.tensor.device).wait_event(self.event)
            self.event = None
        return self.tensor


def _waited(x):
    """``x`` with each ``Pending`` in it (itself, or a tuple of them) waited for."""
    if isinstance(x, Pending):
        return x.wait()
    if isinstance(x, tuple):
        return tuple(_waited(e) for e in x)
    return x


def double_buffered(items: Iterable[T], fetch: Callable[[T], U]) -> Iterator[U]:
    """Yields ``fetch(item_k)``, having started ``fetch(item_{k+1})`` first.
    ``fetch`` may return ``Pending`` copies (alone or in a tuple): each is
    waited for only as its item is yielded, so on the card the copy of the
    next chunk runs on the copy stream while the compute stream runs the
    kernels of this one."""
    seq = list(items)
    if not seq:
        return
    ahead = fetch(seq[0])
    for k in range(len(seq)):
        cur = ahead
        ahead = fetch(seq[k + 1]) if k + 1 < len(seq) else None
        yield _waited(cur)


_offload_off = threading.local()


@contextlib.contextmanager
def no_offload():
    """Within this block (on this thread) ``offload_enabled()`` is False:
    for a forward whose saved tensors a checkpoint throws away at once, so
    copying them to the host would be wasted work."""
    prev = getattr(_offload_off, "on", False)
    _offload_off.on = True
    try:
        yield
    finally:
        _offload_off.on = prev


def offload_enabled() -> bool:
    return not getattr(_offload_off, "on", False)


class HostOffload:
    """``to_host`` / ``to_device`` for one device, with byte counts of what
    crossed (``to_host_bytes``, ``to_device_bytes``) and of the host copies
    that ``to_host`` made and that are still alive (``held_bytes``, and its
    largest value since the last reset, ``peak_held_bytes``)."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"host offload runs on a CUDA device or the CPU, not {self.device}")
        self.on_card = self.device.type == "cuda"
        self._stream = None
        self._lock = threading.Lock()  # autograd runs the backward on its own thread
        self.to_host_bytes = 0
        self.to_device_bytes = 0
        self.held_bytes = 0
        self.peak_held_bytes = 0

    def _copy_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _count(self, attr: str, t: torch.Tensor):
        with self._lock:
            setattr(self, attr, getattr(self, attr) + t.numel() * t.element_size())

    def reset_counts(self):
        with self._lock:
            self.to_host_bytes = self.to_device_bytes = 0
            self.peak_held_bytes = self.held_bytes

    def _held(self, n: int):
        with self._lock:
            self.held_bytes += n
            self.peak_held_bytes = max(self.peak_held_bytes, self.held_bytes)

    def to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A pinned host copy of the device tensor ``t`` (the CPU: ``t`` itself)."""
        if not self.on_card:
            return t
        if t.device != self.device:
            raise ValueError(f"to_host takes a tensor on {self.device}, got one on {t.device}")
        dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        if not dst.is_pinned():
            raise RuntimeError("to_host could not pin its host buffer")
        compute = torch.cuda.current_stream(self.device)
        copy = self._copy_stream()
        copy.wait_stream(compute)  # t is complete before it is read
        with torch.cuda.stream(copy):
            dst.copy_(t, non_blocking=True)
        t.record_stream(copy)  # t's memory is not reused before the copy has read it
        self._count("to_host_bytes", t)
        n = dst.numel() * dst.element_size()
        self._held(n)
        weakref.finalize(dst, self._held, -n)  # when the last holder lets it go
        return dst

    def to_device(self, t: torch.Tensor) -> Pending:
        """Starts copying the pinned host tensor ``t`` back to the device;
        ``wait()`` on the result before a kernel reads it (the CPU: ``t``)."""
        if not self.on_card:
            return Pending(t)
        if t.device.type != "cpu" or not t.is_pinned():
            raise ValueError("to_device takes a pinned host tensor made by to_host")
        compute = torch.cuda.current_stream(self.device)
        copy = self._copy_stream()
        with torch.cuda.stream(copy):
            out = torch.empty(t.shape, dtype=t.dtype, device=self.device)
            out.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy)
        out.record_stream(compute)  # allocated on the copy stream, used on compute
        self._count("to_device_bytes", t)
        return Pending(out, done)


    def fetch_rows(self, t: torch.Tensor, start: int, n: int) -> Pending:
        """Starts copying positions [start, start + n) of every row of the
        pinned host tensor ``t`` [b, S, ...] to the device as one [b, n,
        ...] tensor, a contiguous copy a row (the CPU: a copy of the
        slice, so that the caller's writes to it reach ``t`` only through
        ``write_rows``, as on the card)."""
        if not self.on_card:
            return Pending(t[:, start:start + n].clone())
        if t.device.type != "cpu" or not t.is_pinned():
            raise ValueError("fetch_rows takes a pinned host tensor made by to_host")
        compute = torch.cuda.current_stream(self.device)
        copy = self._copy_stream()
        with torch.cuda.stream(copy):
            out = torch.empty((t.shape[0], n, *t.shape[2:]), dtype=t.dtype, device=self.device)
            for i in range(t.shape[0]):
                out[i].copy_(t[i, start:start + n], non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy)
        out.record_stream(compute)
        self._count("to_device_bytes", out)
        return Pending(out, done)

    def write_rows(self, dst: torch.Tensor, src: torch.Tensor, spans, offset: int):
        """``dst[i, a:e] = src[i, a - offset : e - offset]`` for each (i,
        a, e) of ``spans``: ``dst`` the pinned host tensor [b, S, ...],
        ``src`` a device slab of it that starts at position ``offset``,
        copied after what the compute stream has queued (its writes to
        ``src``).  On the CPU a plain copy."""
        if not self.on_card:
            for i, a, e in spans:
                dst[i, a:e].copy_(src[i, a - offset:e - offset])
            return
        compute = torch.cuda.current_stream(self.device)
        copy = self._copy_stream()
        copy.wait_stream(compute)
        with torch.cuda.stream(copy):
            for i, a, e in spans:
                dst[i, a:e].copy_(src[i, a - offset:e - offset], non_blocking=True)
                self._count("to_host_bytes", dst[i, a:e])
        src.record_stream(copy)

    def host_zeros(self, shape, dtype) -> torch.Tensor:
        """A zeroed host tensor to park a leaf in from the start (a page pool
        that never lives on the device): pinned on a card and counted in
        ``held_bytes`` as ``to_host``'s copies are; on the CPU a plain one."""
        if not self.on_card:
            return torch.zeros(shape, dtype=dtype)
        dst = torch.zeros(shape, dtype=dtype, pin_memory=True)
        if not dst.is_pinned():
            raise RuntimeError("host_zeros could not pin its host buffer")
        n = dst.numel() * dst.element_size()
        self._held(n)
        weakref.finalize(dst, self._held, -n)
        return dst

    def fetch_pages(self, pool: torch.Tensor, rows, n_slots: int, pad: int = 0) -> Pending:
        """Starts copying pages of the pinned page pool ``pool`` [n_phys, ps,
        ...] to the device as one [b, n_slots * ps + pad, ...] tensor:
        ``rows[i]`` lists (slot, page id) pairs, page ``pool[pid]`` landing
        at positions [slot * ps, (slot + 1) * ps) of row i.  A run of
        consecutive slots holding consecutive pages is one copy (a DMA
        from pinned memory, never a staged host gather: a host-side read of
        the pool would not be ordered after the write-backs queued on the
        copy stream).  Positions no pair names are left unset.  On the CPU
        plain copies into a new tensor, as ``fetch_rows``."""
        ps, tail = pool.shape[1], pool.shape[2:]
        shape = (len(rows), n_slots * ps + pad, *tail)
        if not self.on_card:
            out = torch.empty(shape, dtype=pool.dtype)
            for i, pairs in enumerate(rows):
                for s0, p0, n in _runs(pairs):
                    out[i, s0 * ps:(s0 + n) * ps].copy_(pool[p0:p0 + n].flatten(0, 1))
            return Pending(out)
        if pool.device.type != "cpu" or not pool.is_pinned():
            raise ValueError("fetch_pages takes a pinned host pool (host_zeros)")
        compute = torch.cuda.current_stream(self.device)
        copy = self._copy_stream()
        n_pages = 0
        with torch.cuda.stream(copy):
            out = torch.empty(shape, dtype=pool.dtype, device=self.device)
            for i, pairs in enumerate(rows):
                for s0, p0, n in _runs(pairs):
                    out[i, s0 * ps:(s0 + n) * ps].copy_(pool[p0:p0 + n].flatten(0, 1),
                                                          non_blocking=True)
                    n_pages += n
            done = torch.cuda.Event()
            done.record(copy)
        out.record_stream(compute)
        with self._lock:
            self.to_device_bytes += n_pages * pool[0].numel() * pool.element_size()
        return Pending(out, done)

    def write_pages(self, pool: torch.Tensor, src: torch.Tensor, spans):
        """``pool[pid, a:a + n] = src[i, o:o + n]`` for each (i, o, pid, a, n)
        of ``spans``: ``pool`` the pinned page pool, ``src`` a device buffer
        of page slices, copied on the copy stream after what the compute
        stream has queued (its writes to ``src``).  On the CPU plain copies."""
        if not self.on_card:
            for i, o, pid, a, n in spans:
                pool[pid, a:a + n].copy_(src[i, o:o + n])
            return
        compute = torch.cuda.current_stream(self.device)
        copy = self._copy_stream()
        copy.wait_stream(compute)
        with torch.cuda.stream(copy):
            for i, o, pid, a, n in spans:
                pool[pid, a:a + n].copy_(src[i, o:o + n], non_blocking=True)
                self._count("to_host_bytes", src[i, o:o + n])
        src.record_stream(copy)

    def settle(self):
        """Waits on the host for every copy queued on the copy stream, so
        that the host may read and write the pinned buffers they touch (a
        parked page pool's page programs); on the CPU nothing."""
        if self.on_card and self._stream is not None:
            self._stream.synchronize()

    def copy_to_host(self, dst: torch.Tensor, src: torch.Tensor):
        """``dst.copy_(src)``: ``dst`` a contiguous view of a pinned host
        tensor, ``src`` a device tensor, copied on the copy stream after
        what the compute stream has queued (the CPU: a plain copy)."""
        if not self.on_card:
            dst.copy_(src)
            return
        copy = self._copy_stream()
        copy.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(copy):
            dst.copy_(src, non_blocking=True)
        src.record_stream(copy)
        self._count("to_host_bytes", src)


def _runs(pairs):
    """(first slot, first page, length) of each run of ``pairs`` ((slot,
    page) in slot order) whose slots and pages both step by one."""
    out = []
    for s, p in pairs:
        if out and out[-1][0] + out[-1][2] == s and out[-1][1] + out[-1][2] == p:
            out[-1][2] += 1
        else:
            out.append([s, p, 1])
    return out


_POLICIES: Dict[torch.device, HostOffload] = {}


def host_offload(device) -> HostOffload:
    """The process's offload policy for ``device`` (one copy stream each)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _POLICIES:
        _POLICIES[device] = HostOffload(device)
    return _POLICIES[device]
