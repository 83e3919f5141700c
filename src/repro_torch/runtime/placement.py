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


_POLICIES: Dict[torch.device, HostOffload] = {}


def host_offload(device) -> HostOffload:
    """The process's offload policy for ``device`` (one copy stream each)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _POLICIES:
        _POLICIES[device] = HostOffload(device)
    return _POLICIES[device]
