"""ctypes binding of the hand-written CUDA linear scan and its fused backward.

``csrc/linear_scan.cu`` replaces the Pallas TPU kernel
``src/repro/kernels/linear_scan/kernel.py::linear_scan``, forward and (as the
JAX custom_vjp reruns it) backward.  It is compiled at first use by
``kernels/build.py`` (``nvcc`` for ``sm_90a``, a plain C interface);
importing this module needs neither ``nvcc`` nor a card.

``linear_scan`` and ``linear_scan_bwd`` check device, dtype, shape and
contiguity, allocate the outputs and the look-back scratch with
``torch.empty``, launch on the current CUDA stream, raise if a launch was
refused, and add one to ``launches`` and ``bwd_launches``.  They take CUDA
tensors only: the device dispatch (plain version for CPU tensors) lives in
``ops.py``.  The segment plan (``plan``) is a function of the shapes alone,
never of the card's SM count, so every card gives the same bits.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.build import load

SOURCE = Path(__file__).resolve().parent / "csrc" / "linear_scan.cu"
SOURCES = (SOURCE,)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SEGMENT = 32  # scan steps a thread folds and replays from its tile (csrc SEG)
THREADS = 128  # channels a block takes (csrc NT)
MAX_BLOCKS = 2 ** 31 - 1  # the grid's x limit

launches = 0  # forward kernel launches since the last reset (chip_smoke.py reads it)
bwd_launches = 0  # backward kernel launches since the last reset
_lib = None


class Plan(NamedTuple):
    seg_len: int  # scan steps per segment
    nseg: int  # segments per (batch row, channel)
    blocks: int  # one per (segment, batch row, block of THREADS channels)


def plan(batch: int, seq: int, chan: int) -> Plan:
    """The launch plan of a [batch, seq, chan] scan: fixed SEGMENT-step
    segments, a function of the shapes alone."""
    nseg = -(-seq // SEGMENT)
    return Plan(SEGMENT, nseg, batch * -(-chan // THREADS) * nseg)


def _load():
    global _lib
    if _lib is None:
        lib = load(SOURCE)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.linear_scan_launch.argtypes = [i32, i32, *[ptr] * 5, i64, *[i32] * 6, ptr]
        lib.linear_scan_launch.restype = i32
        lib.linear_scan_bwd_launch.argtypes = [i32, i32, *[ptr] * 8, i64, *[i32] * 5, ptr]
        lib.linear_scan_bwd_launch.restype = i32
        lib.linear_scan_scratch_words.argtypes = [i32, i32, i32]
        lib.linear_scan_scratch_words.restype = i64
        lib.linear_scan_error_string.argtypes = [i32]
        lib.linear_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _shape(what, a):
    """(batch, seq, chan) of a, which must lie on the card."""
    if not a.is_cuda:
        raise ValueError(f"{what} launches the CUDA kernel; a is on {a.device} "
                         "(ops.py runs the plain version for CPU tensors)")
    if a.dim() != 3 or min(a.shape) <= 0:
        raise ValueError(f"{what}: a must be a non-empty [batch, seq, chan], got "
                         f"{tuple(a.shape)}")
    return tuple(a.shape)


def _check(what, a, named) -> Plan:
    """``named`` (name, tensor or None, shape, dtypes) on a's device, of that
    shape and dtype, contiguous; a's launch plan."""
    for name, t, shape, dtypes in named:
        if t is None:
            continue
        if t.device != a.device:
            raise ValueError(f"{what}: {name} is on {t.device}, a on {a.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype not in dtypes:
            raise ValueError(f"{what}: {name} is {t.dtype}, expected one of "
                             f"{[str(d) for d in dtypes]}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    p = plan(*a.shape)
    if p.blocks > MAX_BLOCKS:
        raise ValueError(f"{what}: {tuple(a.shape)} needs {p.blocks} blocks, more than "
                         f"{MAX_BLOCKS}")
    return p


def _raise_on(lib, what, err):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.linear_scan_error_string(err).decode()}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def linear_scan(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
                reverse: bool = False) -> torch.Tensor:
    """Every inclusive state of h_t = a_t h_{t-1} + b_t on the card, fp32
    [batch, seq, chan].  a, b [batch, seq, chan] fp32 or bf16 (each its
    own), h0 [batch, chan] fp32 or None (zeros).  ``reverse`` runs the
    recurrence from the last step to the first: h_t = a_t h_{t+1} + b_t."""
    global launches
    bsz, seq, chan = _shape("linear_scan", a)
    p = _check("linear_scan", a, (("a", a, (bsz, seq, chan), _DTYPE_CODE),
                                  ("b", b, (bsz, seq, chan), _DTYPE_CODE),
                                  ("h0", h0, (bsz, chan), (torch.float32,))))
    lib = _load()
    dev = a.device
    out = torch.empty((bsz, seq, chan), dtype=torch.float32, device=dev)
    words = lib.linear_scan_scratch_words(bsz, seq, chan)  # the C side owns its layout
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.linear_scan_launch(
            _DTYPE_CODE[a.dtype], _DTYPE_CODE[b.dtype], a.data_ptr(), b.data_ptr(), _ptr(h0),
            out.data_ptr(), scratch.data_ptr(), words, bsz, seq, chan, p.seg_len,
            p.nseg, int(bool(reverse)), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, "linear_scan", err)
    launches += 1
    return out


def linear_scan_bwd(a: torch.Tensor, h: torch.Tensor, h0: Optional[torch.Tensor],
                    dout: torch.Tensor, b_dtype: torch.dtype):
    """The backward of ``linear_scan`` (forward direction) in one pass on the
    card: (da in a's dtype, db in ``b_dtype``, dh0 fp32 or None).  a
    [batch, seq, chan] fp32 or bf16; h, the forward's output, and dout
    [batch, seq, chan] fp32; h0 [batch, chan] fp32 or None."""
    global bwd_launches
    bsz, seq, chan = _shape("linear_scan_bwd", a)
    full, f32 = (bsz, seq, chan), (torch.float32,)
    p = _check("linear_scan_bwd", a, (("a", a, full, _DTYPE_CODE), ("h", h, full, f32),
                                      ("h0", h0, (bsz, chan), f32), ("dout", dout, full, f32)))
    if b_dtype not in _DTYPE_CODE:
        raise ValueError(f"linear_scan_bwd: b_dtype is {b_dtype}, expected one of "
                         f"{[str(d) for d in _DTYPE_CODE]}")
    lib = _load()
    dev = a.device
    da = torch.empty(full, dtype=a.dtype, device=dev)
    db = torch.empty(full, dtype=b_dtype, device=dev)
    dh0 = None if h0 is None else torch.empty((bsz, chan), dtype=torch.float32, device=dev)
    words = lib.linear_scan_scratch_words(bsz, seq, chan)  # the C side owns its layout
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.linear_scan_bwd_launch(
            _DTYPE_CODE[a.dtype], _DTYPE_CODE[b_dtype], a.data_ptr(), h.data_ptr(), _ptr(h0),
            dout.data_ptr(), da.data_ptr(), db.data_ptr(), _ptr(dh0), scratch.data_ptr(),
            words, bsz, seq, chan, p.seg_len, p.nseg,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, "linear_scan_bwd", err)
    bwd_launches += 1
    return da, db, dh0
