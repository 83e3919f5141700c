"""ctypes binding of the hand-written CUDA linear scan.

``csrc/linear_scan.cu`` replaces the Pallas TPU kernel
``src/repro/kernels/linear_scan/kernel.py::linear_scan``.  It is compiled at
first use by ``kernels/build.py`` (``nvcc`` for ``sm_90a``, a plain C
interface); importing this module needs neither ``nvcc`` nor a card.

``linear_scan`` checks device, dtype, shape and contiguity, allocates the
output and the segment scratch with ``torch.empty``, launches on the
current CUDA stream, raises if a launch was refused, and adds one to
``launches``.  It takes CUDA tensors only: the device dispatch (plain
version for CPU tensors) lives in ``ops.py``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import load

SOURCE = Path(__file__).resolve().parent / "csrc" / "linear_scan.cu"
SOURCES = (SOURCE,)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MIN_SEGMENT = 32  # scan steps per segment at least: keeps the carry pass short
THREADS_PER_SM = 2048  # resident threads an SM can hold (sm_90)
MAX_GRID_YZ = 65535

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = load(SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.linear_scan_launch.argtypes = [i32, i32, *[ptr] * 7, *[i32] * 6, ptr]
        lib.linear_scan_launch.restype = i32
        lib.linear_scan_error_string.argtypes = [i32]
        lib.linear_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def segments(batch: int, seq: int, chan: int, sms: int):
    """(segment length, segment count): enough segments that batch x chan x
    segments threads fill ``sms`` SMs, none shorter than MIN_SEGMENT."""
    want = -(-(sms * THREADS_PER_SM) // (batch * chan))
    nseg = max(1, min(want, seq // MIN_SEGMENT, MAX_GRID_YZ))
    seg_len = -(-seq // nseg)
    return seg_len, -(-seq // seg_len)


def linear_scan(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
                reverse: bool = False) -> torch.Tensor:
    """Every inclusive state of h_t = a_t h_{t-1} + b_t on the card, fp32
    [batch, seq, chan].  a, b [batch, seq, chan] fp32 or bf16 (each its
    own), h0 [batch, chan] fp32 or None (zeros).  ``reverse`` runs the
    recurrence from the last step to the first: h_t = a_t h_{t+1} + b_t."""
    global launches
    if not a.is_cuda:
        raise ValueError(f"linear_scan launches the CUDA kernel; a is on {a.device} "
                         "(ops.py runs the plain version for CPU tensors)")
    if a.dim() != 3:
        raise ValueError(f"linear_scan: a must be [batch, seq, chan], got {tuple(a.shape)}")
    bsz, seq, chan = a.shape
    if min(bsz, seq, chan) <= 0 or bsz > MAX_GRID_YZ:
        raise ValueError(f"linear_scan: unsupported sizes {tuple(a.shape)}")
    for name, t, shape, dtypes in (("a", a, (bsz, seq, chan), _DTYPE_CODE),
                                   ("b", b, (bsz, seq, chan), _DTYPE_CODE),
                                   ("h0", h0, (bsz, chan), (torch.float32,))):
        if t is None:
            continue
        if t.device != a.device:
            raise ValueError(f"linear_scan: {name} is on {t.device}, a on {a.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"linear_scan: {name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype not in dtypes:
            raise ValueError(f"linear_scan: {name} is {t.dtype}, expected one of "
                             f"{[str(d) for d in dtypes]}")
        if not t.is_contiguous():
            raise ValueError(f"linear_scan: {name} must be contiguous")
    dev = a.device
    seg_len, nseg = segments(bsz, seq, chan, torch.cuda.get_device_properties(dev)
                             .multi_processor_count)
    lib = _load()
    out = torch.empty((bsz, seq, chan), dtype=torch.float32, device=dev)
    scratch = (torch.empty((3, bsz, nseg, chan), dtype=torch.float32, device=dev)
               if nseg > 1 else None)
    ptrs = (scratch[0].data_ptr(), scratch[1].data_ptr(), scratch[2].data_ptr()) \
        if scratch is not None else (None, None, None)
    with torch.cuda.device(dev):
        err = lib.linear_scan_launch(
            _DTYPE_CODE[a.dtype], _DTYPE_CODE[b.dtype], a.data_ptr(), b.data_ptr(),
            None if h0 is None else h0.data_ptr(), out.data_ptr(), *ptrs, bsz, seq, chan,
            seg_len, nseg, int(bool(reverse)), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"linear_scan launch failed: "
                           f"{lib.linear_scan_error_string(err).decode()}")
    launches += 1
    return out
