"""ctypes binding of the hand-written CUDA ``flash_fwd`` (csrc/flash_fwd.cu).

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention/kernel.py::
flash_fwd``.  The source is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, under ``build/``
next to this file, named by a hash of the source and flags so an edit never
reuses a stale build.  Importing this module needs neither ``nvcc`` nor a
card.

The wrapper checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty``, launches on the current CUDA stream, raises
if the launch was refused, and adds one to ``launches`` per launch.  It
takes CUDA tensors only: the device dispatch (plain version for CPU
tensors) lives in ``ops.chunk_fwd``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since the last reset (chip_smoke.py reads it)
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA flash_fwd kernel is built on a "
                       "machine with the CUDA toolkit")


def build() -> Path:
    """Compile ``csrc/flash_fwd.cu`` unless this exact source was built
    already; returns the shared library's path.  ptxas' register and
    shared-memory report lands beside it as ``<name>.log``."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libflash_fwd_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_fwd_launch.argtypes = [i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                         i32, i32, i32, i32, i32, i32, i32, i32, i32,
                                         ctypes.c_float, ptr]
        lib.flash_fwd_launch.restype = i32
        lib.flash_fwd_error_string.argtypes = [i32]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"flash_fwd: {name} is on {t.device}, q on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"flash_fwd: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"flash_fwd: {name} is {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"flash_fwd: {name} must be contiguous")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              carry: Optional[tuple] = None, *, causal: bool = True, window: int = 0,
              q_offset: int = 0, k_offset: int = 0, sm_scale: Optional[float] = None):
    """Unnormalized online attention of q (at q_offset) over k/v (at k_offset)
    on the card.  q [b, hq, sq, d], k/v [b, hkv, sk, d] in fp32 or bf16,
    d in {16, 32, 64, 128}; carry = (acc [b, hq, sq, d], m, l [b, hq, sq])
    fp32 or None.  Returns the fp32 (acc, m, l) continuing ``carry``."""
    global launches
    if not q.is_cuda:
        raise ValueError(f"flash_fwd launches the CUDA kernel; q is on {q.device} "
                         "(ops.chunk_fwd runs the plain version for CPU tensors)")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_fwd: q/k/v must be [b, h, s, d], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_fwd takes float32 or bfloat16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_fwd: head_dim {d} not in {HEAD_DIMS}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_fwd: q heads {hq} not a multiple of kv heads {hkv}")
    if min(b, hq, sq, sk) <= 0 or hq > 65535 or b > 65535:
        raise ValueError(f"flash_fwd: unsupported sizes b={b} hq={hq} sq={sq} sk={sk}")
    if window < 0:
        raise ValueError(f"flash_fwd: window must be >= 0, got {window}")
    dev = q.device
    _check("q", q, (b, hq, sq, d), q.dtype, dev)
    _check("k", k, (b, hkv, sk, d), q.dtype, dev)
    _check("v", v, (b, hkv, sk, d), q.dtype, dev)
    if carry is not None:
        acc_in, m_in, l_in = carry
        _check("carry acc", acc_in, (b, hq, sq, d), torch.float32, dev)
        _check("carry m", m_in, (b, hq, sq), torch.float32, dev)
        _check("carry l", l_in, (b, hq, sq), torch.float32, dev)
        carry_ptrs = (acc_in.data_ptr(), m_in.data_ptr(), l_in.data_ptr())
    else:
        carry_ptrs = (None, None, None)
    scale = sm_scale if sm_scale is not None else d ** -0.5
    lib = _load()
    acc = torch.empty((b, hq, sq, d), dtype=torch.float32, device=dev)
    m = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    l = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.flash_fwd_launch(
            _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), *carry_ptrs,
            acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, hq, hkv, sq, sk, int(bool(causal)),
            int(window), int(q_offset), int(k_offset), float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: {lib.flash_fwd_error_string(err).decode()}")
    launches += 1
    return acc, m, l
