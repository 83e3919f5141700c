"""ctypes bindings of the hand-written CUDA flash-attention kernels.

``csrc/flash_fwd.cu`` holds ``flash_fwd`` and replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention/kernel.py::flash_fwd``; ``csrc/flash_bwd.cu``
holds ``flash_bwd_dq`` and ``flash_bwd_dkv`` and replaces the Pallas kernels
of the same names there; ``csrc/flash_tc.cuh`` holds the tile helpers both
share.  Each source is compiled at first use by ``kernels/build.py``
(``nvcc`` for ``sm_90a``, a shared library with a plain C interface).
Importing this module needs neither ``nvcc`` nor a card.

The dtype picks the kernel, inside the library: bf16 ``flash_fwd``,
``flash_bwd_dq`` and ``flash_bwd_dkv`` run on the tensor cores
(``mma.sync``, fp32 accumulation), fp32 ones on the CUDA cores.  Neither
kernel stands in for the other: a build or launch failure raises.

Each wrapper checks device, dtype, shape and contiguity (and, for a
tensor-core kernel, the alignment of the tensors it reads in vectors),
allocates its outputs (and ``flash_bwd_dkv``'s workspace: dO in bf16, the
q-head splits' partials) with ``torch.empty``, launches on the current CUDA
stream, raises if the launch was refused, and adds one to its launch count
(``launches`` for flash_fwd, ``dq_launches``, ``dkv_launches``).  They take
CUDA tensors only: the device dispatch (plain version for CPU tensors)
lives in ``ops.py``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import load

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_fwd.cu"
BWD_SOURCE = CSRC / "flash_bwd.cu"
SOURCES = (SOURCE, BWD_SOURCE)
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
DKV_TILE_KEYS = 64  # keys a block of the bf16 flash_bwd_dkv keeps (TcDkv::TK)
# the SMs dkv_splits reckons against on every card (an H100 SXM's): the
# split count, and with it the order in which the partials are summed,
# follows from the shapes alone, so dk and dv are the same bits on any card
DKV_SPLIT_SMS = 132
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (chip_smoke.py reads them)
launches = 0  # flash_fwd
dq_launches = 0  # flash_bwd_dq
dkv_launches = 0  # flash_bwd_dkv
_lib = None  # flash_fwd.cu
_bwd_lib = None  # flash_bwd.cu


def dkv_splits(b: int, hq: int, hkv: int, sk: int) -> int:
    """How many blocks share the q heads of one kv group in the bf16
    ``flash_bwd_dkv``: the least divisor n of the group size g = hq // hkv
    for which the grid's ceil(sk / 64) * hkv * b * n blocks reach one wave
    of ``DKV_SPLIT_SMS`` SMs (g if none does).  1 where the unsplit grid
    already fills an H100.  A function of the shapes alone."""
    g = hq // hkv
    blocks = -(-sk // DKV_TILE_KEYS) * hkv * b
    return next((n for n in range(1, g + 1) if g % n == 0 and blocks * n >= DKV_SPLIT_SMS), g)


def _load():
    global _lib
    if _lib is None:
        lib = load(SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_fwd_launch.argtypes = [i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                         i32, i32, i32, i32, i32, i32, i32, i32, i32,
                                         ctypes.c_float, ptr]
        lib.flash_fwd_launch.restype = i32
        lib.flash_fwd_error_string.argtypes = [i32]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _load_bwd():
    global _bwd_lib
    if _bwd_lib is None:
        lib = load(BWD_SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        ints = [i32] * 9  # b, hq, hkv, sq, sk, causal, window, q_offset, k_offset
        lib.flash_bwd_dq_launch.argtypes = [i32, i32, *[ptr] * 7, *ints, ctypes.c_float, ptr]
        lib.flash_bwd_dq_launch.restype = i32
        lib.flash_bwd_dkv_launch.argtypes = [i32, i32, *[ptr] * 10, i32, *ints, ctypes.c_float,
                                             ptr]
        lib.flash_bwd_dkv_launch.restype = i32
        lib.flash_bwd_error_string.argtypes = [i32]
        lib.flash_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def _check(name: str, t: torch.Tensor, shape, dtype, device, kname: str = "flash_fwd"):
    if t.device != device:
        raise ValueError(f"{kname}: {name} is on {t.device}, q on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kname}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{kname}: {name} is {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{kname}: {name} must be contiguous")


def _check_aligned(kname: str, align: int, **tensors):
    """The tensor-core kernels read these tensors in ``align``-byte vectors."""
    for name, t in tensors.items():
        if t.data_ptr() % align:
            raise ValueError(f"{kname}: {name} must be {align}-byte aligned for the bf16 kernel")


def _check_qkv(kname: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int):
    """Validate what every kernel takes; returns (b, hq, hkv, sq, sk, d)."""
    if not q.is_cuda:
        raise ValueError(f"{kname} launches the CUDA kernel; q is on {q.device} "
                         "(ops.py runs the plain version for CPU tensors)")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{kname}: q/k/v must be [b, h, s, d], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{kname} takes float32 or bfloat16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{kname}: head_dim {d} not in {HEAD_DIMS}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{kname}: q heads {hq} not a multiple of kv heads {hkv}")
    if min(b, hq, sq, sk) <= 0 or hq > 65535 or b > 65535:
        raise ValueError(f"{kname}: unsupported sizes b={b} hq={hq} sq={sq} sk={sk}")
    if window < 0:
        raise ValueError(f"{kname}: window must be >= 0, got {window}")
    _check("q", q, (b, hq, sq, d), q.dtype, q.device, kname)
    _check("k", k, (b, hkv, sk, d), q.dtype, q.device, kname)
    _check("v", v, (b, hkv, sk, d), q.dtype, q.device, kname)
    return b, hq, hkv, sq, sk, d


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              carry: Optional[tuple] = None, *, causal: bool = True, window: int = 0,
              q_offset: int = 0, k_offset: int = 0, sm_scale: Optional[float] = None):
    """Unnormalized online attention of q (at q_offset) over k/v (at k_offset)
    on the card.  q [b, hq, sq, d], k/v [b, hkv, sk, d] in fp32 or bf16,
    d in HEAD_DIMS; carry = (acc [b, hq, sq, d], m, l [b, hq, sq])
    fp32 or None.  Returns the fp32 (acc, m, l) continuing ``carry``."""
    global launches
    b, hq, hkv, sq, sk, d = _check_qkv("flash_fwd", q, k, v, window)
    dev = q.device
    if carry is not None:
        acc_in, m_in, l_in = carry
        _check("carry acc", acc_in, (b, hq, sq, d), torch.float32, dev)
        _check("carry m", m_in, (b, hq, sq), torch.float32, dev)
        _check("carry l", l_in, (b, hq, sq), torch.float32, dev)
        carry_ptrs = (acc_in.data_ptr(), m_in.data_ptr(), l_in.data_ptr())
    else:
        carry_ptrs = (None, None, None)
    if q.dtype == torch.bfloat16:
        _check_aligned("flash_fwd", 16, q=q, k=k, v=v)
        if carry is not None:
            _check_aligned("flash_fwd", 8, carry_acc=carry[0])
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


def _check_bwd(kname, q, k, v, do, L, delta, window):
    dims = _check_qkv(kname, q, k, v, window)
    b, hq, _, sq, _, d = dims
    _check("do", do, (b, hq, sq, d), torch.float32, q.device, kname)
    _check("L", L, (b, hq, sq), torch.float32, q.device, kname)
    _check("delta", delta, (b, hq, sq), torch.float32, q.device, kname)
    return dims


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                 L: torch.Tensor, delta: torch.Tensor, *, causal: bool = True, window: int = 0,
                 q_offset: int = 0, k_offset: int = 0, sm_scale: Optional[float] = None):
    """dq [b, hq, sq, d] fp32 of one (q-chunk, kv-chunk) pair on the card.
    q/k/v as for flash_fwd; do [b, hq, sq, d], L (row log-sum-exp) and
    delta = sum(do * o) [b, hq, sq], all fp32.  bf16 rounds dO and dS to
    bf16 before their products (``ref.chunk_bwd_dq_tc``)."""
    global dq_launches
    b, hq, hkv, sq, sk, d = _check_bwd("flash_bwd_dq", q, k, v, do, L, delta, window)
    dev = q.device
    if q.dtype == torch.bfloat16:
        _check_aligned("flash_bwd_dq", 16, q=q, k=k, v=v, do=do)
    scale = sm_scale if sm_scale is not None else d ** -0.5
    lib = _load_bwd()
    dq = torch.empty((b, hq, sq, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.flash_bwd_dq_launch(
            _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            L.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, hq, hkv, sq, sk,
            int(bool(causal)), int(window), int(q_offset), int(k_offset), float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq launch failed: "
                           f"{lib.flash_bwd_error_string(err).decode()}")
    dq_launches += 1
    return dq


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                  L: torch.Tensor, delta: torch.Tensor, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0, k_offset: int = 0, sm_scale: Optional[float] = None):
    """(dk, dv) [b, hkv, sk, d] fp32 of one pair on the card, summed over the
    g q-heads of each kv group without atomics: inside the block, and for
    bf16 also across the ``dkv_splits`` blocks that share a group, whose
    partials a second kernel adds in split order.  Inputs as
    flash_bwd_dq."""
    global dkv_launches
    b, hq, hkv, sq, sk, d = _check_bwd("flash_bwd_dkv", q, k, v, do, L, delta, window)
    dev = q.device
    # bf16: dO rounded to bf16 once, the group's q heads split across blocks,
    # partials summed in split order
    bf = q.dtype == torch.bfloat16
    if bf:
        _check_aligned("flash_bwd_dkv", 16, q=q, k=k, v=v, do=do)
    n_split = dkv_splits(b, hq, hkv, sk) if bf else 1
    if hkv * n_split > 65535:
        raise ValueError(f"flash_bwd_dkv: unsupported kv heads {hkv}")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    lib = _load_bwd()
    dk = torch.empty((b, hkv, sk, d), dtype=torch.float32, device=dev)
    dv = torch.empty((b, hkv, sk, d), dtype=torch.float32, device=dev)
    do16 = torch.empty(do.shape, dtype=torch.bfloat16, device=dev) if bf else None
    ws = (torch.empty((2, n_split, b, hkv, sk, d), dtype=torch.float32, device=dev)
          if n_split > 1 else None)
    with torch.cuda.device(dev):
        err = lib.flash_bwd_dkv_launch(
            _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            L.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if do16 is None else do16.data_ptr(), None if ws is None else ws.data_ptr(),
            n_split, b, hq, hkv, sq, sk,
            int(bool(causal)), int(window), int(q_offset), int(k_offset), float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv launch failed: "
                           f"{lib.flash_bwd_error_string(err).decode()}")
    dkv_launches += 1
    return dk, dv
