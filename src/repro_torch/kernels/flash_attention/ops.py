"""Chunk-level flash-attention primitive that FPDT schedules.

``chunk_fwd (q_i, kv_j, carry) -> running (acc, m, l)`` with two
implementations of one function:

  * ``impl="cuda"``  — the hand-written Hopper kernel (``kernel.py``), for
    CUDA tensors;
  * ``impl="torch"`` — the plain PyTorch version (``ref.py``), for CPU
    tensors.

``impl=None`` picks by the tensors' device; any other pairing raises, so a
CUDA tensor never silently takes the plain path.  ``block_q``/``block_k``
keep the JAX signature: the Pallas kernel tiles by them, the CUDA kernel
tiles by its own compile-time 64 x 64 and masks ragged tails, and the
plain version does not tile — all compute the same function.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.online_softmax import SoftmaxState
from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention import ref as _ref

IMPLS = ("cuda", "torch")


def chunk_fwd(q, k, v, carry=None, *, causal=True, window=0, q_offset=0, k_offset=0,
              sm_scale=None, block_q=512, block_k=512, impl: Optional[str] = None):
    """Online-softmax state ``(acc, m, l)`` of q (at q_offset) over k/v (at
    k_offset), continuing ``carry``.  q [b, hq, sq, d], k/v [b, hkv, sk, d]."""
    want = "cuda" if q.is_cuda else "torch"
    impl = want if impl is None else impl
    if impl not in IMPLS:
        raise ValueError(f"unknown chunk_fwd impl {impl!r}; expected one of {IMPLS}")
    if impl != want:
        raise ValueError(f"chunk_fwd impl={impl!r} cannot run on {q.device} tensors "
                         f"(cuda runs CUDA tensors, torch runs CPU tensors)")
    if impl == "cuda":
        return _k.flash_fwd(q, k, v, carry, causal=causal, window=window,
                            q_offset=q_offset, k_offset=k_offset, sm_scale=sm_scale)
    st = _ref.attend_chunk(q, k, v, causal=causal, window=window, q_offset=q_offset,
                           k_offset=k_offset, sm_scale=sm_scale,
                           carry=SoftmaxState(*carry) if carry is not None else None)
    return tuple(st)
