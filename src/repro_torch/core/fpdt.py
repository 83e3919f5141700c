"""FPDT: the paper's sequence-chunk pipelined attention, forward, single device.

The hidden sequence is split into ``u = cfg.fpdt_chunks`` chunks.  Chunk i
is projected to (q_i, k_i, v_i) and roped at its global positions; one
online softmax then runs over every live KV chunk j < i and finally over
the diagonal chunk, each pair through ``kernels/flash_attention/ops.py::
chunk_fwd`` (the hand-written CUDA kernel on the card), and is normalized
once.  ``u = 1`` is the un-chunked baseline, and every u computes the same
function.

The JAX package compiles this loop as a scan (bounded XLA program size)
next to an unrolled twin; eager PyTorch needs one loop.  Only
``kind="local"`` (no mesh) and the forward are ported: the Ulysses/CP kinds
come with the distribution slice, host offload of idle KV chunks and the
Fig. 7 backward with the training slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.online_softmax import SoftmaxState, finalize
from repro_torch.core.parallel import ParallelContext
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models.layers import apply_rope, qkv_proj

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# chunk-pair liveness (window band / block sparsity)
# ---------------------------------------------------------------------------


def sparsity_stride(sparsity: float) -> int:
    """Distance stride keeping ~(1-sparsity) of off-diagonal KV chunks."""
    return max(1, round(1.0 / max(1e-9, 1.0 - sparsity)))


def pair_live(i: int, j: int, *, cq: int, window: int, sparsity: float) -> bool:
    """Is the (query chunk i, KV chunk j) pair attended?"""
    if j > i:
        return False
    if window and (i - j) * cq >= window + cq - 1:
        return False  # chunk pair fully outside the attention band
    if sparsity > 0.0 and j < i:
        # block-sparse (paper §5.6): keep ~(1-sparsity) of off-diagonal
        # KV chunks by distance stride; the diagonal is always attended.
        if (i - j - 1) % sparsity_stride(sparsity) != 0:
            return False
    return True


# ---------------------------------------------------------------------------
# the chunk pipeline
# ---------------------------------------------------------------------------


def _project(cfg: ModelConfig, p: Params, xi: torch.Tensor, start: int):
    """(q, k, v) of one hidden chunk at global positions start.., roped, in
    the kernels' contiguous head-major layout [b, h, cq, dh]."""
    q, k, v = qkv_proj(cfg, p, xi)  # [b, cq, h, dh]
    pos = start + torch.arange(xi.shape[1], device=xi.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    return tuple(t.transpose(1, 2).contiguous() for t in (q, k, v))


def fpdt_attention(
    cfg: ModelConfig,
    par: Optional[ParallelContext],
    p: Params,
    x: torch.Tensor,
    *,
    kind: str = "local",
    window: int = 0,
    pos_offset: int = 0,
) -> torch.Tensor:
    """Chunk-pipelined attention over hidden states.

    x: [b, S, d].  Returns [b, S, hq*dh] in x's dtype, ready for the output
    projection.  u = cfg.fpdt_chunks must divide S.
    """
    if kind != "local":
        raise NotImplementedError(f"fpdt kind {kind!r} is not yet ported (distribution slice)")
    par = par if par is not None else ParallelContext()
    u = cfg.fpdt_chunks
    if cfg.fpdt_offload and par.offload_to_host and u > 1:
        raise NotImplementedError("fpdt_offload is not yet ported (host offload comes "
                                  "with the training slice)")
    b, seq_len, _ = x.shape
    if u < 1 or seq_len % u:
        raise ValueError(f"fpdt_chunks={u} must divide the sequence length {seq_len}")
    cq = seq_len // u
    hq, dh = cfg.num_heads, cfg.head_dim

    def pair(qi, kj, vj, carry, i, j):
        return fa.chunk_fwd(qi, kj, vj, carry, causal=True, window=window,
                            q_offset=i * cq, k_offset=j * cq, block_q=cfg.block_q,
                            block_k=cfg.block_k, impl=par.attn_impl)

    kv_store = []  # (k_j, v_j) in head layout
    outs = []
    for i in range(u):
        qi, ki, vi = _project(cfg, p, x[:, i * cq:(i + 1) * cq], i * cq + pos_offset)
        carry = None
        for j in range(i):
            if pair_live(i, j, cq=cq, window=window, sparsity=cfg.attn_sparsity):
                carry = pair(qi, *kv_store[j], carry, i, j)
        carry = pair(qi, ki, vi, carry, i, i)
        kv_store.append((ki, vi))
        oi = finalize(SoftmaxState(*carry))  # [b, hq, cq, dh] fp32
        outs.append(oi.to(x.dtype).transpose(1, 2).reshape(b, cq, hq * dh))
    return torch.cat(outs, dim=1)
