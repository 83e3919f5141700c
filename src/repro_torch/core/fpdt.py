"""FPDT: the paper's sequence-chunk pipelined attention, single device.

The hidden sequence is split into ``u = cfg.fpdt_chunks`` chunks.  Chunk i
is projected to (q_i, k_i, v_i) and roped at its global positions; one
online softmax then runs over every live KV chunk j < i and finally over
the diagonal chunk, each pair through ``kernels/flash_attention/ops.py::
chunk_fwd`` (the hand-written CUDA kernel on the card), and is normalized
once.  ``u = 1`` is the un-chunked baseline, and every u computes the same
function.

With ``cfg.fpdt_offload`` (and u > 1) idle chunks live in pinned host
memory (``runtime/placement.py``): each KV chunk goes to the host once
projected and comes back, double-buffered, for every later pair that reads
it (Fig. 6), and the backward's q chunks wait there too.  On the CPU the
offload is the identity, and inside ``placement.no_offload()`` (the first
pass of a per-cycle checkpoint, whose saved tensors are thrown away) it is
off.

When grad is needed the forward is a ``torch.autograd.Function`` whose
backward is the paper's Fig. 7 nested loop (the JAX package's unrolled
``custom_vjp``): the outer loop over KV chunks j fetches k_j/v_j, the inner
loop over live query chunks i >= j fetches q_i, and each pair runs
``chunk_bwd_dkv`` and ``chunk_bwd_dq`` from the saved final row LSE L_i, so
dk_j/dv_j sum over i and dq_i over j in fp32.  A per-chunk epilogue undoes
RoPE (a rotation by -theta) and the projections.  ``wo`` is applied by the
caller, outside the Function.  Under ``torch.no_grad`` (serving) nothing is
saved.

The JAX package compiles these loops as scans next to an unrolled twin;
eager PyTorch needs one loop.  Only ``kind="local"`` (no mesh) is ported:
the Ulysses/CP kinds come with the distribution slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.online_softmax import SoftmaxState, finalize, lse
from repro_torch.core.parallel import ParallelContext
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models.layers import apply_rope, qkv_proj
from repro_torch.runtime.placement import (HostOffload, double_buffered, host_offload,
                                           offload_enabled)

Params = Dict[str, Any]
WEIGHTS = ("wq", "wk", "wv", "bq", "bk", "bv")  # what the Function differentiates


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


@dataclasses.dataclass(frozen=True)
class _Plan:
    cfg: ModelConfig
    window: int
    pos_offset: int
    u: int
    cq: int
    offload: Optional[HostOffload]  # None: chunks stay where they are

    def live(self, i: int, j: int) -> bool:
        return pair_live(i, j, cq=self.cq, window=self.window, sparsity=self.cfg.attn_sparsity)

    def pair_kwargs(self, i: int, j: int):
        return dict(causal=True, window=self.window, q_offset=i * self.cq,
                    k_offset=j * self.cq)

    def positions(self, i: int, device) -> torch.Tensor:
        return i * self.cq + self.pos_offset + torch.arange(self.cq, device=device)

    def to_host(self, t):
        return self.offload.to_host(t) if self.offload is not None else t

    def to_device(self, t):
        """A ``Pending`` copy under offload (``double_buffered`` waits for
        it as it yields), else ``t``."""
        return self.offload.to_device(t) if self.offload is not None else t


def _project(plan: _Plan, w: Params, xi: torch.Tensor, i: int):
    """(q, k, v) of hidden chunk i, roped at its global positions, in the
    kernels' contiguous head-major layout [b, h, cq, dh]."""
    q, k, v = qkv_proj(plan.cfg, w, xi)  # [b, cq, h, dh]
    pos = plan.positions(i, xi.device)
    q = apply_rope(q, pos, plan.cfg.rope_theta)
    k = apply_rope(k, pos, plan.cfg.rope_theta)
    return tuple(t.transpose(1, 2).contiguous() for t in (q, k, v))


def _forward(plan: _Plan, x: torch.Tensor, w: Params, keep: bool):
    """o [b, S, hq*dh] in x's dtype, and, when ``keep``, the residuals of
    the backward: per chunk q_i, k_i, v_i (host-resident under offload),
    o_i fp32 and L_i."""
    b = x.shape[0]
    cfg, u, cq = plan.cfg, plan.u, plan.cq
    kv_store = []  # (k_j, v_j) in head layout, on the host while idle
    qs, os_, Ls, outs = [], [], [], []

    def fetch_kv(j):
        kj, vj = kv_store[j]
        return plan.to_device(kj), plan.to_device(vj)

    for i in range(u):
        qi, ki, vi = _project(plan, w, x[:, i * cq:(i + 1) * cq], i)
        live = [j for j in range(i) if plan.live(i, j)]
        carry = None
        for j, (kj, vj) in zip(live, double_buffered(live, fetch_kv)):
            carry = fa.chunk_fwd(qi, kj, vj, carry, **plan.pair_kwargs(i, j))
        st = SoftmaxState(*fa.chunk_fwd(qi, ki, vi, carry, **plan.pair_kwargs(i, i)))
        oi = finalize(st)  # [b, hq, cq, dh] fp32
        kv_store.append((plan.to_host(ki), plan.to_host(vi)))
        if keep:
            qs.append(plan.to_host(qi))
            os_.append(oi)
            Ls.append(lse(st))
        outs.append(oi.to(x.dtype).transpose(1, 2).reshape(b, cq, cfg.q_dim))
    o = torch.cat(outs, dim=1)
    ks, vs = [kv[0] for kv in kv_store], [kv[1] for kv in kv_store]
    return o, (qs, ks, vs, os_, Ls)


def _backward(plan: _Plan, x, w: Params, qs, ks, vs, os_, Ls, do):
    """Fig. 7: (dx, {name: dW}) from the forward's residuals and do."""
    cfg, u, cq = plan.cfg, plan.u, plan.cq
    b = x.shape[0]
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dos, deltas = [], []
    for i in range(u):
        doi = do[:, i * cq:(i + 1) * cq].reshape(b, cq, hq, dh).transpose(1, 2)
        doi = doi.float().contiguous()
        dos.append(doi)
        deltas.append((doi * os_[i]).sum(-1))  # [b, hq, cq]

    dqs: list = [None] * u
    dks: list = [None] * u
    dvs: list = [None] * u

    def fetch_kv(j):
        return plan.to_device(ks[j]), plan.to_device(vs[j])

    def fetch_q(i):
        return plan.to_device(qs[i])

    # the next KV chunk's fetch is issued before this chunk's inner loop,
    # and the next query chunk's before the current pair's kernels
    for j, (kj, vj) in zip(range(u), double_buffered(range(u), fetch_kv)):
        inner = [i for i in range(j, u) if plan.live(i, j)]
        for i, qi in zip(inner, double_buffered(inner, fetch_q)):
            kw = plan.pair_kwargs(i, j)
            dk_c, dv_c = fa.chunk_bwd_dkv(qi, kj, vj, dos[i], Ls[i], deltas[i], **kw)
            dq_c = fa.chunk_bwd_dq(qi, kj, vj, dos[i], Ls[i], deltas[i], **kw)
            dks[j] = dk_c if dks[j] is None else dks[j].add_(dk_c)
            dvs[j] = dv_c if dvs[j] is None else dvs[j].add_(dv_c)
            dqs[i] = dq_c if dqs[i] is None else dqs[i].add_(dq_c)

    # per chunk: un-rope, un-project, and accumulate the weight grads
    # (_unproject_body); a chunk with no live pair gets exact zeros
    dxs, dw = [], None
    for i in range(u):
        xi = x[:, i * cq:(i + 1) * cq]
        zq, zkv = (b, hq, cq, dh), (b, hkv, cq, dh)
        dq = dqs[i] if dqs[i] is not None else x.new_zeros(zq, dtype=torch.float32)
        dk = dks[i] if dks[i] is not None else x.new_zeros(zkv, dtype=torch.float32)
        dv = dvs[i] if dvs[i] is not None else x.new_zeros(zkv, dtype=torch.float32)
        back = -plan.positions(i, x.device)  # rope's backward: rotate by -theta
        dq = apply_rope(dq.to(x.dtype).transpose(1, 2), back, cfg.rope_theta)
        dk = apply_rope(dk.to(x.dtype).transpose(1, 2), back, cfg.rope_theta)
        dqf = dq.reshape(b, cq, hq * dh)
        dkf = dk.reshape(b, cq, hkv * dh)
        dvf = dv.to(x.dtype).transpose(1, 2).reshape(b, cq, hkv * dh)
        dxs.append(dqf @ w["wq"].T + dkf @ w["wk"].T + dvf @ w["wv"].T)
        x2 = xi.reshape(-1, xi.shape[-1]).T
        contrib = {"wq": x2 @ dqf.reshape(-1, hq * dh), "wk": x2 @ dkf.reshape(-1, hkv * dh),
                   "wv": x2 @ dvf.reshape(-1, hkv * dh)}
        if cfg.qkv_bias:
            contrib.update(bq=dqf.sum((0, 1)), bk=dkf.sum((0, 1)), bv=dvf.sum((0, 1)))
        dw = contrib if dw is None else {k: dw[k] + contrib[k] for k in dw}
    return torch.cat(dxs, dim=1), dw


class _FPDT(torch.autograd.Function):
    """The chunk pipeline with its Fig. 7 backward.  Every residual,
    pinned host chunks included, goes through ``save_for_backward``, so a
    surrounding non-reentrant checkpoint discards and recomputes them."""

    @staticmethod
    def forward(ctx, plan: _Plan, names: Tuple[str, ...], x, *ws):
        o, (qs, ks, vs, os_, Ls) = _forward(plan, x, dict(zip(names, ws)), keep=True)
        ctx.plan, ctx.names = plan, names
        ctx.save_for_backward(x, *ws, *qs, *ks, *vs, *os_, *Ls)
        return o

    @staticmethod
    def backward(ctx, do):
        names, u = ctx.names, ctx.plan.u
        x, *rest = ctx.saved_tensors
        ws, rest = rest[:len(names)], rest[len(names):]
        qs, ks, vs, os_, Ls = (rest[n * u:(n + 1) * u] for n in range(5))
        # where the chunks live is read from them, not from ctx.plan: under a
        # checkpoint, ctx is the first pass's (which offloads nothing) and
        # the saved tensors are the recompute's
        on_host = qs[0].device != x.device
        plan = dataclasses.replace(ctx.plan, offload=host_offload(x.device) if on_host else None)
        dx, dw = _backward(plan, x, dict(zip(names, ws)), qs, ks, vs, os_, Ls, do)
        return (None, None, dx, *(dw[n].to(w.dtype) for n, w in zip(names, ws)))


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
    projection.  u = cfg.fpdt_chunks must divide S.  Differentiable in x
    and the q/k/v projections (and biases) of ``p``.
    """
    if kind != "local":
        raise NotImplementedError(f"fpdt kind {kind!r} is not yet ported (distribution slice)")
    u = cfg.fpdt_chunks
    b, seq_len, _ = x.shape
    if u < 1 or seq_len % u:
        raise ValueError(f"fpdt_chunks={u} must divide the sequence length {seq_len}")
    offload = host_offload(x.device) if cfg.fpdt_offload and u > 1 and offload_enabled() \
        else None
    plan = _Plan(cfg, window, pos_offset, u, seq_len // u, offload)
    names = tuple(n for n in WEIGHTS if n in p)
    ws = [p[n] for n in names]
    if torch.is_grad_enabled() and (x.requires_grad or any(w.requires_grad for w in ws)):
        return _FPDT.apply(plan, names, x, *ws)
    return _forward(plan, x, dict(zip(names, ws)), keep=False)[0]
