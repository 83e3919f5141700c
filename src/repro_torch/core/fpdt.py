"""FPDT: the paper's sequence-chunk pipelined attention, on one rank or sharded.

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
eager PyTorch needs one loop.

Distribution (``core/parallel.py``: each rank holds C/sp tokens of every
chunk, model rank m the block ``[i*C + m*C/sp, i*C + (m+1)*C/sp)``).  The
collectives run inside the Function's forward and backward, in schedule
order, never left to autograd, so remat and ``_OffloadedCycle`` rerun them
with the forward:

  * ``kind="ulysses"`` (hq % sp == 0): the rank projects and ropes its
    tokens of chunk i; q (and k, v where hkv % sp == 0) go through
    ``seq_to_heads``, so the pair loop sees all C tokens of the chunk for
    the rank's heads, with ``kind="local"``'s offsets.  Where hkv % sp != 0
    k and v are gathered over the model group instead (the JAX package keeps
    such KV replicated) and each rank keeps the kv heads its q heads read.
    o_i goes back through ``heads_to_seq``; the backward sends do_i through
    ``seq_to_heads`` and, as chunk j finishes (Fig. 7), dq_j, dk_j, dv_j
    back to the tokens' ranks (``heads_to_seq``; gathered KV is summed over
    the group by ``reduce_scatter_seq``);
  * ``kind="cp"``: q stays with its rank (C/sp rows at q_offset i*C +
    m*C/sp); k_i and v_i are gathered to all C tokens, every head, and the
    backward's dk_j, dv_j are summed back to their tokens' ranks by
    ``reduce_scatter_seq``.

Offload stays per rank: each keeps its own q chunks on the host, and its
own KV.  Where KV is gathered (cp, and ulysses with hkv % sp != 0) the
host store holds the rank's own [b, hkv, C/sp, dh] slice of each chunk,
as the JAX package shards its offloaded store along the chunk
(``_host_spec_kv``): the diagonal pair reads the chunk gathered just
after its projection, and every later fetch of chunk j (a live
off-diagonal pair in the forward, chunk j's outer step in the backward)
is gathered again once its copy has arrived.  So a rank's pinned bytes
and host-to-device bytes for KV are 1/sp of the gathered chunk's, at one
more ``gather_seq`` a fetch.  Without offload the gathered chunk stays on
the device, as the JAX package's replicated KV does.  The weight gradients
a rank returns cover its own tokens; the train step sums them over the
world.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.online_softmax import SoftmaxState, finalize, lse
from repro_torch.core import parallel as P
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


def kv_heads_read(hq: int, hkv: int, sp: int, m: int) -> Tuple[int, ...]:
    """The kv heads that model rank m's q heads (``[m*hq/sp, (m+1)*hq/sp)``)
    read when KV is gathered (ulysses with hkv % sp != 0), one entry per kv
    head the kernels see: each head once where the rank's q heads split
    evenly over them (GQA with a smaller group), else one per q head."""
    hq_l, g = hq // sp, hq // hkv
    per_q = [h // g for h in range(m * hq_l, (m + 1) * hq_l)]
    heads = sorted(set(per_q))
    group = hq_l // len(heads)
    if hq_l % len(heads) == 0 and all(per_q[n] == heads[n // group] for n in range(hq_l)):
        return tuple(heads)
    return tuple(per_q)


@dataclasses.dataclass(frozen=True)
class _Plan:
    cfg: ModelConfig
    window: int
    pos_offset: int
    u: int
    cq: int  # tokens of a chunk (all ranks' together)
    offload: Optional[HostOffload]  # None: chunks stay where they are
    kind: str = "local"
    par: Optional[ParallelContext] = None
    kv_heads: Optional[Tuple[int, ...]] = None  # ulysses with gathered KV: kv_heads_read

    @property
    def sp(self) -> int:
        return 1 if self.kind == "local" else self.par.sp

    @property
    def m(self) -> int:
        return 0 if self.kind == "local" else self.par.sp_rank

    @property
    def c(self) -> int:
        """This rank's tokens of a chunk."""
        return self.cq // self.sp

    def live(self, i: int, j: int) -> bool:
        return pair_live(i, j, cq=self.cq, window=self.window, sparsity=self.cfg.attn_sparsity)

    def pair_kwargs(self, i: int, j: int):
        # cp: the rank's query rows start m*c into chunk i; every other kind
        # runs the pair on whole chunks
        q_off = i * self.cq + (self.m * self.c if self.kind == "cp" else 0)
        return dict(causal=True, window=self.window, q_offset=q_off, k_offset=j * self.cq)

    def positions(self, i: int, device) -> torch.Tensor:
        """Global positions of this rank's tokens of chunk i."""
        return (i * self.cq + self.m * self.c + self.pos_offset
                + torch.arange(self.c, device=device))

    def to_host(self, t):
        return self.offload.to_host(t) if self.offload is not None else t

    def to_device(self, t):
        """A ``Pending`` copy under offload (``double_buffered`` waits for
        it as it yields), else ``t``."""
        return self.offload.to_device(t) if self.offload is not None else t

    # -- the distribution: each is the identity under kind="local" ----------

    def q_in(self, t):
        """This rank's [b, hq, c, dh] -> what its pairs read as q."""
        return P.seq_to_heads(t, self.par.sp_group) if self.kind == "ulysses" else t

    @property
    def gathers_kv(self) -> bool:
        """Each rank reads the whole KV chunk (gathered over the group)."""
        return self.kind == "cp" or (self.kind == "ulysses" and self.kv_heads is not None)

    def kv_in(self, t):
        """This rank's [b, hkv, c, dh] -> the chunk's k or v its pairs read."""
        if self.kind == "local":
            return t
        if not self.gathers_kv:
            return P.seq_to_heads(t, self.par.sp_group)
        full = P.gather_seq(t, self.par.sp_group)
        return full if self.kv_heads is None else full[:, list(self.kv_heads)]

    def kv_keep(self, own, read):
        """What the KV store keeps of a chunk: this rank's own slice where
        the chunk is gathered and offloaded, else what the pairs read."""
        return own if self.gathers_kv and self.offload is not None else read

    def kv_fetched(self, t):
        """A fetched KV chunk -> what the pairs read: gathered again where
        the store kept this rank's own c tokens (told by the length, since a
        checkpoint's backward sees the recompute's tensors, not its plan)."""
        own = self.gathers_kv and self.sp > 1 and t.shape[2] == self.c
        return self.kv_in(t) if own else t

    def o_out(self, t):
        """The pairs' rows -> this rank's tokens (every head)."""
        return P.heads_to_seq(t, self.par.sp_group) if self.kind == "ulysses" else t

    def q_back(self, dq, dtype):
        """dq of the pairs' rows (fp32) -> this rank's tokens, in ``dtype``
        (the epilogue's cast, taken before the all-to-all)."""
        if self.kind != "ulysses":
            return dq
        return P.heads_to_seq(dq.to(dtype), self.par.sp_group)

    def kv_back(self, dk, dtype):
        """dk or dv of the chunk the pairs read (fp32) -> this rank's tokens:
        summed over the group where the chunk was gathered (in fp32, then
        the epilogue casts), else sent back in ``dtype``."""
        if self.kind == "local":
            return dk
        if self.kind == "ulysses" and self.kv_heads is None:
            return P.heads_to_seq(dk.to(dtype), self.par.sp_group)
        if self.kv_heads is not None:  # back to every kv head, repeats summed
            b, _, s, d = dk.shape
            full = dk.new_zeros((b, self.cfg.num_kv_heads, s, d))
            for h in sorted(set(self.kv_heads)):
                full[:, h] = dk[:, [n for n, k in enumerate(self.kv_heads) if k == h]].sum(1)
            dk = full
        return P.reduce_scatter_seq(dk, self.par.sp_group)


def _project(plan: _Plan, w: Params, xi: torch.Tensor, i: int):
    """(q, k, v) of this rank's tokens of hidden chunk i, roped at their
    global positions, in the kernels' contiguous head-major layout
    [b, h, c, dh]."""
    q, k, v = qkv_proj(plan.cfg, w, xi)  # [b, c, h, dh]
    pos = plan.positions(i, xi.device)
    q = apply_rope(q, pos, plan.cfg.rope_theta)
    k = apply_rope(k, pos, plan.cfg.rope_theta)
    return tuple(t.transpose(1, 2).contiguous() for t in (q, k, v))


def _forward(plan: _Plan, x: torch.Tensor, w: Params, keep: bool):
    """o [b, S, hq*dh] in x's dtype (this rank's tokens), and, when
    ``keep``, the residuals of the backward: per chunk q_i, k_i, v_i as the
    pairs read them (host-resident under offload; gathered KV offloaded as
    this rank's own slice, ``_Plan.kv_keep``), o_i fp32 and L_i."""
    b = x.shape[0]
    cfg, u, c = plan.cfg, plan.u, plan.c
    kv_store = []  # (k_j, v_j) in head layout, on the host while idle
    qs, os_, Ls, outs = [], [], [], []

    def fetch_kv(j):
        kj, vj = kv_store[j]
        return plan.to_device(kj), plan.to_device(vj)

    for i in range(u):
        qi, k_own, v_own = _project(plan, w, x[:, i * c:(i + 1) * c], i)
        qi, ki, vi = plan.q_in(qi), plan.kv_in(k_own), plan.kv_in(v_own)
        live = [j for j in range(i) if plan.live(i, j)]
        carry = None
        for j, (kj, vj) in zip(live, double_buffered(live, fetch_kv)):
            kj, vj = plan.kv_fetched(kj), plan.kv_fetched(vj)
            carry = fa.chunk_fwd(qi, kj, vj, carry, **plan.pair_kwargs(i, j))
        st = SoftmaxState(*fa.chunk_fwd(qi, ki, vi, carry, **plan.pair_kwargs(i, i)))
        oi = finalize(st)  # [b, hq (ulysses: hq/sp), rows, dh] fp32
        kv_store.append((plan.to_host(plan.kv_keep(k_own, ki)),
                         plan.to_host(plan.kv_keep(v_own, vi))))
        if keep:
            qs.append(plan.to_host(qi))
            os_.append(oi)
            Ls.append(lse(st))
        outs.append(plan.o_out(oi.to(x.dtype)).transpose(1, 2).reshape(b, c, cfg.q_dim))
    o = torch.cat(outs, dim=1)
    ks, vs = [kv[0] for kv in kv_store], [kv[1] for kv in kv_store]
    return o, (qs, ks, vs, os_, Ls)


def _backward(plan: _Plan, x, w: Params, qs, ks, vs, os_, Ls, do):
    """Fig. 7: (dx, {name: dW}) from the forward's residuals and do."""
    cfg, u, c = plan.cfg, plan.u, plan.c
    b = x.shape[0]
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dos, deltas = [], []
    for i in range(u):
        doi = do[:, i * c:(i + 1) * c].reshape(b, c, hq, dh).transpose(1, 2)
        doi = plan.q_in(doi).float().contiguous()
        dos.append(doi)
        deltas.append((doi * os_[i]).sum(-1))  # [b, heads, rows]

    dqs: list = [None] * u
    dks: list = [None] * u
    dvs: list = [None] * u

    def fetch_kv(j):
        return plan.to_device(ks[j]), plan.to_device(vs[j])

    def fetch_q(i):
        return plan.to_device(qs[i])

    def or_zeros(g, like):  # a chunk with no live pair gets exact zeros
        return g if g is not None else x.new_zeros(like.shape, dtype=torch.float32)

    # the next KV chunk's fetch is issued before this chunk's inner loop,
    # and the next query chunk's before the current pair's kernels
    for j, (kj, vj) in zip(range(u), double_buffered(range(u), fetch_kv)):
        kj, vj = plan.kv_fetched(kj), plan.kv_fetched(vj)
        inner = [i for i in range(j, u) if plan.live(i, j)]
        for i, qi in zip(inner, double_buffered(inner, fetch_q)):
            kw = plan.pair_kwargs(i, j)
            dk_c, dv_c = fa.chunk_bwd_dkv(qi, kj, vj, dos[i], Ls[i], deltas[i], **kw)
            dq_c = fa.chunk_bwd_dq(qi, kj, vj, dos[i], Ls[i], deltas[i], **kw)
            dks[j] = dk_c if dks[j] is None else dks[j].add_(dk_c)
            dvs[j] = dv_c if dvs[j] is None else dvs[j].add_(dv_c)
            dqs[i] = dq_c if dqs[i] is None else dqs[i].add_(dq_c)
        # chunk j's dq (its diagonal pair came last), dk and dv are final:
        # back to this rank's tokens
        dqs[j] = plan.q_back(or_zeros(dqs[j], qs[j]), x.dtype)
        dks[j] = plan.kv_back(or_zeros(dks[j], kj), x.dtype)
        dvs[j] = plan.kv_back(or_zeros(dvs[j], vj), x.dtype)

    # per chunk: un-rope, un-project, and accumulate the weight grads
    # (_unproject_body) over this rank's tokens
    dxs, dw = [], None
    for i in range(u):
        xi = x[:, i * c:(i + 1) * c]
        back = -plan.positions(i, x.device)  # rope's backward: rotate by -theta
        dq = apply_rope(dqs[i].to(x.dtype).transpose(1, 2), back, cfg.rope_theta)
        dk = apply_rope(dks[i].to(x.dtype).transpose(1, 2), back, cfg.rope_theta)
        dqf = dq.reshape(b, c, hq * dh)
        dkf = dk.reshape(b, c, hkv * dh)
        dvf = dvs[i].to(x.dtype).transpose(1, 2).reshape(b, c, hkv * dh)
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


KINDS = ("local", "ulysses", "cp")


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

    x: [b, S, d], this rank's tokens: all of them under ``kind="local"``,
    else its C/sp tokens of each chunk in chunk order (``core/parallel.py``).
    Returns [b, S, hq*dh] in x's dtype for the same tokens, ready for the
    output projection.  u = cfg.fpdt_chunks must divide S.  Differentiable
    in x and the q/k/v projections (and biases) of ``p``; under a mesh the
    weight gradients cover this rank's tokens.
    """
    if kind not in KINDS:
        raise ValueError(f"fpdt kind {kind!r}: one of {KINDS}")
    u = cfg.fpdt_chunks
    b, seq_len, _ = x.shape
    if u < 1 or seq_len % u:
        raise ValueError(f"fpdt_chunks={u} must divide the sequence length {seq_len}")
    sp, kv_heads = 1, None
    if kind != "local":
        if not P.distributed(par):
            raise ValueError(f"fpdt kind {kind!r} needs a ParallelContext with a mesh")
        sp = par.sp
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        if kind == "ulysses" and hq % sp:
            raise ValueError(f"ulysses splits the {hq} q heads over sp={sp}: they must divide "
                             "(kind='cp' takes any head count)")
        if kind == "ulysses" and hkv % sp:
            kv_heads = kv_heads_read(hq, hkv, sp, par.sp_rank)
    on = cfg.fpdt_offload and u > 1 and offload_enabled()
    offload = host_offload(x.device) if on else None
    plan = _Plan(cfg, window, pos_offset, u, (seq_len // u) * sp, offload, kind, par, kv_heads)
    names = tuple(n for n in WEIGHTS if n in p)
    ws = [p[n] for n in names]
    if torch.is_grad_enabled() and (x.requires_grad or any(w.requires_grad for w in ws)):
        return _FPDT.apply(plan, names, x, *ws)
    return _forward(plan, x, dict(zip(names, ws)), keep=False)[0]
