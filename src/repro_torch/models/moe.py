"""Mixture-of-Experts FFN with GShard-style grouped capacity dispatch.

The twin of the JAX package's ``models/moe.py``, in its parameter layouts
(``router`` [d, e], kept fp32 in a bf16 model; ``wu``/``wg`` [e, d, ff];
``wd`` [e, ff, d]) and its routing, bit for bit where that is integer:

* the router logits are ``x.float() @ router`` in fp32, then a softmax;
  the top-k gates in descending order, renormalised over the chosen k;
* tokens are taken row-major in groups of ``tg = min(GROUP_TOKENS, b*s)``
  (a group folds batch rows when ``b*s <= GROUP_TOKENS``); a (token,
  choice)'s queue position is the count of the pairs before it in its
  group that chose the same expert, pairs flattened token-major, and it
  is kept when that position is below ``capacity(tg)``;
* ``aux = e * sum_e me * ce``: ``me`` the share of tokens whose first
  choice is expert e (no gradient), ``ce`` the mean gate.

Dispatch and combine work on the slot tensor [e, g, cap, d] at static
shapes, with no host read: each kept (token, choice) is written into its
own slot (``index_put`` without accumulate; every slot takes at most one
pair, the dropped ones go to a discarded row), so the adjoint of the
dispatch is a gather and a fixed-order sum over the k choices, and the
combine gathers each token's k outputs and sums them in one product.  No
atomic accumulation reorders a float sum, forward or backward.

``moe_ffn_chunked`` is the paper's sequence chunking (§5.4) applied to the
MoE FFN, each chunk a non-reentrant checkpoint.  Under a mesh
(``core/parallel.py``) a rank holds the chunk-interleaved spans of its
rows, and MoE chunk c is global tokens [c*S/n, (c+1)*S/n) of every row, so
a chunk or a group may lie on several ranks.  The routing crosses ranks in
two things only (``_MeshPlan``): the count of earlier pairs in a group that
lie on other ranks (the queue offset), and the top-1 counts of a chunk
(``me``).  Both come from one all-gather of small integer counts
(``parallel.gather_counts``), made before the chunks and only when a group
or a chunk spans ranks.  A rank's aux is its share
``e/n * sum_c me_c . (its gate sum over chunk c) / N_c``; the shares summed
over the world are the JAX aux, so the gradient needs no collective.

The expert stacks are stored as the JAX package's ``param_spec`` places
them (e over model, the second-last dimension over data;
``launch/shardings.py``).  Where e splits over model
(``shardings.expert_parallel``) the port runs the JAX ``"expert"``
placement, [e, g, cap, d] over (model, data): ``p`` holds the rank's e/sp
experts (gathered over data only), and in every chunk each rank writes its
kept pairs into the slots [e, G, cap, d] of the G groups its model group
holds, ``parallel.dispatch_slots`` hands each rank its experts' slots
summed over the model group, the rank runs its experts on them, and
``parallel.combine_slots`` gathers every expert's outputs back.  A slot
has at most one writer in the world, so the sum adds only zeros; where a
group spans data ranks, a slot that another data rank fills stays zero
here and gives a zero row that no token reads.  Every rank of the model
group takes part in every chunk, with its own tokens of it or none, so
the slot collectives run in chunk order on every rank, in the forward,
the checkpoint's recompute and the backward.  Where e does not split
(e % sp != 0) ``p`` holds every expert and each rank runs them on its own
tokens, with no slot collective.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig
from repro_torch.core import parallel as P
from repro_torch.data.pipeline import token_positions
from repro_torch.launch import shardings as SH
from repro_torch.models.layers import _dense_init

Params = Dict[str, Any]

GROUP_TOKENS = 512  # tokens per dispatch group


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> Params:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": _dense_init(gen, (d, e), torch.float32, device),
        "wu": _dense_init(gen, (e, d, ff), dtype, device, fan_in=d),
        "wd": _dense_init(gen, (e, ff, d), dtype, device, fan_in=ff),
    }
    if cfg.mlp_act == "swiglu":
        p["wg"] = _dense_init(gen, (e, d, ff), dtype, device, fan_in=d)
    return p


def capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    c = math.ceil(
        tokens_per_group * cfg.experts_per_token / cfg.num_experts * cfg.moe_capacity_factor
    )
    return max(4, min(c, tokens_per_group))


def route(cfg: ModelConfig, p: Params, xt: torch.Tensor):
    """xt [T, d] -> (gates [T, e] fp32, topv [T, k] renormalised over the
    chosen k, topi [T, k] in descending gate order)."""
    gates = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
    topv, topi = torch.topk(gates, cfg.experts_per_token, dim=-1)
    return gates, topv / topv.sum(dim=-1, keepdim=True), topi


def one_hot(topi: torch.Tensor, e: int) -> torch.Tensor:
    """[..., k] expert indices -> [..., k, e] int64, by comparison (no
    bounds check that would read the indices on the host)."""
    return (topi.unsqueeze(-1) == torch.arange(e, device=topi.device)).long()


def queue_positions(onehot: torch.Tensor, topi: torch.Tensor, seg0: torch.Tensor,
                    offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each (token, choice)'s place in its expert's queue: the pairs before
    it, flattened token-major, in the run of tokens that starts at token
    ``seg0[t]`` (its group, or this rank's part of it), plus ``offsets[t,
    e]`` pairs before that run (on other ranks).  onehot [T, k, e] integer;
    returns [T, k] int64."""
    T, k, e = onehot.shape
    flat = onehot.reshape(T * k, e).t().long()  # [e, T*k]: the scan runs along the inner dim
    excl = (flat.cumsum(1) - flat).t().reshape(T, k, e)
    within = excl - excl[seg0, 0].unsqueeze(1)
    if offsets is not None:
        within = within + offsets.unsqueeze(1)
    return within.gather(2, topi.unsqueeze(-1)).squeeze(-1)


class _SlotGather(torch.autograd.Function):
    """``src[idx]`` whose every row but the last (the dropped pairs' zero
    row) is read at most once, so its adjoint is a scatter without
    accumulation: no atomic, and no serial walk of the many indices of the
    discarded row that index's own backward makes."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.rows = src.shape[0]
        return src.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return g.new_zeros((ctx.rows, g.shape[1])).index_put_((idx,), g), None


def _experts(cfg: ModelConfig, p: Params, xt, topv, topi, pos, keep, grp, g: int, cap: int,
             group=None):
    """Dispatch xt [T, d] into the [e, g, cap] slots, run every expert on
    its slots, and combine each token's k outputs weighted by its gates.
    ``group``: the model group the experts are split over (``p`` holds
    this rank's block of them); the slots go through ``dispatch_slots`` and
    ``combine_slots`` around the rank's experts."""
    T, d = xt.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    slots = e * g * cap
    idx = torch.where(keep, (topi * g + grp.unsqueeze(1)) * cap + pos,
                      torch.full_like(pos, slots)).reshape(T * k)
    src = xt.unsqueeze(1).expand(T, k, d).reshape(T * k, d)
    buf = xt.new_zeros((slots + 1, d)).index_put((idx,), src)  # row ``slots``: the dropped
    ein = buf[:slots].view(e, g * cap, d)
    if group is not None:
        ein = P.dispatch_slots(ein, group)
    if cfg.mlp_act == "swiglu":
        h = F.silu(torch.bmm(ein, p["wg"])) * torch.bmm(ein, p["wu"])
    else:
        h = F.gelu(torch.bmm(ein, p["wu"]), approximate="tanh")  # jax.nn.gelu's default
    out = torch.bmm(h, p["wd"])
    if group is not None:
        out = P.combine_slots(out, group)
    out = out.reshape(slots, d)
    picked = _SlotGather.apply(torch.cat([out, out.new_zeros((1, d))]), idx).view(T, k, d)
    w = (topv * keep).to(xt.dtype)
    return torch.bmm(w.unsqueeze(1), picked).squeeze(1)


def _moe_tokens(cfg: ModelConfig, p: Params, xt, grp, seg0, g: int, cap: int, n_tokens: int,
                offsets=None, me=None, group=None):
    """Route, dispatch and combine the tokens xt [T, d] of groups ``grp``
    (index into the g groups of the slots) whose runs start at ``seg0``.
    Returns (y [T, d], aux): aux is this set of tokens' share of the
    load-balancing loss of a call over ``n_tokens`` tokens, with ``me``
    (the call's top-1 shares, [e]) computed here when not given.
    ``group``: as ``_experts``."""
    e = cfg.num_experts
    gates, topv, topi = route(cfg, p, xt)
    onehot = one_hot(topi, e)
    pos = queue_positions(onehot, topi, seg0, offsets)
    keep = pos < cap
    y = _experts(cfg, p, xt, topv, topi, pos, keep, grp, g, cap, group)
    if me is None:
        me = onehot[:, 0].sum(0).float() / n_tokens
    aux = e * torch.sum(me * (gates.sum(0) / n_tokens))
    return y, aux


def moe_ffn(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """x: [b, s, d] -> (y [b, s, d], aux_loss scalar)."""
    b, s, d = x.shape
    T = b * s
    tg = min(GROUP_TOKENS, T)
    if T % tg:
        raise ValueError(f"moe_ffn: {b} x {s} tokens are not whole groups of {tg}")
    grp = torch.arange(T, device=x.device) // tg
    y, aux = _moe_tokens(cfg, p, x.reshape(T, d), grp, grp * tg, T // tg, capacity(tg, cfg), T)
    return y.view(b, s, d), aux


def plan_of(cfg: ModelConfig, x_shape, n_chunks: int,
            par: Optional[P.ParallelContext] = None) -> _MeshPlan:
    """The plan of a ``moe_ffn_chunked`` call on this rank's x: the global
    sequence S in ``n_chunks`` chunks when ``n_chunks > 1`` and S divides,
    else one."""
    sp, dp, rank = (par.sp, par.dp, par.rank) if P.distributed(par) else (1, 1, 0)
    b, s, _ = x_shape
    S = s * sp
    n = n_chunks if n_chunks > 1 and S % n_chunks == 0 else 1
    return mesh_plan(cfg, S, b * dp, sp, dp, n, rank)


def moe_ffn_chunked(cfg: ModelConfig, p: Params, x: torch.Tensor, n_chunks: int,
                    par: Optional[P.ParallelContext] = None):
    """Sequence-chunked MoE (paper §5.4 applied to the MoE FFN): the chunks
    of ``plan_of``, each a ``moe_ffn`` call (a non-reentrant checkpoint
    when grad is enabled), aux the mean over the chunks; one unchunked
    ``moe_ffn`` on one rank in one chunk.  Under a mesh x holds this
    rank's rows and tokens, aux is this rank's share, and where
    ``shardings.expert_parallel`` holds ``p``'s expert stacks hold this
    model rank's e/sp experts (module docstring)."""
    plan = plan_of(cfg, x.shape, n_chunks, par)
    if plan.n == 1 and plan.world == 1:
        return moe_ffn(cfg, p, x)
    return moe_planned(cfg, p, x, plan, group=par.sp_group if SH.expert_parallel(cfg, par)
                       else None)


# ---------------------------------------------------------------------------
# the chunk plan: one rank's chunks and groups, on one rank or under a mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class _MeshPlan:
    """One rank's part of a chunked MoE call over the world, from the
    shapes alone.  ``chunks[c]`` is None when the rank holds no token of
    chunk c, else (lo, hi, grp, seg0, piece, g, egrp): its local columns
    [lo, hi) and, over its tokens of the chunk in row-major order, the
    local group index, the chunk-local index of the first of its tokens in
    the same group, and the piece index; g is its count of local groups,
    and egrp each token's index among the ``ep_groups`` groups of the
    chunk that its model group's rows touch (the slots' groups under
    expert parallelism).  A piece is a run of the rank's tokens that is
    consecutive in a group's order; ``pieces`` holds (start, end) in the
    rank's tokens concatenated over its chunks.  ``offset_rows`` [pieces,
    q] index the gathered counts (a
    last zero row pads) of the other ranks' pieces of the same group that
    come before each of this rank's pieces.  The gather sends ``n_pieces``
    rows of piece counts (padded to the largest rank's) when a group spans
    ranks, and n rows of top-1 counts when a chunk does."""

    n: int
    world: int
    cap: int
    n_tokens: int  # of a chunk, over the world
    chunks: Tuple[Optional[tuple], ...]
    pieces: np.ndarray
    offset_rows: Optional[np.ndarray]
    n_pieces: int
    gather_pieces: bool
    gather_me: bool
    ep_groups: int

    @property
    def rows(self) -> int:
        """Rows of counts each rank hands the gather."""
        return self.n_pieces * self.gather_pieces + self.n * self.gather_me


def _rank_tokens(S: int, B: int, sp: int, dp: int, u: int, n: int, r: int):
    """Rank r's tokens, chunk by chunk: (lo, hi, f) with f the tokens'
    row-major indices in the chunk's [B, S/n] order, or None."""
    L, b = S // n, B // dp
    pos = token_positions(S, sp, r % sp, u)
    rows = (r // sp) * b + np.arange(b)
    out = []
    for c in range(n):
        cols = np.nonzero(pos // L == c)[0]
        if not len(cols):
            out.append(None)
            continue
        lo, hi = int(cols[0]), int(cols[-1]) + 1
        if hi - lo != len(cols):
            raise AssertionError("a rank's tokens of a chunk are not one column range")
        out.append((lo, hi, (rows[:, None] * L + (pos[lo:hi] - c * L)[None, :]).reshape(-1)))
    return out


@functools.lru_cache(maxsize=64)
def mesh_plan(cfg: ModelConfig, S: int, B: int, sp: int, dp: int, n: int, rank: int) -> _MeshPlan:
    """The plan of rank ``rank`` (= data rank * sp + model rank) for a
    chunked MoE call over global [B, S] tokens in n chunks; on one rank
    (sp = dp = 1) its chunks are ``moe_ffn``'s groups."""
    world, L = sp * dp, S // n
    tg = min(GROUP_TOKENS, B * L)
    if (B * L) % tg:
        raise ValueError(f"moe: {B} x {L} tokens of a chunk are not whole groups of {tg}")
    u = cfg.fpdt_chunks if sp > 1 else 1  # one model rank holds its tokens in order
    parts = [_rank_tokens(S, B, sp, dp, u, n, r) for r in range(world)]
    pieces_of, holders, owners = [], {}, {}  # per rank; chunk -> ranks; (c, group) -> ranks
    my_piece = []  # this rank's piece of each of its tokens
    for r, rparts in enumerate(parts):
        pieces, prev, at = [], None, 0
        for c, part in enumerate(rparts):
            if part is None:
                continue
            holders.setdefault(c, set()).add(r)
            for f in part[2].tolist():
                grp = (c, f // tg)
                owners.setdefault(grp, set()).add(r)
                if prev != (grp, f - 1):
                    pieces.append([grp, f, at, at + 1])
                pieces[-1][3] = at + 1
                if r == rank:
                    my_piece.append(len(pieces) - 1)
                prev, at = (grp, f), at + 1
        pieces_of.append(pieces)
    gather_pieces = any(len(rs) > 1 for rs in owners.values())
    gather_me = any(len(rs) > 1 for rs in holders.values())
    n_pieces = max(len(ps) for ps in pieces_of)
    rows = n_pieces * gather_pieces + n * gather_me
    mine = pieces_of[rank]
    offset_rows = None
    if gather_pieces:
        before = [[r * rows + q for r in range(world) if r != rank
                   for q, (grp, f0, _, _) in enumerate(pieces_of[r]) if grp == g0 and f0 < f]
                  for g0, f, _, _ in mine]
        width = max(1, max(len(x) for x in before))
        offset_rows = np.array([x + [world * rows] * (width - len(x)) for x in before],
                               dtype=np.int64)
    first = (rank // sp) * (B // dp) * L  # the model group's rows: a run of each chunk's tokens
    g0 = first // tg
    ep_groups = (first + (B // dp) * L - 1) // tg - g0 + 1
    chunks, at = [], 0
    for part in parts[rank]:
        if part is None:
            chunks.append(None)
            continue
        lo, hi, f = part
        groups = f // tg
        uniq = np.unique(groups)
        grp = np.searchsorted(uniq, groups)
        seg0 = np.searchsorted(groups, uniq)[grp]  # groups rise along f
        piece = np.array(my_piece[at:at + len(f)], dtype=np.int64)
        chunks.append((lo, hi, grp, seg0, piece, len(uniq), groups - g0))
        at += len(f)
    pieces = np.array([[s0, s1] for _, _, s0, s1 in mine], dtype=np.int64)
    return _MeshPlan(n=n, world=world, cap=capacity(tg, cfg), n_tokens=B * L, chunks=tuple(chunks),
                     pieces=pieces, offset_rows=offset_rows, n_pieces=n_pieces,
                     gather_pieces=gather_pieces, gather_me=gather_me, ep_groups=ep_groups)


@functools.lru_cache(maxsize=64)
def _on_device(plan: _MeshPlan, device: torch.device):
    """The plan's index arrays as tensors on ``device``, made once; on the
    card through pinned memory, so the copy does not synchronise."""
    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    empty = put(np.zeros(0, dtype=np.int64))  # a chunk of no token of this rank's
    chunks = tuple((empty, empty, empty, empty) if ch is None else
                   (put(ch[2]), put(ch[3]), put(ch[4]), put(ch[6])) for ch in plan.chunks)
    rows = None if plan.offset_rows is None else put(plan.offset_rows)
    return chunks, put(plan.pieces), rows


def local_counts(cfg: ModelConfig, p: Params, x: torch.Tensor, plan: _MeshPlan,
                 dev_plan=None) -> torch.Tensor:
    """What this rank hands the gather, from a routing pass over its tokens
    (no grad is needed): [plan.rows, e] int32, its pieces' counts of pairs
    by expert (padded to ``n_pieces``) when a group spans ranks, then each
    chunk's top-1 counts when a chunk does."""
    _, pieces, _ = dev_plan or _on_device(plan, x.device)
    e, d = cfg.num_experts, x.shape[2]
    per_token, top1 = [], []
    for ch in plan.chunks:
        if ch is None:
            top1.append(x.new_zeros((e,), dtype=torch.int64))
            continue
        _, _, topi = route(cfg, p, x[:, ch[0]:ch[1]].reshape(-1, d))
        onehot = one_hot(topi, e)
        per_token.append(onehot.sum(1))
        top1.append(onehot[:, 0].sum(0))
    send = []
    if plan.gather_pieces:
        cs = torch.cat([torch.zeros_like(per_token[0][:1]), torch.cat(per_token).cumsum(0)])
        counts = cs[pieces[:, 1]] - cs[pieces[:, 0]]
        send.append(torch.cat([counts, counts.new_zeros((plan.n_pieces - len(counts), e))]))
    if plan.gather_me:
        send.append(torch.stack(top1))
    return torch.cat(send).to(torch.int32)


def _from_gathered(plan: _MeshPlan, dev_plan, got: torch.Tensor):
    """Per chunk, the queue offsets [T_c, e] of this rank's tokens and the
    world's top-1 shares ``me`` [e] (None where the plan gathers none),
    from every rank's counts ``got`` [world, rows, e]."""
    chunks, _, offset_rows = dev_plan
    e = got.shape[-1]
    offsets, me = [None] * plan.n, [None] * plan.n
    if plan.gather_pieces:
        flat = torch.cat([got.reshape(-1, e), got.new_zeros((1, e))]).long()
        per_piece = flat[offset_rows].sum(1)  # [pieces, e]
        offsets = [None if ch is None else per_piece[dc[2]] for ch, dc in zip(plan.chunks, chunks)]
    if plan.gather_me:
        me = list((got[:, -plan.n:].long().sum(0).float() / plan.n_tokens).unbind(0))
    return offsets, me


def _exchange(cfg: ModelConfig, p: Params, x: torch.Tensor, plan: _MeshPlan, dev_plan, gather):
    """Per chunk, this rank's queue offsets and the world's ``me`` (None
    each where the plan gathers none): one ``gather`` of ``local_counts``,
    made only when the plan needs it."""
    if not plan.rows:
        return [None] * plan.n, [None] * plan.n
    with torch.no_grad():
        return _from_gathered(plan, dev_plan, gather(local_counts(cfg, p, x, plan, dev_plan)))


def routing(cfg: ModelConfig, p: Params, x: torch.Tensor, n_chunks: int,
            par: Optional[P.ParallelContext] = None, gather=P.gather_counts):
    """The routing decisions of ``moe_ffn_chunked(cfg, p, x, n_chunks,
    par)`` for this rank's tokens, without grad: (topi [b, s, k] in
    descending gate order, keep [b, s, k])."""
    plan = plan_of(cfg, x.shape, n_chunks, par)
    b, _, d = x.shape
    dev_plan = _on_device(plan, x.device)
    offsets, _ = _exchange(cfg, p, x, plan, dev_plan, gather)
    tops, keeps = [], []
    with torch.no_grad():
        for c, ch in enumerate(plan.chunks):
            if ch is None:
                continue
            _, _, topi = route(cfg, p, x[:, ch[0]:ch[1]].reshape(-1, d))
            pos = queue_positions(one_hot(topi, cfg.num_experts), topi, dev_plan[0][c][1],
                                  offsets[c])
            tops.append(topi.view(b, ch[1] - ch[0], -1))
            keeps.append((pos < plan.cap).view(b, ch[1] - ch[0], -1))
    return torch.cat(tops, 1), torch.cat(keeps, 1)


def _moe_chunk(cfg: ModelConfig, names, xt, grp, seg0, g, cap, n_tokens, offsets, me, group,
               *ws):
    return _moe_tokens(cfg, dict(zip(names, ws)), xt, grp, seg0, g, cap, n_tokens, offsets, me,
                       group)


def moe_planned(cfg: ModelConfig, p: Params, x: torch.Tensor, plan: _MeshPlan,
                gather=P.gather_counts, group=None):
    """This rank's part of a chunked MoE call under ``plan``: (y, its aux
    share).  ``gather`` takes ``local_counts`` and returns every rank's
    [world, rows, e]; it is called once, before the chunks, and only when
    the plan needs it.  ``group``: the model group the experts are split
    over (``p`` holds this rank's block of them), None where ``p`` holds
    every expert; under it the rank runs every chunk, a chunk of none of
    its tokens too (its experts serve the other ranks' tokens; the empty
    output keeps the chunk's backward, and so its collectives, on the
    graph)."""
    b, s, d = x.shape
    dev_plan = _on_device(plan, x.device)
    offsets, me = _exchange(cfg, p, x, plan, dev_plan, gather)
    ys, auxs = [], []
    for c, ch in enumerate(plan.chunks):
        if ch is None and group is None:
            continue
        lo, hi = (0, 0) if ch is None else ch[:2]
        grp, seg0, _, egrp = dev_plan[0][c]
        gi, g = (grp, ch[5]) if group is None else (egrp, plan.ep_groups)  # the slots' groups
        args = (x[:, lo:hi].reshape(-1, d), gi, seg0, g, plan.cap, plan.n_tokens, offsets[c],
                me[c], group)
        if torch.is_grad_enabled():  # the weights as tensor arguments: see layers.mlp_chunked
            y, aux = checkpoint(_moe_chunk, cfg, tuple(p), *args, *p.values(),
                                use_reentrant=False, preserve_rng_state=False)
        else:
            y, aux = _moe_tokens(cfg, p, *args)
        ys.append(y.view(b, hi - lo, d))
        if ch is not None:
            auxs.append(aux)
    return torch.cat(ys, dim=1), torch.stack(auxs).sum() / plan.n
