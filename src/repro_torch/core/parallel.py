"""Parallel context and the explicit collectives of the distributed path.

The JAX package writes distribution as global arrays with sharding
constraints and lets GSPMD make the collectives.  PyTorch has no GSPMD, so
here every rank holds its own shard and the collectives are written out on
``torch.distributed`` process groups of a ``launch/mesh.py::Mesh``
(``data`` x ``model``; sp = model, dp = data).

The layout is the paper's chunk-interleaved sequence sharding: with u FPDT
chunks of C = S / u tokens, model rank m holds tokens
``[i*C + m*C/sp, i*C + (m+1)*C/sp)`` of every chunk i, and its data rank's
batch rows (``data/pipeline.py::shard_batch``).  So a chunk's all-to-all
is balanced, and after it every rank holds all C tokens of the chunk for
its heads.

The collectives work on the kernels' head-major layout [b, h, s, dh]:

  seq_to_heads        [b, h, C/sp, dh] -> [b, h/sp, C, dh]    (all_to_all_single)
  heads_to_seq        its inverse                              (all_to_all_single)
  gather_seq          [b, h, C/sp, dh] -> [b, h, C, dh]       (all_gather_into_tensor)
  reduce_scatter_seq  [b, h, C, dh] -> [b, h, C/sp, dh] summed (reduce_scatter_tensor)
  all_reduce_sum      in place, over a group or the world      (all_reduce)
  all_reduce_max      the same with MAX: the int8 gradient compression's
                      block maxima under ZeRO-3 (``optim/compression.py``)

and, for the recurrent mixers' two-pass scans (``models/mamba.py``,
``models/rglru.py``), one collective that autograd differentiates:

  gather_spans        [b, u, ...] -> [b, u*sp, ...]           (all_gather_into_tensor)
  reduce_scatter_spans  its adjoint, in the backward            (reduce_scatter_tensor)

A rank's u spans are its C/sp tokens of each chunk; ``gather_spans`` puts
every rank's spans in global order, span (i, m) at g = i*sp + m.

and, for the MoE FFN's queue offsets and top-1 shares (``models/moe.py``),
outside autograd:

  gather_counts       [rows, e] int32 -> [world, rows, e]      (all_gather_into_tensor)

and, for ZeRO-3 (``launch/shardings.py``), one collective that autograd
differentiates:

  gather_params       a weight's shard -> the whole weight, along its split
                      dimension over each group it is split on (all_gather_into_tensor)
  reduce_scatter_grads  its adjoint, in the backward: this rank's block of
                      the gradient summed over those groups (reduce_scatter_tensor)

and, for the MoE FFN's expert parallelism over the model group
(``models/moe.py``), two that autograd differentiates, each the other's
adjoint, along dim 0 (the expert dimension of the [e, g*cap, d] slots):

  dispatch_slots      [e, ...] -> [e/sp, ...]: this rank's experts' slots
                      summed over the group (reduce_scatter_tensor); its
                      backward an all_gather_into_tensor
  combine_slots       [e/sp, ...] -> [e, ...]: every rank's experts' slots
                      in rank order (all_gather_into_tensor); its backward a
                      reduce_scatter_tensor

and, for serving over a mesh (``models/serve.py``, ``runtime/decode_loop.py``,
``runtime/paged.py``), outside autograd, each an all_gather_into_tensor
concatenating along dim 0 in rank order:

  gather_heads        [b, s, w] -> [b, s, sp*w]: every model rank's heads'
                      attention outputs (an exact concatenation)
  gather_channels     [..., c] -> [..., sp*c]: every model rank's channels of
                      a recurrent mixer's activations (an exact concatenation)
  gather_state        [n, ...] -> [sp, n, ...]: every model rank's partial
                      online-softmax state over its positions
  gather_rows         [b, ...] -> [dp*b, ...]: every data rank's rows (the
                      pool writes, the MoE FFN's input, the logits)
  gather_harvest      the same, a segment's harvest
  gather_pages        [n, ...] -> [sp*n, ...]: every model rank's slice of
                      a prefix cache's pages (the store's save)

Each adds one to its call count and the bytes it hands to the collective
(the tensor it sends) to its byte count, in ``calls`` and ``nbytes``; the
slot collectives count their backward under their own name too
(``chip_smoke.py`` reads them as it reads the kernels' launches).  Every
call is synchronous and on the tensors' own device: NCCL moves CUDA tensors
device to device, and gloo takes CUDA tensors too (it stages them through
host memory itself).  Nothing here picks a backend: the caller's mesh has
one.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional

import torch
import torch.distributed as dist

COLLECTIVES = ("seq_to_heads", "heads_to_seq", "gather_seq", "reduce_scatter_seq",
               "all_reduce_sum", "all_reduce_max", "gather_spans", "reduce_scatter_spans",
               "gather_counts", "gather_params", "reduce_scatter_grads", "dispatch_slots",
               "combine_slots", "gather_heads", "gather_channels", "gather_state", "gather_rows",
               "gather_harvest", "gather_pages")
# calls and bytes handed in since the last reset_counts()
calls = dict.fromkeys(COLLECTIVES, 0)
nbytes = dict.fromkeys(COLLECTIVES, 0)


def reset_counts() -> None:
    for name in COLLECTIVES:
        calls[name] = nbytes[name] = 0


def _count(name: str, t: torch.Tensor) -> None:
    calls[name] += 1
    nbytes[name] += t.numel() * t.element_size()


def _all_gather0(x: torch.Tensor, group, name: str) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along dim 0 in rank order
    (as gloo takes it), counted as ``name``."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    _count(name, x)
    with warnings.catch_warnings():  # newer torch renames it all_gather_single
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x, group=group)
    return out


def _reduce_scatter0(send: torch.Tensor, group, name: str) -> torch.Tensor:
    """Block ``rank`` of ``send`` along dim 0 summed over ``group``, counted
    as ``name``."""
    n = dist.get_world_size(group)
    if send.shape[0] % n:
        raise ValueError(f"{name}: {send.shape[0]} rows do not split over {n} ranks")
    send = send.contiguous()
    out = send.new_empty((send.shape[0] // n, *send.shape[1:]))
    _count(name, send)
    with warnings.catch_warnings():  # newer torch renames it reduce_scatter_single
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, send, op=dist.ReduceOp.SUM, group=group)
    return out


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """``mesh`` (``launch/mesh.py::Mesh``) or None for one rank.  Whether
    FPDT keeps idle chunks in host memory is ``cfg.fpdt_offload``'s alone."""

    mesh: Any = None

    @property
    def sp(self) -> int:
        return 1 if self.mesh is None else self.mesh.model

    @property
    def dp(self) -> int:
        return 1 if self.mesh is None else self.mesh.data

    @property
    def sp_rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.model_rank

    @property
    def dp_rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.data_rank

    @property
    def rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.rank

    @property
    def sp_group(self):
        return None if self.mesh is None else self.mesh.model_group

    @property
    def dp_group(self):
        return None if self.mesh is None else self.mesh.data_group


def distributed(par: Optional[ParallelContext]) -> bool:
    return par is not None and par.mesh is not None


def seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """[b, h, c, dh] (this rank's c tokens of a chunk, every head) ->
    [b, h/sp, sp*c, dh] (the chunk's tokens in rank order, this rank's
    heads), contiguous."""
    sp = dist.get_world_size(group)
    b, h, c, d = x.shape
    if h % sp:
        raise ValueError(f"seq_to_heads: {h} heads do not split over {sp} ranks")
    send = x.reshape(b, sp, h // sp, c, d).transpose(0, 1).contiguous()  # by destination
    recv = torch.empty_like(send)  # by source: its token block
    _count("seq_to_heads", send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, h // sp, sp * c, d)


def heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """The inverse of ``seq_to_heads``: [b, h/sp, sp*c, dh] -> [b, h, c, dh]."""
    sp = dist.get_world_size(group)
    b, hl, s, d = x.shape
    if s % sp:
        raise ValueError(f"heads_to_seq: {s} tokens do not split over {sp} ranks")
    send = x.reshape(b, hl, sp, s // sp, d).permute(2, 0, 1, 3, 4).contiguous()
    recv = torch.empty_like(send)  # by source: its head group
    _count("heads_to_seq", send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.transpose(0, 1).reshape(b, sp * hl, s // sp, d)


def gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    """[b, h, c, dh] -> [b, h, sp*c, dh]: every rank's tokens in rank order."""
    sp = dist.get_world_size(group)
    b, h, c, d = x.shape
    out = _all_gather0(x, group, "gather_seq")
    return out.view(sp, b, h, c, d).permute(1, 2, 0, 3, 4).reshape(b, h, sp * c, d)


def reduce_scatter_seq(x: torch.Tensor, group) -> torch.Tensor:
    """[b, h, sp*c, dh] -> [b, h, c, dh]: the sum over the group of this
    rank's token block."""
    sp = dist.get_world_size(group)
    b, h, s, d = x.shape
    if s % sp:
        raise ValueError(f"reduce_scatter_seq: {s} tokens do not split over {sp} ranks")
    send = x.reshape(b, h, sp, s // sp, d).permute(2, 0, 1, 3, 4).reshape(sp * b, h, s // sp, d)
    return _reduce_scatter0(send, group, "reduce_scatter_seq")


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``x`` in place over ``group`` (None: the world); returns ``x``."""
    if not x.is_contiguous():
        raise ValueError("all_reduce_sum: the tensor must be contiguous")
    _count("all_reduce_sum", x)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``group`` (None: the world), in
    place; returns ``x``.  Exact, whatever the order."""
    if not x.is_contiguous():
        raise ValueError("all_reduce_max: the tensor must be contiguous")
    _count("all_reduce_max", x)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


class _GatherSpans(torch.autograd.Function):
    """All-gather of every rank's spans; its adjoint sums each rank's block
    of the gradient over the group (reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        sp = dist.get_world_size(group)
        b, u, *rest = x.shape
        out = _all_gather0(x, group, "gather_spans")
        return out.view(sp, b, u, *rest).movedim(0, 2).reshape(b, u * sp, *rest)

    @staticmethod
    def backward(ctx, g):
        sp = dist.get_world_size(ctx.group)
        b, n, *rest = g.shape
        send = g.reshape(b, n // sp, sp, *rest).movedim(2, 0).reshape(sp * b, n // sp, *rest)
        return _reduce_scatter0(send, ctx.group, "reduce_scatter_spans"), None


def gather_spans(x: torch.Tensor, group) -> torch.Tensor:
    """[b, u, ...] (this rank's u spans) -> [b, u*sp, ...]: every rank's
    spans in global order, rank m's span i at i*sp + m.  Differentiable:
    the backward hands this rank the sum over the group of its spans'
    gradients (``reduce_scatter_spans``)."""
    return _GatherSpans.apply(x, group)


def gather_counts(x: torch.Tensor, group=None) -> torch.Tensor:
    """[rows, e] (this rank's integer counts) -> [n, rows, e]: every rank's
    counts in rank order over ``group`` (None: the world, n its size)."""
    return _all_gather0(x, group, "gather_counts").view(dist.get_world_size(group), *x.shape)


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim``, in rank
    order (counted as gather_params)."""
    out = _all_gather0(x, group, "gather_params")
    if dim == 0:
        return out
    return out.view(-1, *x.shape).movedim(0, dim).flatten(dim, dim + 1)


def _reduce_scatter_dim(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over ``group`` of this rank's block of ``g`` along ``dim``
    (counted as reduce_scatter_grads)."""
    n = dist.get_world_size(group)
    send = g.unflatten(dim, (n, g.shape[dim] // n)).movedim(dim, 0).flatten(0, 1)
    return _reduce_scatter0(send, group, "reduce_scatter_grads")


class _GatherParams(torch.autograd.Function):
    """All-gathers of a weight's shard along its split dimensions, in
    ``steps`` order; the adjoint reduce-scatters in the reverse order.  It
    saves nothing: the backward needs only the gradient."""

    @staticmethod
    def forward(ctx, x, steps):
        ctx.steps = steps
        for dim, group in steps:
            x = _gather_dim(x, dim, group)
        return x

    @staticmethod
    def backward(ctx, g):
        for dim, group in reversed(ctx.steps):
            g = _reduce_scatter_dim(g, dim, group)
        return g, None


def gather_params(x: torch.Tensor, steps) -> torch.Tensor:
    """The whole weight from this rank's shard ``x``: an all-gather along
    ``dim`` over ``group`` for each (dim, group) of ``steps`` (one call
    each).  Differentiable: the backward hands this rank the sum over the
    groups of its block of the gradient (``reduce_scatter_grads``, one call
    a step, the last step's first)."""
    return _GatherParams.apply(x, tuple(steps))


class _DispatchSlots(torch.autograd.Function):
    """Reduce-scatter of the slots along dim 0; its adjoint all-gathers."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter0(x, group, "dispatch_slots")

    @staticmethod
    def backward(ctx, g):
        return _all_gather0(g, ctx.group, "dispatch_slots"), None


class _CombineSlots(torch.autograd.Function):
    """All-gather of the slots along dim 0; its adjoint reduce-scatters."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather0(x, group, "combine_slots")

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter0(g, ctx.group, "combine_slots"), None


def dispatch_slots(x: torch.Tensor, group) -> torch.Tensor:
    """[e, ...] (the slots of every expert that this rank filled) ->
    [e/sp, ...]: the slots of this rank's block of experts, summed over the
    group.  Where every slot has at most one writer in the group the sum is
    exact (it adds zeros).  Differentiable: the backward all-gathers the
    gradient."""
    return _DispatchSlots.apply(x, group)


def combine_slots(x: torch.Tensor, group) -> torch.Tensor:
    """[e/sp, ...] (this rank's experts' outputs) -> [e, ...]: every rank's,
    in rank order.  Differentiable: the backward hands this rank the sum
    over the group of its experts' block of the gradient."""
    return _CombineSlots.apply(x, group)


def gather_heads(x: torch.Tensor, group) -> torch.Tensor:
    """[b, s, w] (this rank's heads' outputs, head-major) -> [b, s, sp*w]:
    every rank's in rank order, which is head order."""
    sp = dist.get_world_size(group)
    b, s, w = x.shape
    out = _all_gather0(x, group, "gather_heads")
    return out.view(sp, b, s, w).permute(1, 2, 0, 3).reshape(b, s, sp * w)


def gather_channels(x: torch.Tensor, group) -> torch.Tensor:
    """[..., c] (this rank's channels of the last dim) -> [..., sp*c]: every
    rank's in rank order, which is channel order."""
    sp = dist.get_world_size(group)
    lead, c = x.shape[:-1], x.shape[-1]
    out = _all_gather0(x.reshape(1, -1, c), group, "gather_channels")
    return out.view(sp, -1, c).permute(1, 0, 2).reshape(*lead, sp * c)


def gather_state(x: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] (this rank's partial softmax state, packed) -> [sp, n, ...]."""
    return _all_gather0(x, group, "gather_state").view(dist.get_world_size(group), *x.shape)


def gather_rows(x: torch.Tensor, group, name: str = "gather_rows") -> torch.Tensor:
    """[b, ...] (this data rank's rows) -> [dp*b, ...]: every data rank's
    rows in rank order, which is row order; counted as ``name``
    (``gather_rows``, ``gather_harvest`` or ``gather_pages``)."""
    return _all_gather0(x, group, name)
