"""Where every weight and AdamW moment lives on a mesh: ZeRO-3.

The twin of the JAX package's ``launch/shardings.py``.  ``split_dims`` is
its ``param_spec``: each leaf, from its path names and shape, has at most
one dimension split over ``data`` and one over ``model``:

* the embedding table [V, d]: V over data, d over model;
* the head [d, V]: d over model, V over data;
* an MoE leaf of three or more dimensions ([(cycles,) e, d, ff]; in a
  cycle stack the router [cycles, d, e] too): its third-last dimension
  over model, its second-last over data;
* every other leaf: its first dimension that divides by dp and is at
  least 4 dp over data, never axis 0 of a ``cycles`` stack;

each only where the dimension divides by the axis's size.  The moments
take the parameters' plan (the JAX ``opt_moment_shardings``), and the
step counter stays whole on every rank.

PyTorch has no GSPMD, so a rank stores only its block of each split
dimension (``shard``: block ``data_rank`` of the data dimension, block
``model_rank`` of the model dimension, the JAX mesh's layout) and the
model gathers a leaf where it uses it (``gather``: ``parallel.
gather_params`` over each split axis, data first; its adjoint
``reduce_scatter_grads`` hands the rank the sum over those axes of its
block of the gradient).  The gradient of a leaf replicated over an axis
is summed over that axis after the backward (``reduce_axes``).  An axis
of size 1 splits nothing, so on one rank, or wherever a split's axis has
size 1, every function here is the identity and issues no collective.

A leaf of ``params["cycles"]`` is gathered one cycle at a time, its view
of the stack (the split dimensions one further in); the router's stack,
whose cycles axis the MoE rule may split over model, is gathered whole
and sliced at its cycle (``splits_cycles``).

Where a shard's elements lie in the whole leaf's row-major flat order
(``offsets``, ``flat_index``, ``run_length``, ``straddling_blocks``) is
what the int8 gradient compression needs to cut the whole leaf's blocks
(``optim/compression.py``); ``state_bytes(..., residuals=True)`` counts its
fp32 residuals in a rank's state.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.core import parallel as P
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_unflatten

DATA, MODEL = "data", "model"


def _divisible(n: int, parts: int) -> bool:
    return parts > 0 and n % parts == 0


def split_dims(dp: int, sp: int, names, shape) -> Tuple[Optional[int], Optional[int]]:
    """(the dimension split over data, the one split over model) of a leaf
    at path ``names`` (parameter-tree keys, list indices as strings) with
    ``shape``, on a dp x sp mesh: the JAX package's ``param_spec``."""
    if not shape:
        return None, None
    if "embed" in names:
        return (0 if _divisible(shape[0], dp) else None,
                1 if _divisible(shape[1], sp) else None)
    if "head" in names:
        return (1 if _divisible(shape[1], dp) else None,
                0 if _divisible(shape[0], sp) else None)
    if "moe" in names and len(shape) >= 3:
        e_ax, d_ax = len(shape) - 3, len(shape) - 2
        return (d_ax if _divisible(shape[d_ax], dp) else None,
                e_ax if _divisible(shape[e_ax], sp) else None)
    for ax in range(len(shape)):
        if names and names[0] == "cycles" and ax == 0:
            continue
        if _divisible(shape[ax], dp) and shape[ax] >= dp * 4:
            return ax, None
    return None, None


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """A leaf's full shape and dtype, and where it is split on a dp x sp
    mesh (``split_dims``).  A split is active where its axis has more than
    one rank."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    dp: int
    sp: int
    data_dim: Optional[int]
    model_dim: Optional[int]

    @property
    def data_split(self) -> bool:
        return self.data_dim is not None and self.dp > 1

    @property
    def model_split(self) -> bool:
        return self.model_dim is not None and self.sp > 1

    def spec(self) -> tuple:
        """``param_spec``'s PartitionSpec entries: DATA, MODEL or None per
        dimension."""
        out = [None] * len(self.shape)
        if self.data_dim is not None:
            out[self.data_dim] = DATA
        if self.model_dim is not None:
            out[self.model_dim] = MODEL
        return tuple(out)

    def local_shape(self) -> Tuple[int, ...]:
        shape = list(self.shape)
        if self.data_split:
            shape[self.data_dim] //= self.dp
        if self.model_split:
            shape[self.model_dim] //= self.sp
        return tuple(shape)

    def local_bytes(self) -> int:
        return math.prod(self.local_shape()) * self.dtype.itemsize

    @property
    def splits_cycles(self) -> bool:
        """Axis 0 of a stack split (the MoE rule on the router's stack)."""
        return (self.data_split and self.data_dim == 0) or (self.model_split
                                                            and self.model_dim == 0)

    def cycle(self) -> "LeafPlan":
        """The plan of one cycle's view of this stacked leaf."""
        if self.splits_cycles:
            raise ValueError("a stack split along its cycles axis is gathered whole")
        less = lambda d: None if d is None else d - 1  # noqa: E731
        return dataclasses.replace(self, shape=self.shape[1:], data_dim=less(self.data_dim),
                                   model_dim=less(self.model_dim))


@functools.lru_cache(maxsize=64)
def param_plans(cfg: ModelConfig, dp: int, sp: int):
    """The parameter tree's LeafPlans on a dp x sp mesh, from its shapes
    (an initialisation on the meta device, which allocates nothing).  The
    AdamW moments take the same plans (the JAX ``opt_moment_shardings``)."""
    from repro_torch.models import transformer as T

    meta = T.init_params(cfg, torch.Generator(), "meta")
    return tree_unflatten(meta, [
        LeafPlan(tuple(t.shape), t.dtype, dp, sp, *split_dims(dp, sp, names, tuple(t.shape)))
        for names, t in tree_leaves_with_path(meta)])


def plans_of(cfg: ModelConfig, par) -> Optional[Any]:
    """``param_plans`` on ``par``'s mesh; None without a mesh."""
    if not P.distributed(par):
        return None
    return param_plans(cfg, par.dp, par.sp)


def by_path(plans) -> Dict[str, LeafPlan]:
    """{"cycles/pos0/attn/wq": plan, ...}."""
    return {"/".join(names): p for names, p in tree_leaves_with_path(plans)}


# ---------------------------------------------------------------------------
# a rank's shard, and the gathers
# ---------------------------------------------------------------------------


def _block(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)


def shard(plan: LeafPlan, full: torch.Tensor, par) -> torch.Tensor:
    """This rank's block of ``full`` (a copy that holds no reference to
    ``full``'s storage); ``full`` itself where nothing is split."""
    if tuple(full.shape) != plan.shape:
        raise ValueError(f"leaf of shape {tuple(full.shape)}, planned {plan.shape}")
    if not (plan.data_split or plan.model_split):
        return full
    x = full
    if plan.data_split:
        x = _block(x, plan.data_dim, plan.dp, par.dp_rank)
    if plan.model_split:
        x = _block(x, plan.model_dim, plan.sp, par.sp_rank)
    return x.clone(memory_format=torch.contiguous_format)


def gather(plan: Optional[LeafPlan], x: torch.Tensor, par) -> torch.Tensor:
    """The whole leaf from this rank's shard ``x``, gathered over data,
    then over model (differentiable: its backward reduce-scatters the
    gradient); ``x`` itself where nothing is split or there is no plan (no
    mesh)."""
    steps = []
    if plan is not None and plan.data_split:
        steps.append((plan.data_dim, par.dp_group))
    if plan is not None and plan.model_split:
        steps.append((plan.model_dim, par.sp_group))
    return P.gather_params(x, steps) if steps else x


def gather_tree(plans, tree, par):
    """``gather`` of every leaf of ``tree`` (``plans`` None: ``tree``)."""
    if plans is None:
        return tree
    return tree_unflatten(tree, [gather(p, x, par)
                                 for p, x in zip(tree_leaves(plans), tree_leaves(tree))])


def gather_cycle(plans, cyc_p, c: int, par):
    """Cycle ``c``'s whole parameters from its shards: each leaf a view of
    the cycle's slice of its stacked shard, or (``splits_cycles``) the
    whole stacked shard, gathered and sliced at ``c``."""
    if plans is None:
        return cyc_p
    return tree_unflatten(cyc_p, [
        gather(p, x, par)[c] if p.splits_cycles else gather(p.cycle(), x, par)
        for p, x in zip(tree_leaves(plans), tree_leaves(cyc_p))])


def shard_tree(plans, tree, par, cycle: bool = False):
    """This rank's shards of every leaf of ``tree`` (``plans`` None:
    ``tree``).  ``cycle``: ``tree`` is one cycle's slice of the stacks
    that ``plans`` plan, and a stack split along its cycles axis keeps its
    slice whole, to be sharded once stacked (``shard_cycles_axis``)."""
    if plans is None:
        return tree
    return tree_unflatten(tree, [
        (x if p.splits_cycles else shard(p.cycle(), x, par)) if cycle else shard(p, x, par)
        for p, x in zip(tree_leaves(plans), tree_leaves(tree))])


def shard_cycles_axis(plans, stacks, par):
    """The stacks that ``shard_tree(..., cycle=True)`` kept whole, sharded."""
    if plans is None:
        return stacks
    return tree_unflatten(stacks, [shard(p, x, par) if p.splits_cycles else x
                                   for p, x in zip(tree_leaves(plans), tree_leaves(stacks))])


def shard_params(cfg: ModelConfig, par, params):
    """This rank's shards of a whole parameter (or moment) tree."""
    return shard_tree(plans_of(cfg, par), params, par)


@torch.no_grad()
def gather_params_tree(cfg: ModelConfig, par, tree):
    """The whole parameter (or moment) tree from this rank's shards (for a
    comparison or a digest; the model gathers each leaf where it uses it)."""
    return gather_tree(plans_of(cfg, par), tree, par)


def reduce_axes(plan: LeafPlan, par) -> Optional[Any]:
    """The group a leaf's shard gradient is still summed over after its
    reduce-scatters: the axes it is replicated on (None: the world, both),
    or False where there is none."""
    data = par.dp > 1 and not plan.data_split
    model = par.sp > 1 and not plan.model_split
    if data and model:
        return None
    if data:
        return par.dp_group
    if model:
        return par.sp_group
    return False


def state_bytes(plans, state_dtype: torch.dtype, residuals: bool = False) -> int:
    """A rank's bytes of the parameters under ``plans``, of their two AdamW
    moments in ``state_dtype`` and of the int32 step counter; with
    ``residuals`` (``--compress-grads``) also of the fp32 error-feedback
    residuals, 4 bytes an element of the rank's shards."""
    per = 2 * state_dtype.itemsize + (4 if residuals else 0)
    return 4 + sum(p.local_bytes() + per * math.prod(p.local_shape()) for p in tree_leaves(plans))


# ---------------------------------------------------------------------------
# where a shard's elements lie in the whole leaf's row-major flat order
# ---------------------------------------------------------------------------


def offsets(plan: LeafPlan, dp_rank: int, sp_rank: int) -> Tuple[int, ...]:
    """The whole leaf's index, along each dimension, of the first element
    of the shard that rank (``dp_rank``, ``sp_rank``) holds."""
    local = plan.local_shape()
    out = [0] * len(plan.shape)
    if plan.data_split:
        out[plan.data_dim] = dp_rank * local[plan.data_dim]
    if plan.model_split:
        out[plan.model_dim] = sp_rank * local[plan.model_dim]
    return tuple(out)


def flat_index(plan: LeafPlan, dp_rank: int, sp_rank: int, start: int = 0,
               stop: Optional[int] = None, device=None) -> torch.Tensor:
    """int64 [stop - start, *local_shape()[1:]]: the whole leaf's row-major
    flat index of each element of rows ``start:stop`` (along dimension 0)
    of rank (``dp_rank``, ``sp_rank``)'s shard."""
    local = plan.local_shape()
    stop = local[0] if stop is None else stop
    strides = [math.prod(plan.shape[d + 1:]) for d in range(len(plan.shape))]
    out = None
    for d, (n, off, stride) in enumerate(zip(local, offsets(plan, dp_rank, sp_rank), strides)):
        lo, hi = (start, stop) if d == 0 else (0, n)
        a = (torch.arange(lo, hi, dtype=torch.int64, device=device) + off) * stride
        a = a.view([-1 if e == d else 1 for e in range(len(local))])
        out = a if out is None else out + a
    return out


def run_length(plan: LeafPlan) -> int:
    """The length of the runs of consecutive flat indices of the whole leaf
    that a shard holds: the whole leaf's row-major flat order is cut into
    runs of this many elements, consecutive runs on different shards (the
    whole leaf where nothing is split)."""
    dims = [d for d, on in ((plan.data_dim, plan.data_split), (plan.model_dim, plan.model_split))
            if on]
    if not dims:
        return math.prod(plan.shape)
    d = max(dims)
    return plan.local_shape()[d] * math.prod(plan.shape[d + 1:])


def straddling_blocks(plan: LeafPlan, block: int) -> int:
    """How many of the whole leaf's flat blocks of ``block`` elements
    (``optim/compression.py``'s quantisation blocks) hold elements of more
    than one shard."""
    run, n = run_length(plan), math.prod(plan.shape)
    if run % block == 0:
        return 0
    cuts = np.arange(run, n, run, dtype=np.int64)
    return int(np.unique(cuts[cuts % block != 0] // block).size)


def split_group(plan: LeafPlan, par) -> Optional[Any]:
    """The group whose ranks hold the other shards of a leaf: the data
    group, the model group, or None (the world) where it is split on both."""
    if plan.data_split and plan.model_split:
        return None
    return par.dp_group if plan.data_split else par.sp_group
