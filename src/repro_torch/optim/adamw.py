"""AdamW with fp32 state, as the JAX package's ``optim/adamw.py``.

Parameters keep their own dtype and are updated from fp32 arithmetic; the
moments are kept in ``state_dtype`` (fp32 by default).  Unlike the JAX
function, ``apply`` writes the new parameters and moments into the given
tensors in place, so a step holds no second copy of the model or of its
state, and returns the same trees; a large leaf is updated in slices of
its leading axis, so the fp32 temporaries of its update stay small (a
[256000, 4096] table would otherwise take ~30 GB of them), and its squares
are summed for the global norm in slices too (gpt-2.7b's stacked MLP
weights, 839 M elements, would otherwise take 6.3 GiB of fp32 copies and
squares at once).  Each leaf
keeps its own dtype (fp32 gate biases in a bf16 model stay fp32).  The
scalars (step, learning rate, norm, clip scale, bias corrections) are 0-dim
fp32 tensors on the parameters' device, computed in the JAX function's
order, so a step never waits on a host read.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core import parallel as P
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"


class OptState(NamedTuple):
    step: torch.Tensor  # 0-dim int32
    m: Any
    v: Any


UPDATE_SLICE = 1 << 26  # elements of a leaf updated at once (256 MiB in fp32)
NORM_SLICE = 1 << 26  # elements of a leaf squared and summed at once for the norm


def _slices(*leaves, limit=None):
    """Matching views of ``leaves`` (one shape) along the leading axis, each
    of at most about ``limit`` (default UPDATE_SLICE) elements."""
    limit = UPDATE_SLICE if limit is None else limit
    t = leaves[0]
    if t.dim() == 0 or t.numel() <= limit:
        return [leaves]
    rows = max(1, limit // (t.numel() // t.shape[0]))
    return zip(*(x.split(rows) for x in leaves))


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_at(oc: OptConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac (fp32)."""
    step = torch.as_tensor(step).to(torch.float32)
    dev = step.device
    warm = step / _f32(max(1.0, oc.warmup_steps), dev)
    prog = (step - _f32(oc.warmup_steps, dev)) / _f32(max(1.0, oc.total_steps - oc.warmup_steps),
                                                     dev)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = oc.min_lr_frac + (1 - oc.min_lr_frac) * 0.5 * (1 + torch.cos(_f32(math.pi, dev) * prog))
    return oc.lr * torch.where(step < oc.warmup_steps, warm, cos)


def init(oc: OptConfig, params) -> OptState:
    dt = getattr(torch, oc.state_dtype)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def _squares(leaves):
    """The sum of every squared element of ``leaves`` in fp32 (None for no
    leaf); a leaf of more than NORM_SLICE elements is summed slice by
    slice."""
    total = None
    for leaf in leaves:
        for (g,) in _slices(leaf, limit=NORM_SLICE):
            sq = torch.sum(torch.square(g.float()))
            total = sq if total is None else total + sq
    return total


def global_norm(grads, par=None, plans=None) -> torch.Tensor:
    """sqrt of the sum of every squared gradient element, in fp32.

    Under a mesh (``par``, with the leaves' ``launch/shardings.py`` plans)
    ``grads`` are this rank's shards, and each distinct element is counted
    once: the rank's own squares, by the axes its leaves are split on, are
    summed over those axes, the data-split and doubly split sums in one
    ``all_reduce_sum`` over data, then the model-split sum and the doubly
    split one in one over model; a leaf split on neither counts as it is.
    So every rank reads the same norm, one rank's to rounding."""
    if plans is None:
        return torch.sqrt(_squares(tree_leaves(grads)))
    by = {}
    for plan, g in zip(tree_leaves(plans), tree_leaves(grads)):
        by.setdefault((plan.data_split, plan.model_split), []).append(g)
    dev = tree_leaves(grads)[0].device
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def part(key):
        sq = _squares(by.get(key, []))
        return zero if sq is None else sq

    data = torch.stack([part((True, False)), part((True, True))])
    if par.dp > 1:
        P.all_reduce_sum(data, par.dp_group)
    model = (part((False, True)) + data[1]).reshape(1)
    if par.sp > 1:
        P.all_reduce_sum(model, par.sp_group)
    return torch.sqrt(part((False, False)) + data[0] + model[0])


@torch.no_grad()
def apply(oc: OptConfig, params, grads, state: OptState, par=None, plans=None):
    """Returns (params, new_state, metrics), params and moments updated in
    place.  Under a mesh the trees hold this rank's shards (the update is
    elementwise) and ``plans`` their ``launch/shardings.py`` plans, which
    ``global_norm`` reads."""
    gnorm = global_norm(grads, par, plans)
    scale = torch.clamp(oc.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(oc, step)
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(_f32(oc.b1, stepf.device), stepf)
    c2 = 1.0 - torch.pow(_f32(oc.b2, stepf.device), stepf)
    dt = getattr(torch, oc.state_dtype)

    def upd(p, g, m, v):
        g = g.float() * scale
        m1 = oc.b1 * m.float() + (1 - oc.b1) * g
        v1 = oc.b2 * v.float() + (1 - oc.b2) * g * g
        mh, vh = m1 / c1, v1 / c2
        step_w = mh / (torch.sqrt(vh) + oc.eps) + oc.weight_decay * p.float()
        p.copy_((p.float() - lr * step_w).to(p.dtype))
        m.copy_(m1.to(dt))
        v.copy_(v1.to(dt))

    for leaves in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
                      tree_leaves(state.v)):
        for p, g, m, v in _slices(*leaves):
            upd(p, g, m, v)
    return params, OptState(step, state.m, state.v), {"grad_norm": gnorm, "lr": lr}
