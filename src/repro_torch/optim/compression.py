"""Int8 gradient compression with error feedback: the JAX package's
``optim/compression.py``.

Each leaf's gradient plus its residual, ``target = g + residual`` in fp32,
is cut into blocks of ``BLOCK`` elements of the leaf's row-major flat order
(the last block padded with zeros); a block is scaled by its largest
magnitude over 127 (plus 1e-12), rounded half to even to int8 in [-127,
127] and scaled back.  The step uses the dequantized ``g_hat`` and carries
``target - g_hat`` (taken against the fp32 ``g_hat``, also for a bf16
gradient, as the reference does) as the next residual, so the noise of
the compression does not accumulate.  The arithmetic is the reference's,
operation for operation, and gives its bits: each division is a true
division (a device scalar as divisor: PyTorch's CUDA division by a host
scalar multiplies by its reciprocal instead), and ``q`` passes through
int8, so that a rounded -0 comes back as +0.

``compress``, ``decompress``, ``quantize_with_feedback``,
``tree_quantize_with_feedback`` and ``init_residuals`` are the
reference's functions (new tensors out).  The train step
(``runtime/train_loop.py`` under ``compress_grads``) calls
``tree_quantize_with_feedback_``, which writes ``g_hat`` into the
gradients and the new residuals into the residuals, ``SLAB`` elements at a
time, so its fp32 temporaries stay small (llama3.2-1b's tied table has
262,668,288 elements).

Under a mesh a rank holds ZeRO-3 shards (``launch/shardings.py``), and a
leaf split along a dimension other than its first has blocks that hold
elements of several shards (llama3.2-1b's [cycles, 2048] norm stacks on 2
data ranks, its table's d on 2 model ranks).  The blocks stay those of the
whole leaf: each element's block is its whole-leaf flat index // BLOCK
(``shardings.flat_index``); a rank reduces its elements' magnitudes into a
zeroed fp32 buffer of the leaf's blocks (scatter with amax), the buffers
are reduced with MAX over the group the leaf is split over
(``parallel.all_reduce_max``: one call a group, all such leaves in one
buffer; exact whatever the order, so every rank computes the same scale
bits), and the rank quantizes its elements with their blocks' scales.  A
leaf whose shards hold whole blocks, or that is not split, is quantized
where it is: after ``reduce_grads`` every rank that holds a shard holds
the same summed gradient.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import parallel as P
from repro_torch.launch import shardings as SH
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

BLOCK = 2048
SLAB = BLOCK << 13  # elements quantized at once (16 Mi; 64 MiB a fp32 temporary)
# A slab's temporaries: its fp32 target, then target / scale (rounded in
# place) beside q in int8, then q * scale; 9 bytes an element at most, 13
# in the last slab of a leaf that ends inside a block (its padded copy).


class Compressed(NamedTuple):
    q: torch.Tensor  # int8 payload [blocks, BLOCK]
    scale: torch.Tensor  # fp32 per-block scales [blocks, 1]


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """fp32 block maxima -> fp32 scales: amax / 127 + 1e-12."""
    return amax / amax.new_tensor(127.0) + 1e-12


def _quantize(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 round(t / scale) clipped to [-127, 127] of fp32 ``t``."""
    x = t / scale
    return x.round_().clamp_(-127, 127).to(torch.int8)


def _dequantize(t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 ``q * scale`` of fp32 ``t`` (q as ``_quantize`` gives it)."""
    return _quantize(t, scale).float().mul_(scale)


def compress(x: torch.Tensor) -> Compressed:
    flat = x.float().reshape(-1)
    blocks = F.pad(flat, (0, (-flat.numel()) % BLOCK)).view(-1, BLOCK)
    scale = _scale(torch.amax(blocks.abs(), dim=1, keepdim=True))
    return Compressed(q=_quantize(blocks, scale), scale=scale)


def decompress(c: Compressed, shape, dtype) -> torch.Tensor:
    n = math.prod(shape)
    flat = (c.q.float() * c.scale).reshape(-1)[:n]
    return flat.reshape(shape).to(dtype)


def quantize_with_feedback(g: torch.Tensor, residual: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (dequantized g_hat in g's dtype, new residual in the
    residual's dtype).  g_hat + residual' == g + residual (in fp32 before
    the casts)."""
    out = g.clone(memory_format=torch.contiguous_format)
    res = residual.clone(memory_format=torch.contiguous_format)
    return quantize_with_feedback_(out, res)


def tree_quantize_with_feedback(grads, residuals):
    out = [quantize_with_feedback(g, r) for g, r in zip(tree_leaves(grads), tree_leaves(residuals))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def init_residuals(params):
    """fp32 zeros shaped like each leaf (under a mesh: this rank's shards)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


# ---------------------------------------------------------------------------
# in place, slab by slab: the train step's
# ---------------------------------------------------------------------------


def _flat(x: torch.Tensor) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError("gradient compression works on contiguous tensors")
    return x.view(-1)


@torch.no_grad()
def quantize_with_feedback_(g: torch.Tensor, residual: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_with_feedback`` of a whole leaf, written into ``g`` and
    ``residual``; returns them."""
    gf, rf = _flat(g), _flat(residual)
    n = gf.numel()
    for start in range(0, n, SLAB):
        stop = min(n, start + SLAB)
        t = gf[start:stop].float() + rf[start:stop].float()
        pad = (-t.numel()) % BLOCK
        blocks = (F.pad(t, (0, pad)) if pad else t).view(-1, BLOCK)
        g_hat = _dequantize(blocks, _scale(torch.amax(blocks.abs(), dim=1, keepdim=True)))
        g_hat = g_hat.view(-1)[:stop - start]
        gf[start:stop].copy_(g_hat)
        rf[start:stop].copy_(t.sub_(g_hat))
    return g, residual


def _row_slabs(shape) -> List[Tuple[int, int]]:
    """(start, stop) rows along dimension 0 of at most about SLAB elements."""
    if not shape:
        return [(0, 1)]
    rows = max(1, SLAB // max(1, math.prod(shape[1:])))
    return [(r, min(shape[0], r + rows)) for r in range(0, shape[0], rows)]


def _sharded_slabs(plan, g, residual, par):
    """(start row, stop row, flat fp32 target, flat block ids) of each row
    slab of this rank's shard."""
    for start, stop in _row_slabs(tuple(g.shape)):
        t = g[start:stop].float() + residual[start:stop].float()
        ids = SH.flat_index(plan, par.dp_rank, par.sp_rank, start, stop, g.device) // BLOCK
        yield start, stop, t.reshape(-1), ids.reshape(-1)


def straddles(plan) -> bool:
    """A split leaf with a block that holds elements of more than one shard."""
    return (plan.data_split or plan.model_split) and SH.run_length(plan) % BLOCK != 0


@torch.no_grad()
def tree_quantize_with_feedback_(grads, residuals, par=None, plans=None):
    """``tree_quantize_with_feedback`` written into ``grads`` and
    ``residuals``; returns them.  Under a mesh (``plans`` the leaves'
    ``launch/shardings.py`` plans) the trees hold this rank's shards and
    the blocks are the whole leaves' (the module docstring)."""
    gl, rl = tree_leaves(grads), tree_leaves(residuals)
    pl = tree_leaves(plans) if plans is not None else [None] * len(gl)
    cut = [i for i, p in enumerate(pl) if p is not None and straddles(p)]
    for i, (g, r) in enumerate(zip(gl, rl)):
        if i not in cut:
            quantize_with_feedback_(g, r)
    if not cut:
        return grads, residuals
    # the block maxima of every straddling leaf: this rank's elements, then
    # MAX over the leaf's group, one buffer and one call a group
    by_group: Dict[Any, List[int]] = {}
    for i in cut:
        by_group.setdefault(SH.split_group(pl[i], par), []).append(i)
    amax: Dict[int, torch.Tensor] = {}
    for group, idx in by_group.items():
        sizes = [-(-math.prod(pl[i].shape) // BLOCK) for i in idx]
        buf = torch.zeros(sum(sizes), dtype=torch.float32, device=gl[idx[0]].device)
        for i, part in zip(idx, buf.split(sizes)):
            for _, _, t, ids in _sharded_slabs(pl[i], gl[i], rl[i], par):
                part.scatter_reduce_(0, ids, t.abs_(), reduce="amax")
            amax[i] = part
        P.all_reduce_max(buf, group)
    for i in cut:
        scale = _scale(amax[i])
        gf, rf = gl[i], rl[i]
        for start, stop, t, ids in _sharded_slabs(pl[i], gf, rf, par):
            g_hat = _dequantize(t, scale[ids])
            gf[start:stop].copy_(g_hat.view(gf[start:stop].shape))
            rf[start:stop].copy_(t.sub_(g_hat).view(rf[start:stop].shape))
    return grads, residuals


def quantize_with_feedback_sharded(plan, g: torch.Tensor, residual: torch.Tensor, par
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_with_feedback`` of this rank's shard ``g`` (and its
    residual) of a leaf planned by ``plan`` on ``par``'s mesh, with the
    whole leaf's blocks: this rank's shard of ``quantize_with_feedback``
    of the whole leaf, bit for bit.  New tensors out; a straddling leaf
    issues one ``all_reduce_max``."""
    out = g.clone(memory_format=torch.contiguous_format)
    res = residual.clone(memory_format=torch.contiguous_format)
    tree_quantize_with_feedback_([out], [res], par, [plan])
    return out, res

