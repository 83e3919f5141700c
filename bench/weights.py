"""Weights made by the benchmark from the run's seed, on the device, in the
dtype each leaf is trained in, one random call a leaf (a stacked leaf holds
every layer of its kind), so the same seed gives the same weights to the
program and to the reference.

The tree's shape and each leaf's dtype are the program's layout (its
``init_params`` run on the meta device, which makes no values); the values
follow the published initialisations, by the leaf's name:
  ``embed``                      0.02 * N(0, 1)
  a matrix (``w*``, ``head``)    N(0, 1) / sqrt(fan_in), fan_in its rows
  a norm's ``w``, Mamba's ``D``  ones;  a norm's ``b``, ``conv_b``: zeros
  ``b_dt``                       softplus^-1(dt), dt log-uniform in
                                 [1e-3, 0.1] (Mamba's dt init)
  ``A_log``                      log(1 .. d_state) in every channel (S4D-real)
"""
from __future__ import annotations

import math
from typing import Iterator, Tuple

import torch

DT_MIN, DT_MAX = 1e-3, 0.1


def leaf_paths(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, leaf) in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, path + (str(i),))
    else:
        yield path, tree


def _value(path, like: torch.Tensor, gen: torch.Generator, device) -> torch.Tensor:
    name, shape, dtype = path[-1], like.shape, like.dtype
    if name in ("b", "conv_b"):
        return torch.zeros(shape, dtype=dtype, device=device)
    if name == "D" or (name == "w" and "norm" in path[-2]):
        return torch.ones(shape, dtype=dtype, device=device)
    if name == "A_log":
        ds = shape[-1]
        row = torch.log(torch.arange(1, ds + 1, dtype=torch.float32, device=device))
        return row.expand(shape).to(dtype).contiguous()
    if name == "b_dt":
        u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
        dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN))
        return torch.log(torch.expm1(dt)).to(dtype)
    if name == "embed":
        return torch.randn(shape, generator=gen, device=device, dtype=dtype).mul_(0.02)
    if name == "head" or name.startswith("w") or name == "conv_w":
        w = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return w.mul_(1.0 / math.sqrt(shape[-2]))
    raise KeyError(f"no initialisation for leaf {'.'.join(path)}")


def make(skeleton, seed: int, device) -> dict:
    """A tree shaped as ``skeleton`` (leaves on any device, the meta device
    included: only shape and dtype are read), its values from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def build(tree, path):
        if isinstance(tree, dict):
            return {k: build(tree[k], path + (str(k),)) for k in sorted(tree)}
        if isinstance(tree, list):
            return [build(v, path + (str(i),)) for i, v in enumerate(tree)]
        return _value(path, tree, gen, device)

    return build(skeleton, ())


def flat(tree) -> dict:
    """The leaves by name, a stacked leaf of ``cycles`` split into its
    layers: ``cycles.<c>.<rest>`` (views)."""
    out = {}
    for path, leaf in leaf_paths(tree):
        if path[0] == "cycles":
            for c in range(leaf.shape[0]):
                out[".".join(("cycles", str(c)) + path[1:])] = leaf[c]
        else:
            out[".".join(path)] = leaf
    return out
