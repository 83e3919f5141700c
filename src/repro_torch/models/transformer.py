"""Model assembly: parameters stacked over layer cycles, as in the JAX package.

Layers are grouped into repeating *cycles* of the arch's block pattern
(dense: a 1-layer cycle) and each cycle's parameters are stacked along a
leading axis, so ``params["cycles"]["pos0"]["attn"]["wq"]`` is
``[n_cycles, d, q_dim]`` exactly like the JAX pytree; remainder layers live
in ``params["tail"]``.  Only the attention families with the token
frontend are ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.parallel import ParallelContext
from repro_torch.models import layers as L

Params = Dict[str, Any]

PORTED_KINDS = ("attn", "local_attn")


def _check_ported(cfg: ModelConfig):
    pat, _, tail = layout_of(cfg)
    bad = sorted({k for k in (*pat, *tail) if k not in PORTED_KINDS})
    if bad:
        raise NotImplementedError(f"{cfg.name}: block kinds {bad} are not yet ported")
    if cfg.num_experts:
        raise NotImplementedError(f"{cfg.name}: MoE blocks are not yet ported")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} frontend is not yet ported")


def _init_block(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> Params:
    """An attention block (attn or local_attn: the same parameters)."""
    return {
        "norm1": L.init_norm(cfg, dtype, device),
        "attn": L.init_attn(cfg, gen, dtype, device),
        "norm2": L.init_norm(cfg, dtype, device),
        "mlp": L.init_mlp(cfg, gen, dtype, device),
    }


def pattern_of(cfg: ModelConfig) -> Tuple[str, ...]:
    if cfg.block_pattern:
        return cfg.block_pattern
    return ("ssm",) if cfg.family == "ssm" else ("attn",)


def layout_of(cfg: ModelConfig):
    """(pattern, n_cycles, tail_kinds)."""
    pat = pattern_of(cfg)
    n_cycles = cfg.num_layers // len(pat)
    tail = tuple(pat[: cfg.num_layers % len(pat)])
    return pat, n_cycles, tail


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a dict/list parameter tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def cycle(tree, c: int):
    """The parameters (or cache) of layer cycle ``c``: views into the stacks."""
    return tree_map(lambda x: x[c], tree)


def init_params(cfg: ModelConfig, gen: torch.Generator, device="cuda") -> Params:
    """Random parameters from ``gen`` (a generator on ``device``), in the
    JAX package's pytree layout and initialisation scales."""
    _check_ported(cfg)
    dtype = getattr(torch, cfg.param_dtype)
    pat, n_cycles, tail = layout_of(cfg)
    params: Params = {
        "embed": (0.02 * torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                                     device=device)).to(dtype),
    }
    params["cycles"] = _stack([
        {f"pos{i}": _init_block(cfg, gen, dtype, device) for i in range(len(pat))}
        for _ in range(n_cycles)
    ])
    if tail:
        params["tail"] = [_init_block(cfg, gen, dtype, device) for _ in tail]
    params["final_norm"] = L.init_norm(cfg, dtype, device)
    if not cfg.tie_embeddings:
        params["head"] = L._dense_init(gen, (cfg.d_model, cfg.padded_vocab), dtype, device)
    return params


def head_matrix(cfg: ModelConfig, params: Params) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["head"]


def attn_kind(cfg: ModelConfig, par: Optional[ParallelContext]) -> str:
    """Single device: always ``local`` (meshes are not yet ported)."""
    return "local"


def embed_input(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]):
    """Token embeddings of ``batch["tokens"] [b, s]``."""
    if cfg.frontend != "none":
        raise NotImplementedError(f"the {cfg.frontend} frontend is not yet ported")
    return params["embed"][batch["tokens"]]
