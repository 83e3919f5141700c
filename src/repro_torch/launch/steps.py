"""The dry-run's per-cell config: the paper's default chunking policy.

The twin of the JAX package's ``launch/steps.py::tuned_config``.  Its
``build``, which hands ``jax.jit`` a step function with its argument specs
and shardings to lower, has no twin: PyTorch compiles no program, so the
dry-run (``launch/dryrun.py``) reckons a cell's bytes from the shapes of
``launch/specs.py`` instead.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs import ModelConfig, ShapeConfig


def tuned_config(cfg: ModelConfig, shape: ShapeConfig, chunks: Optional[int] = None,
                 offload: Optional[bool] = None) -> ModelConfig:
    """Apply the paper's default chunking policy to a cell.

    Chunk size 64K tokens (paper §5.3 sweet spot): u = max(1, S/65536),
    lowered until it divides S; FFN chunks = 2*u (§5.4); offload on when
    u > 1.  MoE training chunks its FFN at least 8 ways (the dispatch's
    position tensors scale with tokens x k x E)."""
    S = shape.seq_len
    u = chunks if chunks is not None else max(1, S // 65536)
    while S % u:
        u -= 1
    off = offload if offload is not None else (u > 1)
    mlp_chunks = max(1, 2 * u) if u > 1 else 1
    if cfg.num_experts and shape.kind == "train":
        mlp_chunks = max(mlp_chunks, 8)
    return dataclasses.replace(cfg, fpdt_chunks=u, fpdt_offload=off, mlp_chunks=mlp_chunks)
