"""Parallel context of the single-device path.

Only what the single-device serve path reads is ported: the chunk-kernel
implementation and the host-offload switch.  Meshes (and with them the
Ulysses/CP distribution) come with the distribution slice, so ``mesh``
must stay ``None``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    mesh: Any = None
    # chunk-op implementation: "cuda" | "torch"; None picks by the tensors'
    # device (kernels/flash_attention/ops.py::chunk_fwd)
    attn_impl: Optional[str] = None
    offload_to_host: bool = True  # honor fpdt_offload configs

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "device meshes are not yet ported to repro_torch (distribution slice)")
