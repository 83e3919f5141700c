"""Parallel context of the single-device path.

The single-device path reads nothing from it yet: host offload follows
``cfg.fpdt_offload`` alone (``core/fpdt.py``), and which chunk kernel runs
is decided by the tensors' device (``kernels/flash_attention/ops.py``).
Meshes (and with them the Ulysses/CP distribution) come with the
distribution slice, so ``mesh`` must stay ``None``.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    mesh: Any = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "device meshes are not yet ported to repro_torch (distribution slice)")
