"""The ``data`` x ``model`` mesh on ``torch.distributed`` process groups.

``make_mesh(data, model)`` is the port's counterpart of the JAX package's
``make_compat_mesh((data, model), ("data", "model"))``: rank r = d * model
+ m, model fastest, which is that mesh's device order.  It builds one
``model`` group per data rank (the sequence-parallel group: FPDT's
all-to-all and gathers) and one ``data`` group per model rank, every rank
calling ``new_group`` for every group in the same order, as
``torch.distributed`` requires.

``init_from_env(backend)`` joins the world that ``RANK``, ``WORLD_SIZE``
and ``LOCAL_RANK`` describe, through ``MASTER_ADDR``/``MASTER_PORT`` (what
``torchrun`` sets) or, when ``DIST_INIT_METHOD`` names one, a ``file://``
store (what the train CLI sets when it spawns the ranks itself).  The
backend is the caller's: NCCL needs one card a rank, and with more ranks on
the host than cards it stops with a message; nothing switches backend.
Serving over a mesh waits for the serve engines.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Tuple

import numpy as np
import torch
import torch.distributed as dist

INIT_METHOD_ENV = "DIST_INIT_METHOD"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a ``data`` x ``model`` mesh."""

    data: int
    model: int
    rank: int
    backend: str
    data_group: Any
    model_group: Any

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def ranks(self) -> np.ndarray:
        """[data, model] global ranks: the device order of the JAX mesh."""
        return np.arange(self.data * self.model).reshape(self.data, self.model)


def make_mesh(data: int, model: int) -> Mesh:
    """The mesh over the initialised world, whose size must be data * model."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed world "
                           "(init_from_env or init_process_group)")
    world = dist.get_world_size()
    if data < 1 or model < 1 or world != data * model:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} ranks; the world has "
                         f"{world}")
    rank = dist.get_rank()
    grid = np.arange(world).reshape(data, model)
    model_group = data_group = None
    for row in grid:  # every rank creates every group, in one order
        g = dist.new_group(row.tolist())
        if rank in row:
            model_group = g
    for col in grid.T:
        g = dist.new_group(col.tolist())
        if rank in col:
            data_group = g
    return Mesh(data, model, rank, dist.get_backend(), data_group, model_group)


def parse_mesh(spec: str) -> Tuple[int, int]:
    """``host8`` (the JAX CLI's 2 data x 4 model) or ``DxM``."""
    if spec == "host8":
        return 2, 4
    try:
        data, model = (int(n) for n in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes none, host8 or DxM (e.g. 1x2), not {spec!r}") from None
    if data < 1 or model < 1:
        raise ValueError(f"--mesh {spec}: both sizes must be >= 1")
    return data, model


def init_from_env(backend: str) -> Tuple[int, int, int]:
    """Join the world the environment describes; returns (rank, world size,
    local rank)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if backend == "nccl":
        on_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        cards = torch.cuda.device_count()
        if on_host > cards:
            raise SystemExit(f"nccl needs one card a rank: {on_host} ranks on this host, "
                             f"{cards} cards (gloo can share a card: --dist-backend gloo)")
    init = os.environ.get(INIT_METHOD_ENV, "env://")
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
    return rank, world, local_rank


def rank_device(kind: str, local_rank: int) -> torch.device:
    """cuda:(local_rank % cards) on the card, else the CPU."""
    if kind == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", local_rank % torch.cuda.device_count())
