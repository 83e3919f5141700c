"""The ``data`` x ``model`` mesh on ``torch.distributed`` process groups.

``make_mesh(data, model)`` is the port's counterpart of the JAX package's
``make_compat_mesh((data, model), ("data", "model"))``: rank r = d * model
+ m, model fastest, which is that mesh's device order.  It builds one
``model`` group per data rank (the sequence-parallel group: FPDT's
all-to-all and gathers) and one ``data`` group per model rank (and, for
a serve mesh, the group of the whole mesh: a serve rank's writes to a
leaf every rank parks whole and a pool split by pages over every rank,
``models/serve.py``; the world's own group where there is one block),
every rank calling ``new_group`` for every group in the same order, as
``torch.distributed`` requires.  With ``replicas > 1`` the world is that
many blocks of ``data * model`` ranks, block r the ranks ``[r * data *
model, (r + 1) * data * model)``, each its own mesh with its own groups
(every rank still creates every block's groups, in block order); a rank
gets its block's mesh.  ``serve_mesh`` wraps it in a ``ParallelContext``:
one serve replica's mesh (``launch/serve.py`` runs a replica a block).

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
import multiprocessing.connection
import os
import sys
import tempfile
from typing import Any, Callable, List, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.parallel import ParallelContext

INIT_METHOD_ENV = "DIST_INIT_METHOD"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a ``data`` x ``model`` mesh: ``rank`` is its
    place in the mesh, ``first`` the world rank of the mesh's rank 0 (a
    block of a larger world), ``block`` the block's index, ``group`` the
    group of every rank of the mesh (a serve mesh's; None elsewhere)."""

    data: int
    model: int
    rank: int
    backend: str
    data_group: Any
    model_group: Any
    first: int = 0
    block: int = 0
    group: Any = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def ranks(self) -> np.ndarray:
        """[data, model] world ranks: the device order of the JAX mesh."""
        return self.first + np.arange(self.data * self.model).reshape(self.data, self.model)


def make_mesh(data: int, model: int, replicas: int = 1, whole: bool = False) -> Mesh:
    """This rank's mesh over the initialised world, whose size must be
    replicas * data * model: the ``data`` x ``model`` mesh of its block;
    with ``whole`` the group of the block's every rank too."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed world "
                           "(init_from_env or init_process_group)")
    world = dist.get_world_size()
    per = data * model
    if data < 1 or model < 1 or replicas < 1 or world != replicas * per:
        raise ValueError(f"{replicas} x a {data} x {model} mesh needs {replicas * per} ranks; "
                         f"the world has {world}")
    rank = dist.get_rank()
    block, model_group, data_group = rank // per, None, None
    group = dist.group.WORLD if whole and replicas == 1 else None
    for b in range(replicas):  # every rank creates every group, in one order
        grid = b * per + np.arange(per).reshape(data, model)
        if whole and replicas > 1:
            g = dist.new_group(grid.ravel().tolist())
            if b == block:
                group = g
        for row in grid:
            g = dist.new_group(row.tolist())
            if rank in row:
                model_group = g
        for col in grid.T:
            g = dist.new_group(col.tolist())
            if rank in col:
                data_group = g
    return Mesh(data, model, rank - block * per, dist.get_backend(), data_group, model_group,
                first=block * per, block=block, group=group)


def serve_mesh(data: int, model: int, replicas: int = 1):
    """One serve replica's mesh (the JAX package's ``serve_mesh``): this
    rank's block of ``data`` x ``model`` ranks as a ``ParallelContext``.
    ``models/serve.py::cache_shardings`` then splits the attention KV over
    ``model`` (kv heads, else positions) and the per-slot rows over
    ``data``."""
    return ParallelContext(make_mesh(data, model, replicas, whole=True))


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


def replica_devices(kind: str, n: int) -> List[torch.device]:
    """The devices of ``n`` replicas served by one process: the cards in
    turn, else the CPU."""
    cards = torch.cuda.device_count() if kind == "cuda" else 0
    return [torch.device("cuda", r % cards) if cards else torch.device("cpu") for r in range(n)]


def take_device(kind: str, local_rank: int, world: int) -> torch.device:
    """This rank's ``rank_device``, made current; on the CPU the ranks
    share the host's cores, so each takes its share of the threads."""
    device = rank_device(kind, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    return device


def default_backend(requested, device_kind: str) -> str:
    """``requested`` (a ``--dist-backend``), else nccl on the card and gloo
    on the CPU."""
    return requested or ("nccl" if device_kind == "cuda" else "gloo")


def run_ranks(world: int, backend: str, main: Callable, argv: List[str], as_rank: Callable):
    """A CLI's run over ``world`` ranks.  In a world started outside
    (torchrun, or ``spawn``: ``WORLD_SIZE`` is set) this process is one rank
    and returns ``as_rank()``; otherwise it spawns ``world`` ranks of
    ``main(argv)``, exits with a failed rank's code and returns None.  NCCL
    needs one card a rank; gloo ranks can share one."""
    if "WORLD_SIZE" in os.environ:
        return as_rank()
    if backend == "nccl" and world > torch.cuda.device_count():
        raise SystemExit(f"nccl needs one card a rank: {world} ranks, "
                         f"{torch.cuda.device_count()} cards (gloo can share a card: "
                         "--dist-backend gloo)")
    code = spawn(main, argv, world)
    if code:
        sys.exit(code)
    return None


def _spawned_rank(main: Callable, argv: List[str], rank: int, world: int, init_method: str):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), **{INIT_METHOD_ENV: init_method})
    main(argv)


def spawn(main: Callable, argv: List[str], world: int) -> int:
    """Run ``world`` ranks of a CLI's ``main(argv)`` (spawned processes, a
    ``file://`` store in a temporary directory, ``RANK`` and ``WORLD_SIZE``
    in their environment); the first rank to fail ends them all.  Returns
    0, or the exit code of a failed rank."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_spawned_rank, args=(main, argv, r, world, init))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            alive = list(procs)
            while alive:
                multiprocessing.connection.wait([p.sentinel for p in alive])
                alive = [p for p in alive if p.exitcode is None]
                failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if failed:
                    return failed[0] if failed[0] > 0 else 1
            return 0
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
