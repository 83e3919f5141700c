"""Sharded, async, elastic checkpointing: the twin of the JAX package's
``checkpoint/manager.py``, with its layout on disk.

Layout on disk (per step):
    <dir>/step_<N>.tmp/           written first
        MANIFEST.json             {"step", "index", "extra"}
        <leaf_id>.shard<k>.npy    axis-0 slices of each leaf, raw bytes
    <dir>/step_<N>/               atomic rename on completion (commit point)

A leaf's key is its JAX path string (``params/cycles/pos0/attn/wq``,
``params/tail/0/...``, ``opt/m/...``, ``opt/step``; ``<leaf_id>`` is the
key with ``__`` for ``/``), its dtype the name JAX writes (``bfloat16``,
``float32``, ``int32``), and each of its at most ``shards_per_leaf`` files
a uint8 array of the raw bytes of its rows between ``np.linspace`` bounds.
So either package's manager reads the other's checkpoints; bf16 crosses as
its 16-bit patterns, with no extension dtype.

* ``save`` snapshots every leaf to a host copy on the caller's thread
  before it returns (AdamW updates the parameters and moments in place, so
  a writer that read the device tensors later would write the next step's
  values), then writes in a background thread; ``wait()`` joins it.
  Under a mesh (a ``launch/shardings.py`` layout, ``cfg`` and ``par``)
  each sharded leaf is gathered whole one at a time, so no rank holds more
  than one whole leaf beside its shards, and rank 0 alone keeps the copy
  and writes; ``wait()`` then ends in a barrier, so every rank sees the
  committed step.
* ``restore`` reads the manifest and reassembles each leaf, and each rank
  keeps its own shard under the *current* mesh's plan: a checkpoint saved
  on one mesh restores onto any other, or onto one rank.
* The SIGTERM-driven final save is in ``runtime/train_loop.py``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import parallel as P
from repro_torch.launch import shardings as SH


def _flatten_with_paths(tree, path: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(key, leaf) in the JAX package's leaf order: dict keys sorted, lists
    and tuples by index, a NamedTuple's fields by name."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten_with_paths(tree[k], path + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for k in tree._fields
                for x in _flatten_with_paths(getattr(tree, k), path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flatten_with_paths(v, path + (str(i),))]
    return [("/".join(path), tree)]


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(**{k: build(getattr(t, k)) for k in t._fields})
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _leaf_plans(cfg, par) -> Dict[str, SH.LeafPlan]:
    """{checkpoint key: plan} of the sharded leaves on ``par``'s mesh: the
    parameters under ``params/`` and their moments under ``opt/m/`` and
    ``opt/v/``; empty without a mesh."""
    plans = SH.plans_of(cfg, par) if cfg is not None else None
    if plans is None:
        return {}
    out = {}
    for path, plan in SH.by_path(plans).items():
        for prefix in ("params/", "opt/m/", "opt/v/"):
            out[prefix + path] = plan
    return out


class CheckpointManager:
    def __init__(self, directory: str, shards_per_leaf: int = 4, keep: int = 3,
                 cfg=None, par=None):
        self.dir = directory
        self.shards = shards_per_leaf
        self.keep = keep
        self.par = par if P.distributed(par) else None
        self.plans = _leaf_plans(cfg, self.par)
        self.rank = self.par.rank if self.par is not None else 0
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ----------------------------------------------------------- save
    @torch.no_grad()
    def _snapshot(self, tree) -> List[Tuple[str, np.ndarray, List[int], str]]:
        """(key, raw bytes, shape, dtype name) of every leaf, host copies
        (rank 0's; the other ranks only take part in the gathers)."""
        out = []
        for key, leaf in _flatten_with_paths(tree):
            plan = self.plans.get(key)
            if plan is not None:
                leaf = SH.gather(plan, leaf, self.par)
            if self.rank == 0:
                host = leaf.detach().to("cpu", copy=True).contiguous()
                raw = host.reshape(-1).view(torch.uint8).numpy()
                out.append((key, raw, list(host.shape), _dtype_name(host.dtype)))
            del leaf
        return out

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        self.wait()
        leaves = self._snapshot(tree)
        if self.rank != 0:
            return

        def _write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            index = {}
            for key, raw, shape, dtype in leaves:
                leaf_id = key.replace("/", "__")
                rows = shape[0] if shape else 1
                n = min(self.shards, max(1, rows))
                bounds = np.linspace(0, rows, n + 1, dtype=int)
                row_bytes = raw.size // max(1, rows)
                files = []
                for s in range(n):
                    fn = f"{leaf_id}.shard{s}.npy"
                    np.save(os.path.join(tmp, fn), raw[bounds[s] * row_bytes:
                                                       bounds[s + 1] * row_bytes])
                    files.append(fn)
                index[key] = {"files": files, "shape": shape, "dtype": dtype}
            manifest = {"step": step, "index": index, "extra": extra or {}}
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # commit
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the writer; under a mesh every rank then waits for rank 0's."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.par is not None:
            dist.barrier()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # ----------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, d, "MANIFEST.json")):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any) -> Tuple[Any, Dict]:
        """(a tree shaped like ``target`` holding the step's leaves, the
        manifest's extra): each leaf reassembled from its files, then this
        rank's shard of it under the manager's mesh, on the target leaf's
        device."""
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "MANIFEST.json")) as f:
            manifest = json.load(f)
        index = manifest["index"]
        leaves = []
        for key, like in _flatten_with_paths(target):
            meta = index[key]
            raw = np.concatenate([np.load(os.path.join(path, fn)) for fn in meta["files"]])
            full = torch.from_numpy(raw).view(getattr(torch, meta["dtype"])).reshape(meta["shape"])
            plan = self.plans.get(key)
            mine = SH.shard(plan, full, self.par) if plan is not None else full
            if tuple(mine.shape) != tuple(like.shape) or mine.dtype != like.dtype:
                raise ValueError(f"{key}: checkpoint holds {meta['dtype']}{meta['shape']}, "
                                 f"this rank takes {like.dtype}{tuple(like.shape)}")
            leaves.append(mine.to(like.device, copy=True))
            del raw, full, mine
        return _unflatten(target, leaves), manifest["extra"]
