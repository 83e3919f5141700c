"""Shared prefix-cache store across serve replicas: the port's copy of the
JAX package's ``launch/kvstore.py``.

A single engine keeps a persistent prefix cache: ``save_kv_store``
walks the radix tree and writes every cached page payload to one npz;
``restore_kv_store`` loads it into the spill tier, where pages promote
back to device on their first prefix hit.  This module points that
machinery *sideways*: replicas behind the router publish their prefix
caches into one shared directory (one npz per replica — writers never
contend), and on replica death the router restores the dead replica's
file into the survivors.  Re-homed requests then resume against radix
entries that already hold their context — a warm promote instead of a
cold prefill — which is what makes failover cheap at long context.

Publishing is best-effort by design: the store is a cache of recoverable
state, never the source of truth, so a failed save/restore degrades to
recompute (a cold prefill on the survivor) rather than an error.  The
one crash-consistency fact it leans on: a ``PagedServeEngine`` whose
``generate`` raised mid-workload still has a consistent radix tree +
pool (``_admit``/``_dispatch`` sync at every mutation), so even the
*dead* replica's cache can be published post-mortem from the same
process — the in-process analogue of reading a crashed peer's store.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.runtime import telemetry as TM

__all__ = ["SharedKVStore"]


class SharedKVStore:
    """One npz prefix-cache file per replica under a shared root dir."""

    def __init__(self, root: str,
                 telemetry: Optional[TM.Telemetry] = None):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.published_pages: Dict[int, int] = {}  # replica -> pages in file
        self.errors = 0  # swallowed best-effort failures (for stats only)
        self.telemetry = telemetry if telemetry is not None \
            else TM.Telemetry(component="kvstore")

    def _event(self, kind: str, replica: int, pages: int) -> None:
        self.telemetry.registry.counter(f"{kind.replace('.', '_')}").inc()
        self.telemetry.registry.counter("kvstore_pages_moved").inc(pages)
        self.telemetry.event(kind, replica=replica, pages=pages)

    def path(self, replica: int) -> str:
        return os.path.join(self.root, f"replica{int(replica)}.npz")

    def publish(self, replica: int, engine: Any) -> int:
        """Persist ``engine``'s prefix cache as replica ``replica``'s file.

        Returns pages written (0 when the engine has nothing cached or
        the save failed — best-effort either way)."""
        try:
            n = int(engine.save_kv_store(self.path(replica)))
        except Exception:
            self.errors += 1
            self.telemetry.registry.counter("kvstore_errors").inc()
            return 0
        self.published_pages[replica] = n
        self._event("kvstore.publish", replica, n)
        return n

    def recover(self, dead: int, survivors: Sequence[Any]) -> int:
        """Restore the dead replica's published cache into every survivor.

        Restore is idempotent (live radix entries win over restored
        ones), so survivors that already share prefixes with the dead
        replica lose nothing.  Returns total pages restored across
        survivors (0 when the dead replica never published)."""
        p = self.path(dead)
        if not os.path.exists(p):
            return 0
        total = 0
        for eng in survivors:
            try:
                total += int(eng.restore_kv_store(p))
            except Exception:
                self.errors += 1
                self.telemetry.registry.counter("kvstore_errors").inc()
        self._event("kvstore.recover", dead, total)
        return total

    def restore_self(self, replica: int, engine: Any) -> int:
        """Rejoin path: load a replica's own published file back into it
        (a rejoining replica is typically a fresh, cold engine)."""
        p = self.path(replica)
        if not os.path.exists(p):
            return 0
        try:
            n = int(engine.restore_kv_store(p))
        except Exception:
            self.errors += 1
            self.telemetry.registry.counter("kvstore_errors").inc()
            return 0
        self._event("kvstore.restore_self", replica, n)
        return n

    def __repr__(self):
        return (f"SharedKVStore({self.root!r}, "
                f"published={dict(self.published_pages)})")
