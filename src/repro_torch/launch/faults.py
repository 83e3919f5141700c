"""Deterministic fault injection for the replica serve tier: the port's
copy of the JAX package's framework-free ``launch/faults.py``.

Failover code that is only exercised by real outages is untested code.
This module turns every failure mode the router must survive into a
reproducible fixture: a :class:`FaultyReplica` wraps any replica-shaped
object (``generate(prompts) -> outputs``) and executes a scripted
*fault plan* — raise on the Nth dispatch, stall past a deadline, fail
transiently then recover — with zero randomness, so a test or benchmark
that seeds its workload gets the exact same crash at the exact same
dispatch every run.

Fault kinds
-----------
* ``raise``     permanent: every dispatch from ``at_dispatch`` on raises
                :class:`FaultInjected` until :meth:`FaultyReplica.heal`
                (models a crashed process — it stays down).
* ``transient`` dispatches ``[at_dispatch, at_dispatch + count)`` raise,
                later ones succeed (models a blip: OOM-retry, dropped
                connection, preempted node coming back).
* ``hang``      dispatches in the same window *succeed* but only after
                sleeping ``hang_s`` seconds — paired with the router's
                ``dispatch_timeout`` this is a deterministic stand-in
                for a stalled replica (the result arrives too late and
                is discarded; no threads, no races).

Everything else (``last_stats``, ``save_kv_store``, ...) passes through
to the wrapped replica untouched, so a ``FaultyReplica`` drops into any
router seat a real engine occupies.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence

__all__ = ["Fault", "FaultInjected", "FaultyReplica", "parse_fault_plan"]

_KINDS = ("raise", "transient", "hang")


class FaultInjected(RuntimeError):
    """The error a scripted fault raises — distinguishable from real bugs,
    and naming the dispatch it fired on so traces are self-explaining."""

    def __init__(self, kind: str, dispatch: int):
        self.kind = kind
        self.dispatch = dispatch
        super().__init__(f"injected {kind} fault on dispatch {dispatch}")


@dataclass(frozen=True)
class Fault:
    """One scripted failure.

    ``at_dispatch`` counts the wrapper's ``generate`` calls from 0; the
    fault window is ``[at_dispatch, at_dispatch + count)`` for transient
    and hang faults, and ``[at_dispatch, heal)`` for permanent raises.
    """

    kind: str
    at_dispatch: int
    count: int = 1
    hang_s: float = 0.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {_KINDS})")
        if self.at_dispatch < 0 or self.count < 1:
            raise ValueError("fault needs at_dispatch >= 0 and count >= 1")

    def fires_at(self, dispatch: int) -> bool:
        if self.kind == "raise":
            return dispatch >= self.at_dispatch
        return self.at_dispatch <= dispatch < self.at_dispatch + self.count


class FaultyReplica:
    """Wrap a replica with a fault plan; duck-types as the replica itself."""

    def __init__(self, inner: Any, faults: Sequence[Fault] = (),
                 name: str = ""):
        self.inner = inner
        self.faults = list(faults)
        self.name = name
        self.dispatches = 0    # generate() calls seen (fired or not)
        self.injected = 0      # faults actually raised
        self.hung = 0          # hang windows actually slept
        self.healed = False

    def heal(self) -> None:
        """Clear permanent faults — the replica 'process' came back."""
        self.healed = True

    def generate(self, prompts, *args, **kwargs):
        n = self.dispatches
        self.dispatches += 1
        if not self.healed:
            for f in self.faults:
                if not f.fires_at(n):
                    continue
                if f.kind == "hang":
                    self.hung += 1
                    time.sleep(f.hang_s)
                    break  # slow but successful — fall through to inner
                self.injected += 1
                raise FaultInjected(f.kind, n)
        return self.inner.generate(prompts, *args, **kwargs)

    def __getattr__(self, attr):  # last_stats, save_kv_store, engine, ...
        return getattr(self.inner, attr)

    def __repr__(self):
        tag = self.name or type(self.inner).__name__
        return (f"FaultyReplica({tag}, faults={len(self.faults)}, "
                f"dispatches={self.dispatches}, injected={self.injected})")


def parse_fault_plan(spec: str) -> Dict[int, List[Fault]]:
    """Parse a CLI fault plan into per-replica fault lists.

    Grammar: ``;``-separated items, each ``R:KIND@N[xC][~S]`` — replica
    ``R`` gets a ``KIND`` fault at dispatch ``N``, repeated for ``C``
    consecutive dispatches (default 1), hanging ``S`` seconds when
    ``KIND`` is ``hang``.  Examples::

        1:raise@2                 replica 1 dies permanently on dispatch 2
        0:transient@1x2           replica 0 blips on dispatches 1 and 2
        2:hang@0~0.2;1:raise@3    two replicas, two fault modes
    """
    plan: Dict[int, List[Fault]] = {}
    for item in filter(None, (s.strip() for s in spec.split(";"))):
        try:
            rep, rest = item.split(":", 1)
            kind, rest = rest.split("@", 1)
            hang_s = 0.0
            if "~" in rest:
                rest, secs = rest.split("~", 1)
                hang_s = float(secs)
            count = 1
            if "x" in rest:
                rest, cnt = rest.split("x", 1)
                count = int(cnt)
            fault = Fault(kind=kind.strip(), at_dispatch=int(rest),
                          count=count, hang_s=hang_s)
        except (ValueError, IndexError) as e:
            raise ValueError(
                f"bad fault-plan item {item!r} (expected R:KIND@N[xC][~S], "
                f"e.g. '1:raise@2' or '0:hang@0~0.2'): {e}") from e
        plan.setdefault(int(rep), []).append(fault)
    return plan
