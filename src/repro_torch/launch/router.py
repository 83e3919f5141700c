"""Session-affine replica router: the front door of the sharded serve tier
(the port's copy of the JAX package's framework-free ``launch/router.py``).

One ``PagedServeEngine`` replica owns one mesh (its slice of the devices)
and one radix tree.  Prefix reuse therefore only pays off if requests that
*share* a prefix land on the *same* replica — round-robin over replicas
shreds a 97% radix hit rate into near-zero because each replica sees every
Nth request of a session.  The router restores locality:

* **affine** (default): each request hashes — by explicit session id when
  given, else by its leading ``prefix_tokens`` prompt tokens — to a home
  replica via rendezvous (highest-random-weight) hashing over the *live*
  replica set (``crc32``: deterministic across processes, unlike Python's
  seeded ``hash``).  Same session/system-prompt => same replica => radix
  hit; and when a replica dies, *only its keys move* — survivors keep
  their radix locality, which mod-hashing would reshuffle wholesale.
* **spill**: affinity yields when the home replica is overloaded — if its
  queue is ``spill_margin`` deeper than the least-loaded replica's, the
  request goes to the latter instead (prefix miss traded for latency).
* **rr**: plain round-robin over live replicas, kept as the measured
  locality baseline.

Replicas are anything with ``generate(prompts) -> List[List[int]]``
(engines, or the serve CLI's proxies of multi-rank replicas,
``launch/serve.py``).

Failover (default on)
---------------------
Each replica carries a health state driven purely by dispatch outcome::

    healthy ──fault──▶ suspect ──retries exhausted──▶ dead
       ▲                  │                             │
       └────success───────┘                             └──rejoin()──▶ healthy

A faulting dispatch (raise, short output, or wall-clock past
``dispatch_timeout`` — the late result is discarded) is retried up to
``max_retries`` times with capped exponential backoff, so transient
faults never trigger re-homing.  When retries exhaust, the replica is
dead: its completed outputs from earlier dispatches are kept, its
in-flight batch re-homes onto survivors (rendezvous hashing moves only
the dead replica's hash range), and — given a shared ``kv_store``
(:class:`launch.kvstore.SharedKVStore`) — the dead replica's published
prefix cache restores into the survivors first, so re-homed requests
resume with ``prefix_hit_tokens > 0`` instead of a cold prefill.  The
router degrades to any number >= 1 of live replicas with a one-shot
warning and full accounting in ``last_stats["failover"]``; only when the
*last* replica dies does :class:`ReplicaFailed` escape.  ``rejoin(r)``
re-admits a recovered replica (its keys move back, and its own published
cache restores into it).  ``failover=False`` restores the legacy
contract: first replica fault raises :class:`ReplicaFailed` immediately.

Either way the router never silently drops work: a request that ends the
call without an output raises :class:`IncompleteGeneration` naming the
missing indices — an empty list is a *generation*, not an error code.

Requests may be raw token sequences OR QoS-carrying
``runtime.decode_loop.Request`` objects (duck-typed on ``.tokens`` — the
router stays framework-free): routing hashes the token stream (or the
request's own ``.session``), and the object itself passes through to the
replica untouched — across re-homing too — so priorities, arrivals and
deadlines survive the routing tier and land in a replica's
``SLOPagedServeEngine`` intact.
"""
from __future__ import annotations

import time
import warnings
import zlib
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.runtime import telemetry as TM

__all__ = ["AllReplicasDead", "IncompleteGeneration", "ReplicaFailed",
           "ReplicaRouter"]

# per-replica dispatch stats the router aggregates across dispatches
_ENGINE_STAT_KEYS = ("prompt_tokens", "prefix_hit_tokens",
                     "prefilled_tokens", "dispatches")


def _tokens(prompt: Any) -> Sequence[int]:
    """The token stream of a request: ``Request``-likes carry it in
    ``.tokens``; anything else IS the stream."""
    return prompt.tokens if hasattr(prompt, "tokens") else prompt


def _rendezvous_score(key_crc: int, r: int) -> int:
    """Per-(key, replica) rendezvous weight.  crc32 alone is unusable
    here: it is GF(2)-linear, so ``crc32(key + suffix_r)`` differs across
    replicas by a key-independent XOR and whole key populations collapse
    onto one replica.  A multiplicative mix (the standard 32-bit hash
    finalizer) breaks the linearity while staying deterministic across
    processes — no seeded ``hash()``."""
    x = (key_crc ^ (0x9E3779B9 * (r + 1))) & 0xFFFFFFFF
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & 0xFFFFFFFF
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & 0xFFFFFFFF
    return x ^ (x >> 16)


class ReplicaFailed(RuntimeError):
    """A replica raised while serving its share of a workload."""

    def __init__(self, replica: int, cause: BaseException):
        self.replica = replica
        self.cause = cause
        super().__init__(f"replica {replica} failed: {cause!r}")


class AllReplicasDead(ReplicaFailed):
    """Every replica is dead — failover has nowhere left to re-home."""

    def __init__(self, replica: int, cause: BaseException):
        super().__init__(replica, cause)
        self.args = (f"all replicas dead (last: replica {replica}: "
                     f"{cause!r})",)


class IncompleteGeneration(RuntimeError):
    """Requests finished the routing pass without an output.

    The legacy behaviour returned ``[]`` for them — indistinguishable
    from a genuine empty generation, i.e. silent data loss.  Now the
    missing request indices are named and the caller decides."""

    def __init__(self, missing: Sequence[int], total: int):
        self.missing = list(missing)
        self.total = total
        super().__init__(
            f"{len(self.missing)}/{total} requests have no output "
            f"(indices {self.missing[:8]}{'...' if len(self.missing) > 8 else ''})")


class _DispatchTimeout(RuntimeError):
    """Internal: a dispatch completed after ``dispatch_timeout`` —
    treated as a fault, its (late) result discarded."""

    def __init__(self, elapsed: float, timeout: float):
        super().__init__(f"dispatch took {elapsed:.3f}s > "
                         f"timeout {timeout:.3f}s; result discarded")


class _ShortOutput(RuntimeError):
    """Internal: a replica returned fewer/more outputs than requests —
    a broken replica, handled like any other dispatch fault."""

    def __init__(self, got: int, want: int):
        super().__init__(f"replica returned {got} outputs for {want} "
                         f"requests")


class ReplicaRouter:
    """Dispatch prompts across engine replicas, session-affine by default.

    Host-side and framework-free (plain ints and lists): routing must cost
    nothing next to a segment dispatch and must not trace/compile anything.
    """

    HEALTHY, SUSPECT, DEAD = "healthy", "suspect", "dead"

    def __init__(self, replicas: Sequence[Any], *, policy: str = "affine",
                 prefix_tokens: int = 16, spill_margin: int = 0,
                 failover: bool = True, max_retries: int = 1,
                 backoff_s: float = 0.0, max_backoff_s: float = 0.1,
                 dispatch_timeout: Optional[float] = None,
                 kv_store: Optional[Any] = None, warn=None):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        if policy not in ("affine", "rr"):
            raise ValueError(f"unknown router policy {policy!r} "
                             f"(expected 'affine' or 'rr')")
        self.replicas = list(replicas)
        self.policy = policy
        self.prefix_tokens = int(prefix_tokens)
        # 0 disables spilling (strict affinity); margin m spills a request
        # whose home queue is >= m deeper than the shallowest queue
        self.spill_margin = int(spill_margin)
        self.failover = bool(failover)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.dispatch_timeout = dispatch_timeout
        self.kv_store = kv_store
        self._warn = warn if warn is not None else (
            lambda msg: warnings.warn(msg, RuntimeWarning, stacklevel=3))
        self._warned_degraded = False
        self._rr_next = 0
        self.depth = [0] * len(self.replicas)  # queued prompts per replica
        self.health = [self.HEALTHY] * len(self.replicas)
        self.last_cause: List[Optional[BaseException]] = \
            [None] * len(self.replicas)
        # the router's own telemetry (stdlib-only — stays framework-free);
        # its step clock is the dispatch sequence number
        self.telemetry = TM.Telemetry(component="router")
        self.last_stats: Dict[str, Any] = self.telemetry.stats_view()
        self._dispatch_seq = 0
        # lifetime counters, cumulative across generate() calls (deaths
        # survive a workload); mirrored as registry counters
        # router_deaths/router_retries/router_timeouts.  Per-call deltas
        # live in last_stats["failover"]
        self.deaths = 0
        self.retries = 0
        self.timeouts = 0

    # -- health ----------------------------------------------------------
    def live(self) -> List[int]:
        return [r for r in range(len(self.replicas))
                if self.health[r] != self.DEAD]

    def rejoin(self, r: int) -> int:
        """Re-admit a recovered replica: healthy again, its rendezvous
        keys route back to it, and (with a shared store) its own
        published prefix cache restores into it so it rejoins warm.
        Returns pages restored (0 without a store)."""
        self.health[r] = self.HEALTHY
        self.last_cause[r] = None
        restored = 0
        if self.kv_store is not None:
            restored = self.kv_store.restore_self(r, self.replicas[r])
        self.telemetry.event("router.rejoin", replica=r,
                             step=self._dispatch_seq, pages=restored)
        return restored

    # -- placement -------------------------------------------------------
    def _key(self, prompt: Sequence[int], session: Optional[str]) -> bytes:
        if session is None:  # QoS Request objects carry their own session
            session = getattr(prompt, "session", None)
        if session is not None:
            return session.encode()
        head = list(_tokens(prompt))[: self.prefix_tokens]
        return b",".join(str(int(t)).encode() for t in head)

    def home_of(self, prompt: Sequence[int],
                session: Optional[str] = None) -> int:
        """The affinity home: rendezvous hash of the session id (or the
        prompt's leading ``prefix_tokens`` tokens) over the live replica
        set — requests sharing a system prompt share a home even without
        session bookkeeping, and a dead replica moves *only its own*
        keys (every live replica keeps its rank for every other key)."""
        kc = zlib.crc32(self._key(prompt, session))
        live = self.live()
        if not live:
            raise AllReplicasDead(
                0, RuntimeError("no live replicas to route to"))
        return max(live, key=lambda r: _rendezvous_score(kc, r))

    def route(self, prompt: Sequence[int],
              session: Optional[str] = None) -> int:
        """Pick a live replica for one request and account for its queue
        slot."""
        live = self.live()
        if not live:
            raise AllReplicasDead(
                0, RuntimeError("no live replicas to route to"))
        if self.policy == "rr":
            r = live[self._rr_next % len(live)]
            self._rr_next += 1
            self.depth[r] += 1
            return r
        home = self.home_of(prompt, session)
        r = home
        if self.spill_margin > 0:
            least = min(live, key=self.depth.__getitem__)
            if self.depth[home] - self.depth[least] >= self.spill_margin:
                r = least
        self.depth[r] += 1
        return r

    # -- dispatch --------------------------------------------------------
    def _dispatch_once(self, r: int, batch: List[Any]) -> List[Any]:
        """One guarded dispatch: raises on replica exception, on a
        short/long output list, and on wall-clock past the timeout (the
        late result is discarded — its replica may be wedged)."""
        self._dispatch_seq += 1
        seq = self._dispatch_seq
        t0 = time.perf_counter()
        got = self.replicas[r].generate(batch)
        elapsed = time.perf_counter() - t0
        self.telemetry.event("router.dispatch", replica=r, step=seq,
                             n=len(batch), dur_ms=elapsed * 1e3)
        if (self.dispatch_timeout is not None
                and elapsed > self.dispatch_timeout):
            self.timeouts += 1
            self.telemetry.registry.counter("router_timeouts").inc()
            self.telemetry.event("router.timeout", replica=r, step=seq)
            raise _DispatchTimeout(elapsed, self.dispatch_timeout)
        if got is None or len(got) != len(batch):
            raise _ShortOutput(0 if got is None else len(got), len(batch))
        return got

    def _dispatch_with_retry(self, r: int,
                             batch: List[Any]) -> Optional[List[Any]]:
        """Dispatch with the health state machine: fault => suspect +
        bounded retry (capped exponential backoff); success => healthy;
        retries exhausted => dead, returns None (caller re-homes)."""
        delay = self.backoff_s
        for attempt in range(self.max_retries + 1):
            try:
                got = self._dispatch_once(r, batch)
            except Exception as e:
                self.last_cause[r] = e
                self.health[r] = self.SUSPECT
                if attempt < self.max_retries:
                    self.retries += 1
                    self.telemetry.registry.counter("router_retries").inc()
                    self.telemetry.event("router.retry", replica=r,
                                         step=self._dispatch_seq,
                                         attempt=attempt + 1)
                    if delay > 0:
                        time.sleep(min(delay, self.max_backoff_s))
                        delay = min(delay * 2 or self.max_backoff_s,
                                    self.max_backoff_s)
                    continue
                self.health[r] = self.DEAD
                self.deaths += 1
                self.telemetry.registry.counter("router_deaths").inc()
                self.telemetry.event("router.death", replica=r,
                                     step=self._dispatch_seq)
                return None
            self.health[r] = self.HEALTHY
            return got
        return None  # unreachable

    def _accumulate_engine_stats(self, r: int,
                                 per_replica: Dict[str, Any]) -> int:
        """Fold the replica's last-dispatch stats into its per-replica
        row (a replica may be dispatched several times per workload once
        re-homed batches land on it).  Returns the dispatch's
        ``prefix_hit_tokens`` so re-home dispatches can attribute
        recovery."""
        eng = getattr(self.replicas[r], "last_stats", None) or {}
        for k in _ENGINE_STAT_KEYS:
            if k in eng:
                per_replica[k] = per_replica.get(k, 0) + eng[k]
        return int(eng.get("prefix_hit_tokens", 0))

    def _on_death(self, r: int) -> int:
        """Permanent death bookkeeping: publish the dead replica's prefix
        cache (the engine is crash-consistent after a raised generate)
        and restore it into the survivors, so re-homed requests promote
        their context instead of recomputing it.  Returns pages restored
        into survivors (0 without a shared store)."""
        if not self._warned_degraded:
            self._warned_degraded = True
            self._warn(
                f"replica {r} died ({self.last_cause[r]!r}); degrading to "
                f"{len(self.live())} live replica(s) and re-homing its "
                f"sessions (further deaths logged in last_stats only)")
        if self.kv_store is None:
            return 0
        self.kv_store.publish(r, self.replicas[r])
        pages = self.kv_store.recover(
            r, [self.replicas[s] for s in self.live()])
        self.telemetry.event("router.recover", replica=r,
                             step=self._dispatch_seq, pages=pages,
                             survivors=len(self.live()))
        return pages

    def generate(self, prompts: Sequence[Sequence[int]],
                 sessions: Optional[Sequence[Optional[str]]] = None,
                 ) -> List[List[int]]:
        """Route every prompt, run each replica over its share, and merge
        the outputs back into request order.

        With ``failover`` (default): replica deaths re-home work onto
        survivors; raises :class:`AllReplicasDead` only when no replica
        is left, and :class:`IncompleteGeneration` if any request would
        otherwise silently miss an output.  With ``failover=False``:
        legacy contract, first fault raises :class:`ReplicaFailed`."""
        if sessions is not None and len(sessions) != len(prompts):
            raise ValueError("sessions must align 1:1 with prompts")
        if sessions is None:
            # QoS Request objects may carry their own session affinity
            sessions = [getattr(p, "session", None) for p in prompts]
        t0 = time.perf_counter()
        R = len(self.replicas)
        assigned: List[List[int]] = [[] for _ in range(R)]  # request idx
        spilled = 0
        for i, p in enumerate(prompts):
            r = self.route(p, sessions[i])
            if self.policy == "affine" and r != self.home_of(p, sessions[i]):
                spilled += 1
            assigned[r].append(i)

        outs: List[Optional[List[int]]] = [None] * len(prompts)
        per_replica: List[Dict[str, Any]] = [
            {"replica": r, "requests": len(assigned[r])} for r in range(R)]

        if not self.failover:
            self._generate_legacy(prompts, assigned, outs, per_replica)
        else:
            self._generate_failover(prompts, sessions, assigned, outs,
                                    per_replica, t0)

        missing = [i for i, o in enumerate(outs) if o is None]
        if missing:
            raise IncompleteGeneration(missing, len(prompts))
        self.last_stats.update({
            "policy": self.policy, "replicas": R,
            "requests": len(prompts), "spilled": spilled,
            "per_replica": per_replica, "s": time.perf_counter() - t0,
        })
        return list(outs)

    # the pre-failover dispatch loop, kept verbatim behind failover=False:
    # one dispatch per replica, first fault aborts the workload
    def _generate_legacy(self, prompts, assigned, outs, per_replica) -> None:
        for r, idxs in enumerate(assigned):
            if not idxs:
                continue
            try:
                got = self.replicas[r].generate([prompts[i] for i in idxs])
            except Exception as e:
                # every assignment was accounted in route(); replicas
                # after r never reach their own decrement, so drain the
                # whole undispatched tail here — a failed workload must
                # not leave phantom depth that skews future spills
                for r2 in range(r, len(assigned)):
                    self.depth[r2] -= len(assigned[r2])
                self.last_cause[r] = e
                raise ReplicaFailed(r, e) from e
            self.depth[r] -= len(idxs)
            if len(got) != len(idxs):
                raise ReplicaFailed(r, _ShortOutput(len(got), len(idxs)))
            for i, o in zip(idxs, got):
                outs[i] = o
            self._accumulate_engine_stats(r, per_replica[r])
        self.last_stats = self.telemetry.stats_view()

    def _generate_failover(self, prompts, sessions, assigned, outs,
                           per_replica, t0) -> None:
        R = len(self.replicas)
        deaths0, retries0, timeouts0 = self.deaths, self.retries, self.timeouts
        rehomed_idx: List[int] = []
        rehomed_sessions = set()
        recovered_prefix = 0
        recovered_pages = 0
        # original shares and re-homed work are kept in separate queues:
        # a re-homed batch dispatches on its own, so its prefix hits are
        # attributable to recovery, not to the survivor's original share
        queues: List[List[int]] = [list(idxs) for idxs in assigned]
        requeues: List[List[int]] = [[] for _ in range(R)]

        def rehome(idxs: List[int], dead: int) -> None:
            self.depth[dead] -= len(idxs)  # route() re-accounts below
            for i in idxs:
                r2 = self.route(prompts[i], sessions[i])
                requeues[r2].append(i)
                rehomed_idx.append(i)
                self.telemetry.event("router.rehome", request=i,
                                     session=sessions[i], replica=r2,
                                     step=self._dispatch_seq, dead=dead)
                if sessions[i] is not None:
                    rehomed_sessions.add(sessions[i])

        def drain_all_depth(dying_batch: List[int], r: int) -> None:
            # failover has nowhere left to go: drop every queued slot so
            # phantom depth doesn't skew a future workload's spills
            self.depth[r] -= len(dying_batch)
            for r2 in range(R):
                self.depth[r2] -= len(queues[r2]) + len(requeues[r2])
                queues[r2], requeues[r2] = [], []

        while True:
            # work queued on a replica that died serving a *different*
            # batch would otherwise be orphaned — re-home it first
            for r in range(R):
                if self.health[r] == self.DEAD and (queues[r] or requeues[r]):
                    idxs = queues[r] + requeues[r]
                    queues[r], requeues[r] = [], []
                    rehome(idxs, r)
            work = [(r, False) for r in self.live() if queues[r]] + \
                   [(r, True) for r in self.live() if requeues[r]]
            if not work:
                break
            for r, is_rehome in work:
                src = requeues[r] if is_rehome else queues[r]
                if not src or self.health[r] == self.DEAD:
                    continue  # died earlier in this pass; next pass re-homes
                idxs, src[:] = list(src), []
                got = self._dispatch_with_retry(
                    r, [prompts[i] for i in idxs])
                if got is None:  # permanent death
                    recovered_pages += self._on_death(r)
                    if not self.live():
                        drain_all_depth(idxs, r)
                        raise AllReplicasDead(r, self.last_cause[r]) \
                            from self.last_cause[r]
                    rehome(idxs, r)
                    continue
                self.depth[r] -= len(idxs)
                for i, o in zip(idxs, got):
                    outs[i] = o
                hit = self._accumulate_engine_stats(r, per_replica[r])
                if is_rehome:
                    recovered_prefix += hit
                if self.kv_store is not None:
                    self.kv_store.publish(r, self.replicas[r])

        # per-call deltas (counters reset to this workload's contribution)
        # PLUS an explicit lifetime view: the registry's
        # router_deaths/retries/timeouts counters accumulate forever,
        # the failover_* gauges hold the last call's deltas
        fo = {
            "deaths": self.deaths - deaths0,
            "dead": [r for r in range(R) if self.health[r] == self.DEAD],
            "retries": self.retries - retries0,
            "timeouts": self.timeouts - timeouts0,
            "rehomed_requests": len(rehomed_idx),
            "rehomed_sessions": len(rehomed_sessions),
            "recovered_prefix_tokens": recovered_prefix,
            "recovered_pages": recovered_pages,
            "health": list(self.health),
            "live": len(self.live()),
            "lifetime": {"deaths": self.deaths, "retries": self.retries,
                         "timeouts": self.timeouts},
        }
        for k in ("deaths", "retries", "timeouts", "rehomed_requests",
                  "rehomed_sessions", "recovered_prefix_tokens",
                  "recovered_pages"):
            self.telemetry.registry.gauge(f"failover_{k}").set(fo[k])
        self.last_stats = self.telemetry.stats_view()
        self.last_stats["failover"] = fo
