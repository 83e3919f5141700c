"""Unified telemetry: metrics registry + lifecycle tracer + exporters.

The port's own copy of the JAX package's stdlib-only
``runtime/telemetry.py`` (the port imports nothing of that package): the
same classes, exporters and output, byte for byte
(``tests/test_torch_telemetry.py``), and the same default Prometheus
prefix ``repro_``, so one dashboard reads both trainers.  The port's
train loop records ``train_step_ms``, ``train_steps``, ``train_loss`` and
one ``train.step`` span a step (``runtime/train_loop.py``); the train CLI
writes them with ``--trace-out`` / ``--metrics-out``.

One substrate replaces the five independently invented ``stats`` /
``last_stats`` dicts that used to live in ``runtime/decode_loop.py``,
``runtime/paged.py``, ``launch/router.py`` and ``launch/faults.py``:

* :class:`MetricsRegistry` — named counters, gauges and histograms.
  Histograms keep **exact** running aggregates (count / sum / min / max)
  plus a *bounded reservoir* for percentiles, so per-step records no
  longer grow without bound (the old ``stats["steps"]`` lists appended
  one dict per dispatch forever).
* :class:`Tracer` — structured lifecycle events keyed on
  ``(request, session, replica)`` with **dual timestamps**: wall-clock
  ``perf_counter`` for humans/Perfetto AND the deterministic
  dispatch-step clock, so the same seed + the same ``--fault-plan``
  reproduce the identical event sequence under test
  (:meth:`Tracer.deterministic_view` excludes the wall-clock fields).
* :class:`StatsView` — a ``MutableMapping`` facade that keeps the
  existing ``engine.last_stats[...]`` contract intact while storing
  every scalar in the registry, so BENCH numbers derive from the
  registry instead of parallel hand-rolled accounting.
* Exporters — Chrome trace-event JSON (load in Perfetto / chrome://
  tracing; one track per slot, one process per component/replica),
  Prometheus text exposition, and per-request summaries (TTFT, ITL
  p50/p95, queue wait, preemptions, prefix-hit tokens).

Reservoir policy
----------------
Histograms window the most recent ``reservoir`` observations (default
4096) in a ring buffer: percentiles are exact over that sliding window,
while ``count`` / ``total`` / ``min`` / ``max`` stay exact over the full
stream.  The same policy bounds :class:`StepRing` (the ``stats["steps"]``
replacement) and the :class:`Tracer` event buffer — old entries drop
FIFO and a ``dropped`` counter records how many.  Workload-scale runs in
this repo sit far below the caps, so views are bit-identical to the old
unbounded lists; only forever-running servers see the window.

Deliberately stdlib-only: the router layer is framework-free and the
tracer must cost nothing next to a segment dispatch.

Span taxonomy (``kind`` values emitted by the instrumented stack)::

    engine.dispatch                 one fused mixed-step dispatch (dur)
    request.queued/admit/emit/complete  per-request lifecycle
    request.preempt/resume/pause/pause_resume  SLO scheduler actions
    pool.cow/promote/demote/evict/defer        paged-pool actions
    kvstore.save/restore/publish/recover       persistence tier
    router.dispatch/retry/timeout/death/rehome/rejoin/recover
    compile.<program>, alert.programs          program-cache growth
    train.step                                 one optimizer step (dur)
"""
from __future__ import annotations

import collections
import json
import numbers
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "StatsView",
    "StepRing", "Tracer", "Telemetry", "timed_dispatch",
    "chrome_trace", "write_chrome_trace",
    "prometheus_text", "write_prometheus", "request_summaries",
]

DEFAULT_RESERVOIR = 4096
DEFAULT_STEPS_CAP = 4096
DEFAULT_EVENTS_CAP = 65536


def _is_scalar(v: Any) -> bool:
    # bools are ints in python; keep them out of the numeric registry so
    # flags like ``radix``/``offload`` stay local dict values
    return isinstance(v, numbers.Number) and not isinstance(v, bool)


def percentile(sorted_vals: List[float], p: float) -> float:
    """Nearest-rank percentile over an ascending list (0 for empty)."""
    if not sorted_vals:
        return 0.0
    k = min(len(sorted_vals) - 1,
            max(0, int(round(p / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------
class Counter:
    """Monotone event count."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> int:
        self.value += n
        return self.value


class Gauge:
    """Last-written value (keeps the writer's numeric type)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def set(self, v: Any) -> None:
        self.value = v

    def add(self, v: Any) -> None:
        self.value += v


class Histogram:
    """Exact aggregates over the full stream + a bounded reservoir
    (sliding window of the most recent ``reservoir`` samples) for
    percentiles — see the module docstring for the policy."""

    def __init__(self, reservoir: int = DEFAULT_RESERVOIR) -> None:
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        self.window: collections.deque = collections.deque(maxlen=reservoir)

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        self.window.append(v)

    @property
    def dropped(self) -> int:
        return self.count - len(self.window)

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        return percentile(sorted(self.window), p)

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "total": self.total,
                "mean": self.mean(), "min": self.vmin or 0.0,
                "max": self.vmax or 0.0, "p50": self.percentile(50),
                "p95": self.percentile(95), "dropped": self.dropped}


class MetricsRegistry:
    """Name -> metric.  ``counter``/``gauge``/``histogram`` create on
    first use; re-requesting a name returns the same instance."""

    def __init__(self) -> None:
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def histogram(self, name: str,
                  reservoir: int = DEFAULT_RESERVOIR) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(reservoir)
        return h

    def value(self, name: str, default: Any = 0) -> Any:
        if name in self.counters:
            return self.counters[name].value
        if name in self.gauges:
            return self.gauges[name].value
        return default

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        out.update({k: c.value for k, c in self.counters.items()})
        out.update({k: g.value for k, g in self.gauges.items()})
        out.update({k: h.summary() for k, h in self.histograms.items()})
        return out


class StatsView(collections.abc.MutableMapping):
    """The ``last_stats`` facade: reads/writes look like a plain dict, but
    every scalar lives in the registry (as a gauge named ``prefix+key``),
    so existing consumers keep working unchanged while BENCH/exporters
    read the registry as the single source of truth.  Non-scalar values
    (lists like ``requests``, strings like ``policy``, bools) stay
    local."""

    def __init__(self, registry: MetricsRegistry, prefix: str = "",
                 init: Optional[Dict[str, Any]] = None) -> None:
        self._reg = registry
        self._prefix = prefix
        self._local: Dict[str, Any] = {}
        self._scalar: Dict[str, Gauge] = {}
        self._order: List[str] = []
        for k, v in (init or {}).items():
            self[k] = v

    def registry(self) -> MetricsRegistry:
        return self._reg

    def __setitem__(self, k: str, v: Any) -> None:
        if _is_scalar(v):
            g = self._scalar.get(k)
            if g is None:
                g = self._scalar[k] = self._reg.gauge(self._prefix + k)
            g.set(v)
            self._local.pop(k, None)
        else:
            self._local[k] = v
            self._scalar.pop(k, None)
        if k not in self._order:
            self._order.append(k)

    def __getitem__(self, k: str) -> Any:
        g = self._scalar.get(k)
        if g is not None:
            return g.value
        if k in self._local:
            return self._local[k]
        raise KeyError(k)

    def __delitem__(self, k: str) -> None:
        self._scalar.pop(k, None)
        self._local.pop(k, None)
        self._order.remove(k)

    def __iter__(self):
        return iter(self._order)

    def __len__(self) -> int:
        return len(self._order)

    def __repr__(self) -> str:
        return f"StatsView({dict(self)!r})"


class StepRing:
    """Bounded list-like replacement for the old ``stats["steps"]``:
    keeps the most recent ``cap`` per-dispatch records (FIFO drop beyond
    that, counted in ``dropped``) while supporting the list operations
    existing consumers use — iteration, ``len``, indexing and slicing."""

    def __init__(self, cap: int = DEFAULT_STEPS_CAP) -> None:
        self._q: collections.deque = collections.deque(maxlen=cap)
        self.dropped = 0

    def append(self, rec: Dict[str, Any]) -> None:
        if len(self._q) == self._q.maxlen:
            self.dropped += 1
        self._q.append(rec)

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self):
        return iter(self._q)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(self._q)[i]
        return self._q[i]

    def __bool__(self) -> bool:
        return bool(self._q)

    def __repr__(self) -> str:
        return f"StepRing({list(self._q)!r}, dropped={self.dropped})"


# --------------------------------------------------------------------------
# tracing
# --------------------------------------------------------------------------
class Tracer:
    """Bounded buffer of lifecycle events.

    Every event carries the dual clock: ``wall`` (``perf_counter`` at
    record time, plus ``dur_ms`` for spans) and ``step`` (the engine /
    router dispatch-step counter the caller passes in).  Wall fields are
    for humans and Perfetto; the step clock plus the identity key
    ``(request, session, replica)`` and the free-form ``args`` form the
    deterministic view golden tests compare."""

    def __init__(self, max_events: int = DEFAULT_EVENTS_CAP) -> None:
        self.events: collections.deque = collections.deque(maxlen=max_events)
        self.dropped = 0

    def event(self, kind: str, *, step: Optional[int] = None,
              request: Optional[Any] = None, session: Optional[str] = None,
              replica: Optional[int] = None, slot: Optional[int] = None,
              dur_ms: Optional[float] = None, **args: Any) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped += 1
        self.events.append({
            "kind": kind, "wall": time.perf_counter(), "dur_ms": dur_ms,
            "step": step, "request": request, "session": session,
            "replica": replica, "slot": slot, "args": args,
        })

    def deterministic_view(self) -> List[Tuple]:
        """The reproducible projection: everything except wall-clock
        (``wall`` and ``dur_ms``) and except wall-derived args (any arg
        key ending in ``_ms`` or ``_s``)."""
        out = []
        for e in self.events:
            args = tuple(sorted((k, v) for k, v in e["args"].items()
                                if not (k.endswith("_ms") or k.endswith("_s"))))
            out.append((e["kind"], e["step"], e["request"], e["session"],
                        e["replica"], e["slot"], args))
        return out

    def kinds(self) -> List[str]:
        return [e["kind"] for e in self.events]


class Telemetry:
    """Per-component facade bundling one registry + one tracer.

    ``component`` labels the Chrome-trace process; ``replica`` (when the
    component is one of several engine replicas) labels its track group.
    ``set_tracing(False)`` stops event recording (the registry still
    counts) — the knob ``benchmarks/serve_bench.py::run_obs`` measures.
    """

    def __init__(self, component: str = "engine",
                 replica: Optional[int] = None, *,
                 steps_cap: int = DEFAULT_STEPS_CAP,
                 max_events: int = DEFAULT_EVENTS_CAP,
                 program_limit: int = 1) -> None:
        self.component = component
        self.replica = replica
        self.registry = MetricsRegistry()
        self.tracer = Tracer(max_events)
        self.tracing = True
        self.steps_cap = steps_cap
        # bounded-program-set alert threshold: compiles of one program
        # past this surface as ``alert.programs`` events + a counter
        self.program_limit = program_limit

    def set_tracing(self, on: bool) -> "Telemetry":
        self.tracing = bool(on)
        return self

    # -- recording ---------------------------------------------------------
    def event(self, kind: str, **kw: Any) -> None:
        if self.tracing:
            if kw.get("replica") is None and self.replica is not None:
                kw["replica"] = self.replica
            self.tracer.event(kind, **kw)

    def compile_event(self, program: str, **kw: Any) -> None:
        """Called from inside a compiling wrapper whose python function
        only runs while a NEW program is traced or captured, so each
        call == one fresh compilation of ``program``.  Count it, trace
        it, and raise a telemetry alert once the bounded-program-set
        contract (<= ``program_limit`` per program) is violated."""
        n = self.registry.counter(f"compiles_{program}").inc()
        self.event(f"compile.{program}", count=n, **kw)
        if n > self.program_limit:
            self.registry.counter("alerts").inc()
            self.event("alert.programs", program=program, count=n, **kw)

    def stats_view(self, init: Optional[Dict[str, Any]] = None,
                   prefix: str = "") -> StatsView:
        return StatsView(self.registry, prefix, init)

    def steps_ring(self) -> StepRing:
        return StepRing(self.steps_cap)

    # -- derived views -----------------------------------------------------
    def request_summaries(self) -> Dict[Any, Dict[str, Any]]:
        return request_summaries(self.tracer)

    def alerts(self) -> int:
        return self.registry.value("alerts")


class _DispatchProbe:
    """What :func:`timed_dispatch` yields: the caller fills in what only
    it knows (``emitted``, optionally ``prefilling``) before the block
    exits."""

    __slots__ = ("emitted", "prefilling")

    def __init__(self, prefilling: int) -> None:
        self.emitted = 0
        self.prefilling = prefilling


class timed_dispatch:
    """The shared dispatch-timing helper (context manager) that replaces
    the triplicated ``t0 = perf_counter() ... stats["steps"].append(...)``
    snippet in ``ServeEngine.generate``, ``BlockingServeEngine.generate``
    and ``SLOPagedServeEngine.generate``::

        with timed_dispatch(tel, stats, prefilling=n) as td:
            ... dispatch + device_get ...
            td.emitted = int(va.sum())

    On exit it appends the step record ({"ms", "prefilling", "emitted"}
    (+"step" when a scheduler clock is passed), exactly the old shape),
    bumps ``stats["dispatches"]``, feeds the registry's ``dispatch_ms``
    histogram and ``emitted_tokens`` counter, and emits one
    ``engine.dispatch`` span on the step clock (the scheduler's ``step``
    when given, else the dispatch count)."""

    def __init__(self, telemetry: Optional[Telemetry],
                 stats: collections.abc.MutableMapping, *,
                 prefilling: int = 0, step: Optional[int] = None) -> None:
        self.tel = telemetry
        self.stats = stats
        self.step = step
        self.probe = _DispatchProbe(prefilling)

    def __enter__(self) -> _DispatchProbe:
        self.t0 = time.perf_counter()
        return self.probe

    def __exit__(self, etype, e, tb) -> bool:
        if etype is not None:
            return False
        dt_ms = (time.perf_counter() - self.t0) * 1e3
        p = self.probe
        rec = {"ms": dt_ms, "prefilling": p.prefilling, "emitted": p.emitted}
        if self.step is not None:
            rec["step"] = self.step
        self.stats["dispatches"] = self.stats.get("dispatches", 0) + 1
        self.stats["steps"].append(rec)
        if self.tel is not None:
            self.tel.registry.histogram("dispatch_ms").observe(dt_ms)
            self.tel.registry.counter("emitted_tokens").inc(p.emitted)
            self.tel.event("engine.dispatch", dur_ms=dt_ms,
                           step=self.step if self.step is not None
                           else self.stats["dispatches"],
                           prefilling=p.prefilling, emitted=p.emitted)
        return False


# --------------------------------------------------------------------------
# exporters
# --------------------------------------------------------------------------
def _as_telemetries(ts) -> List[Telemetry]:
    return [ts] if isinstance(ts, Telemetry) else list(ts)


def chrome_trace(telemetries) -> Dict[str, Any]:
    """Chrome trace-event JSON (the ``traceEvents`` array format both
    Perfetto and chrome://tracing load).  One *process* per telemetry
    component/replica, one *thread track* per slot (track 0 = events not
    tied to a slot).  Spans (events with ``dur_ms``) become complete
    ``"X"`` events; the rest are instants."""
    evs: List[Dict[str, Any]] = []
    for pid, tel in enumerate(_as_telemetries(telemetries)):
        pname = tel.component if tel.replica is None \
            else f"{tel.component}[{tel.replica}]"
        evs.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                    "args": {"name": pname}})
        tids = set()
        for e in tel.tracer.events:
            tid = 0 if e["slot"] is None else int(e["slot"]) + 1
            tids.add(tid)
            args = {k: v for k, v in (("step", e["step"]),
                                      ("request", e["request"]),
                                      ("session", e["session"]),
                                      ("replica", e["replica"]))
                    if v is not None}
            args.update(e["args"])
            ts_us = e["wall"] * 1e6
            ev = {"name": e["kind"], "pid": pid, "tid": tid,
                  "ts": ts_us, "args": args}
            if e["dur_ms"] is not None:
                ev.update(ph="X", ts=ts_us - e["dur_ms"] * 1e3,
                          dur=e["dur_ms"] * 1e3)
            else:
                ev.update(ph="i", s="t")
            evs.append(ev)
        for tid in sorted(tids):
            evs.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid,
                        "args": {"name": "scheduler" if tid == 0
                                 else f"slot {tid - 1}"}})
    return {"traceEvents": evs, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, telemetries) -> Dict[str, Any]:
    doc = chrome_trace(telemetries)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def _prom_name(prefix: str, name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return prefix + out


def prometheus_text(telemetries, prefix: str = "repro_") -> str:
    """Prometheus text exposition (format 0.0.4).  Histograms export as
    Prometheus summaries (quantile series + ``_sum``/``_count``)."""
    lines: List[str] = []
    for tel in _as_telemetries(telemetries):
        label = f'component="{tel.component}"'
        if tel.replica is not None:
            label += f',replica="{tel.replica}"'
        reg = tel.registry
        for name, c in sorted(reg.counters.items()):
            n = _prom_name(prefix, name)
            lines += [f"# TYPE {n} counter", f"{n}{{{label}}} {c.value}"]
        for name, g in sorted(reg.gauges.items()):
            v = g.value
            if not _is_scalar(v):
                continue
            n = _prom_name(prefix, name)
            lines += [f"# TYPE {n} gauge", f"{n}{{{label}}} {v}"]
        for name, h in sorted(reg.histograms.items()):
            n = _prom_name(prefix, name)
            lines.append(f"# TYPE {n} summary")
            for q in (0.5, 0.95):
                lines.append(f'{n}{{{label},quantile="{q}"}} '
                             f"{h.percentile(q * 100)}")
            lines += [f"{n}_sum{{{label}}} {h.total}",
                      f"{n}_count{{{label}}} {h.count}"]
    return "\n".join(lines) + "\n"


def write_prometheus(path: str, telemetries, prefix: str = "repro_") -> str:
    text = prometheus_text(telemetries, prefix)
    with open(path, "w") as f:
        f.write(text)
    return text


def request_summaries(tracer: Tracer) -> Dict[Any, Dict[str, Any]]:
    """Reconstruct per-request summaries from lifecycle events alone —
    the exporter behind ``--trace-out``'s summary and the cross-check
    that trace spans reproduce the scheduler's own accounting.

    Per request id: ``queued_step`` / ``admit_step`` / ``queue_wait``
    (steps from arrival to first admission), ``first_emit`` /
    ``last_emit`` / ``ttft`` (steps from arrival to first token),
    ``itl_p50`` / ``itl_p95`` / ``max_gap`` (inter-token gaps on the
    step clock), ``n_emitted``, ``preemptions``, ``prefix_hit_tokens``,
    and wall-clock ``ttft_ms`` when wall data is present."""
    out: Dict[Any, Dict[str, Any]] = {}

    def rec(rid) -> Dict[str, Any]:
        r = out.get(rid)
        if r is None:
            r = out[rid] = {
                "request": rid, "session": None, "queued_step": None,
                "admit_step": None, "queue_wait": None, "first_emit": None,
                "last_emit": None, "ttft": None, "ttft_ms": None,
                "itl_p50": 0, "itl_p95": 0, "max_gap": 0, "n_emitted": 0,
                "preemptions": 0, "prefix_hit_tokens": 0,
                "_emit_steps": [], "_queued_wall": None,
            }
        return r

    for e in tracer.events:
        rid = e["request"]
        if rid is None:
            continue
        r = rec(rid)
        if e["session"] is not None:
            r["session"] = e["session"]
        k, step = e["kind"], e["step"]
        if k == "request.queued":
            r["queued_step"] = step
            r["_queued_wall"] = e["wall"]
        elif k in ("request.admit", "request.resume"):
            if r["admit_step"] is None:
                r["admit_step"] = step
                if r["queued_step"] is not None:
                    r["queue_wait"] = step - r["queued_step"]
            r["prefix_hit_tokens"] += e["args"].get("prefix_hit", 0)
        elif k == "request.emit":
            n = e["args"].get("n", 1)
            r["n_emitted"] += n
            r["_emit_steps"].append(step)
            if r["first_emit"] is None:
                r["first_emit"] = step
                base = r["queued_step"] if r["queued_step"] is not None \
                    else r["admit_step"]
                if base is not None and step is not None:
                    r["ttft"] = step - base
                if r["_queued_wall"] is not None:
                    r["ttft_ms"] = (e["wall"] - r["_queued_wall"]) * 1e3
            r["last_emit"] = step
        elif k == "request.preempt":
            r["preemptions"] += 1

    for r in out.values():
        steps = [s for s in r.pop("_emit_steps") if s is not None]
        gaps = [b - a for a, b in zip(steps, steps[1:])]
        r.pop("_queued_wall")
        if gaps:
            g = sorted(gaps)
            r["itl_p50"] = percentile(g, 50)
            r["itl_p95"] = percentile(g, 95)
            r["max_gap"] = g[-1]
    return out
