"""The port's copy of the telemetry module (``repro_torch/runtime/
telemetry.py``) against the JAX package's (``repro/runtime/telemetry.py``).

The same scripted sequences (counters, gauges, a histogram past its
reservoir, a full ``StepRing``, a ``StatsView``, the tracer with spans,
instants and a full buffer, ``compile_event`` past its program limit,
``timed_dispatch``, synthetic request events, two replicas) go through
both modules on one fake clock in place of ``time.perf_counter``, and
their exports are the same: ``prometheus_text``, ``deterministic_view``,
``request_summaries`` and ``chrome_trace`` (timestamps and durations
included: the clock is the same).  Then every case of
tests/test_telemetry.py that needs no engine or router runs again against
the port's module (that file stays as it is)."""
import itertools
import json
import types

import pytest

from repro.runtime import telemetry as JTM
from repro_torch.runtime import telemetry as TM

MODULES = {"jax": JTM, "port": TM}


@pytest.fixture
def fake_clock(monkeypatch):
    """Both modules read one clock that advances 1.25 ms a reading,
    restarted for each module's script."""
    def install():
        ticks = itertools.count()
        clock = types.SimpleNamespace(perf_counter=lambda: 100.0 + 1.25e-3 * next(ticks))
        for mod in MODULES.values():
            monkeypatch.setattr(mod, "time", clock)
    return install


def _script(tm):
    """One run of everything the module records, on its own objects."""
    eng = tm.Telemetry(component="engine", replica=1, program_limit=2)
    other = tm.Telemetry(component="router")
    reg = eng.registry
    reg.counter("emitted_tokens").inc(10)
    reg.counter("emitted_tokens").inc(3)
    reg.gauge("capacity").set(4)
    reg.gauge("label").set("not exported")
    h = reg.histogram("latency_ms", reservoir=16)
    for v in range(40):  # past the reservoir
        h.observe(float(v) * 0.5)
    ring = eng.steps_ring()
    ring.cap = 3
    for i in range(5):  # a full ring
        ring.append({"ms": float(i)})
    stats = eng.stats_view({"steps": ring, "dispatches": 0, "policy": "slo"}, prefix="s_")
    stats["dispatches"] += 1
    stats["prefix_hit_tokens"] = 7
    for step in range(3):
        with tm.timed_dispatch(eng, stats, prefilling=step, step=step) as td:
            td.emitted = step + 1
    with tm.timed_dispatch(eng, stats) as td:
        td.emitted = 2
    for _ in range(4):  # past the program limit
        eng.compile_event("segment", step=9)
    eng.event("request.queued", request=0, session="s", step=2)
    eng.event("request.admit", request=0, step=5, slot=1, prefix_hit=8)
    eng.event("request.emit", request=0, step=7, slot=1, n=2)
    eng.event("request.preempt", request=0, step=8, slot=1)
    eng.event("request.resume", request=0, step=10, slot=0, prefix_hit=4)
    eng.event("request.emit", request=0, step=11, slot=0, n=1)
    eng.event("request.queued", request=1, step=3)
    eng.event("request.admit", request=1, step=4, slot=2)
    eng.event("request.emit", request=1, step=6, slot=2)
    eng.event("train.step", step=1, dur_ms=12.5, loss=2.0)
    other.event("router.dispatch", step=1, replica=0, dur_ms=1.0, lat_ms=3.0)
    small = tm.Tracer(max_events=4)
    for i in range(7):  # a full buffer
        small.event("e", step=i, k=i)
    off = tm.Telemetry(component="off").set_tracing(False)
    off.event("request.admit", request=0)
    off.compile_event("segment")
    return {"eng": eng, "other": other, "small": small, "off": off, "stats": dict(stats),
            "ring": list(ring), "ring_dropped": ring.dropped}


def _exports(tm, fake_clock):
    fake_clock()
    s = _script(tm)
    both = [s["eng"], s["other"], s["off"]]
    return {
        "prometheus": tm.prometheus_text(both),
        "prometheus_prefixed": tm.prometheus_text(s["eng"], prefix="x_"),
        "deterministic": [s["eng"].tracer.deterministic_view(),
                          s["small"].deterministic_view(), s["off"].tracer.deterministic_view()],
        "summaries": s["eng"].request_summaries(),
        "chrome": tm.chrome_trace(both),
        "snapshot": s["eng"].registry.snapshot(),
        "dropped": [s["small"].dropped, s["eng"].tracer.dropped, s["ring_dropped"]],
        "ring": s["ring"], "alerts": s["eng"].alerts(),
        "stats": {k: v for k, v in s["stats"].items() if k != "steps"},
    }


@pytest.fixture
def exports(fake_clock):
    return {name: _exports(mod, fake_clock) for name, mod in MODULES.items()}


@pytest.mark.parametrize("key", ["prometheus", "prometheus_prefixed", "deterministic",
                                 "summaries", "snapshot", "dropped", "ring", "alerts", "stats"])
def test_exports_identical(exports, key):
    assert exports["port"][key] == exports["jax"][key]
    assert exports["port"][key] not in (None, [], {}, "")


def test_chrome_trace_identical(exports):
    port, jax_ = exports["port"]["chrome"], exports["jax"]["chrome"]
    assert json.dumps(port, sort_keys=True) == json.dumps(jax_, sort_keys=True)
    spans = [e for e in port["traceEvents"] if e.get("ph") == "X"]
    assert {e["name"] for e in spans} >= {"engine.dispatch", "train.step", "router.dispatch"}
    # and once ts and dur are dropped, as a trace from another clock compares
    strip = [[{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in d["traceEvents"]]
             for d in (port, jax_)]
    assert strip[0] == strip[1]


def test_writers_write_the_same_bytes(tmp_path, fake_clock):
    out = {}
    for name, mod in MODULES.items():
        fake_clock()
        s = _script(mod)
        mod.write_chrome_trace(str(tmp_path / f"{name}.json"), [s["eng"], s["other"]])
        mod.write_prometheus(str(tmp_path / f"{name}.prom"), s["eng"])
        out[name] = [(tmp_path / f"{name}.{ext}").read_bytes() for ext in ("json", "prom")]
    assert out["port"] == out["jax"]


def test_writers_raise_on_a_bad_path(tmp_path):
    tel = TM.Telemetry(component="train")
    with pytest.raises(OSError):
        TM.write_chrome_trace(str(tmp_path / "missing" / "t.json"), tel)
    with pytest.raises(OSError):
        TM.write_prometheus(str(tmp_path / "missing" / "m.prom"), tel)


# ---------------------------------------------------------------------------
# tests/test_telemetry.py's cases that need no engine or router, on the port
# ---------------------------------------------------------------------------


def test_registry_create_on_first_use_and_value():
    reg = TM.MetricsRegistry()
    assert reg.counter("a") is reg.counter("a")
    reg.counter("a").inc(3)
    reg.gauge("g").set(2.5)
    reg.histogram("h").observe(1.0)
    assert reg.value("a") == 3
    assert reg.value("g") == 2.5
    assert reg.value("missing", default=-1) == -1
    snap = reg.snapshot()
    assert snap["a"] == 3 and snap["h"]["count"] == 1


def test_histogram_exact_aggregates_bounded_reservoir():
    h = TM.Histogram(reservoir=8)
    for v in range(100):
        h.observe(float(v))
    assert h.count == 100 and h.total == sum(range(100))
    assert h.vmin == 0.0 and h.vmax == 99.0
    assert len(h.window) == 8 and h.dropped == 92
    assert h.percentile(50) >= 92.0
    s = h.summary()
    assert s["count"] == 100 and s["dropped"] == 92


def test_step_ring_bounds_like_a_list():
    ring = TM.StepRing(cap=4)
    for i in range(6):
        ring.append({"ms": float(i)})
    assert len(ring) == 4 and ring.dropped == 2
    assert ring[0]["ms"] == 2.0 and ring[-1]["ms"] == 5.0
    assert [r["ms"] for r in ring[1:]] == [3.0, 4.0, 5.0]
    assert [r["ms"] for r in ring] == [2.0, 3.0, 4.0, 5.0]
    assert bool(ring) and not bool(TM.StepRing())


def test_stats_view_mirrors_scalars_into_registry():
    tel = TM.Telemetry(component="t")
    st = tel.stats_view({"dispatches": 0, "policy": "slo", "radix": True})
    st["dispatches"] += 3
    st["prefix_hit_tokens"] = 7
    assert st["dispatches"] == 3 and st.get("missing", 5) == 5
    assert "policy" in st and dict(st)["prefix_hit_tokens"] == 7
    assert tel.registry.value("dispatches") == 3
    assert tel.registry.value("prefix_hit_tokens") == 7
    assert "policy" not in tel.registry.gauges
    assert "radix" not in tel.registry.gauges
    assert st["radix"] is True


def test_timed_dispatch_record_shape_and_registry():
    tel = TM.Telemetry(component="t")
    stats = tel.stats_view({"steps": tel.steps_ring(), "dispatches": 0})
    with TM.timed_dispatch(tel, stats, prefilling=1) as td:
        td.emitted = 4
    with TM.timed_dispatch(tel, stats, step=9) as td:
        td.emitted = 2
        td.prefilling = 3
    assert stats["dispatches"] == 2
    rec0, rec1 = stats["steps"][0], stats["steps"][1]
    assert set(rec0) == {"ms", "prefilling", "emitted"}
    assert rec0["prefilling"] == 1 and rec0["emitted"] == 4
    assert rec1["step"] == 9 and rec1["prefilling"] == 3
    assert tel.registry.value("emitted_tokens") == 6
    assert tel.registry.histograms["dispatch_ms"].count == 2
    assert tel.tracer.kinds() == ["engine.dispatch", "engine.dispatch"]


def test_tracer_deterministic_view_excludes_wall_clock():
    t = TM.Tracer()
    t.event("x", step=1, request=0, dur_ms=3.5, lat_ms=9.9, n=2)
    (ev,) = t.deterministic_view()
    assert ev == ("x", 1, 0, None, None, None, (("n", 2),))
    flat = repr(ev)
    assert "3.5" not in flat and "9.9" not in flat


def test_tracer_buffer_bounded():
    t = TM.Tracer(max_events=3)
    for i in range(5):
        t.event("e", step=i)
    assert len(t.events) == 3 and t.dropped == 2
    assert [e["step"] for e in t.events] == [2, 3, 4]


def test_set_tracing_off_stops_events_not_counters():
    tel = TM.Telemetry(component="t").set_tracing(False)
    tel.event("request.admit", request=0)
    tel.compile_event("segment")
    assert len(tel.tracer.events) == 0
    assert tel.registry.value("compiles_segment") == 1


def test_compile_event_alert_past_program_limit():
    tel = TM.Telemetry(component="t", program_limit=1)
    tel.compile_event("segment")
    assert tel.alerts() == 0
    tel.compile_event("segment")
    assert tel.alerts() == 1
    assert "alert.programs" in tel.tracer.kinds()


def test_request_summaries_from_synthetic_events():
    t = TM.Tracer()
    t.event("request.queued", request=0, session="s", step=2)
    t.event("request.admit", request=0, step=5, prefix_hit=8)
    t.event("request.emit", request=0, step=7, n=2)
    t.event("request.preempt", request=0, step=8)
    t.event("request.resume", request=0, step=10, prefix_hit=4)
    t.event("request.emit", request=0, step=11, n=1)
    t.event("request.emit", request=0, step=12, n=1)
    s = TM.request_summaries(t)[0]
    assert s["queued_step"] == 2 and s["admit_step"] == 5
    assert s["queue_wait"] == 3
    assert s["ttft"] == 5 and s["first_emit"] == 7 and s["last_emit"] == 12
    assert s["n_emitted"] == 4 and s["preemptions"] == 1
    assert s["prefix_hit_tokens"] == 12
    assert s["itl_p50"] == 1 and s["max_gap"] == 4


def _sample_telemetry():
    tel = TM.Telemetry(component="engine", replica=1)
    tel.registry.counter("emitted_tokens").inc(10)
    tel.registry.gauge("capacity").set(4)
    tel.registry.histogram("dispatch_ms").observe(2.0)
    tel.event("request.admit", request=0, slot=1, step=3)
    tel.event("engine.dispatch", step=4, dur_ms=2.0)
    return tel


def test_chrome_trace_round_trips_as_json():
    doc = json.loads(json.dumps(TM.chrome_trace([_sample_telemetry()])))
    evs = doc["traceEvents"]
    names = {e["name"] for e in evs}
    assert {"process_name", "thread_name", "request.admit", "engine.dispatch"} <= names
    meta = [e for e in evs if e["name"] == "process_name"]
    assert meta[0]["args"]["name"] == "engine[1]"
    span = next(e for e in evs if e["name"] == "engine.dispatch")
    assert span["ph"] == "X" and span["dur"] == pytest.approx(2000.0)
    inst = next(e for e in evs if e["name"] == "request.admit")
    assert inst["ph"] == "i" and inst["tid"] == 2
    tracks = {e["tid"]: e["args"]["name"] for e in evs if e["name"] == "thread_name"}
    assert tracks[0] == "scheduler" and tracks[2] == "slot 1"


def test_prometheus_text_exposition():
    text = TM.prometheus_text([_sample_telemetry()])
    assert '# TYPE repro_emitted_tokens counter' in text
    assert 'repro_emitted_tokens{component="engine",replica="1"} 10' in text
    assert '# TYPE repro_capacity gauge' in text
    assert 'repro_dispatch_ms{component="engine",replica="1",quantile="0.5"}' in text
    assert 'repro_dispatch_ms_count{component="engine",replica="1"} 1' in text
    for line in text.strip().splitlines():
        if line.startswith("#"):
            continue
        name, rest = line.split("{", 1)
        labels, value = rest.rsplit("} ", 1)
        assert name.startswith("repro_") and float(value) is not None


def test_write_exporters(tmp_path):
    tel = _sample_telemetry()
    TM.write_chrome_trace(str(tmp_path / "t.json"), tel)
    TM.write_prometheus(str(tmp_path / "m.prom"), tel)
    assert json.load(open(tmp_path / "t.json"))["traceEvents"]
    assert "repro_" in open(tmp_path / "m.prom").read()
