"""The port's replica tier (``launch/router.py``, ``launch/faults.py``,
``launch/kvstore.py``) against the JAX package's, then on real engines.

1. Fake replicas (the ``FakeReplica`` of tests/test_serve_mesh.py and the
   ``Echo`` of tests/test_faults.py, framework-free): every scenario runs
   through a fresh JAX router and a fresh port router over fresh fakes,
   and the two must agree on the assignment of every request (each
   replica's calls), the outputs, ``last_stats`` (its duration ``s``
   excepted), ``health``, queue depths, the exception type and message,
   the router's telemetry (``deterministic_view``: every event but its
   wall clock) and its counters.  Scenarios: each policy and spill margin,
   sessions and ``Request`` objects, a permanent raise, transients within
   and past the retry budget, a hang past the dispatch deadline, two
   deaths, every replica dead, a short output, ``rejoin``, and
   ``failover=False``; ``parse_fault_plan`` on good and bad plans.
2. Real engines, reduced llama3.2-1b in fp32 (converted weights): JAX's
   acceptance scenario (tests/test_faults.py
   ``test_seeded_crash_completes_all_token_identical``: two rounds, the
   first session's home replica dies on its second dispatch, a shared
   store) and ``test_rejoin_restores_home_and_warm_cache``, through the
   JAX package and the port: the same tokens as each other and as the
   port's no-fault run, and equal failover stats; a store JAX's replica
   wrote restores into a port engine and the reverse, page for page.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.launch import faults as JF
from repro.launch import kvstore as JKV
from repro.launch import router as JR
from repro.runtime import decode_loop as JDL
from repro_torch.launch import faults as F
from repro_torch.launch import kvstore as KV
from repro_torch.launch import router as R
from repro_torch.runtime import decode_loop as DL
from test_faults import Echo
from test_serve_mesh import FakeReplica

PKGS = {"jax": (JR, JF, JDL), "port": (R, F, DL)}


def quiet(msg):
    pass


class Tokens(Echo):
    """Echo of ``Request`` objects (by their tokens), keeping what arrived."""

    def __init__(self):
        super().__init__()
        self.got = []

    def generate(self, prompts):
        self.got.extend(prompts)
        return super().generate([list(p.tokens) for p in prompts])


class Short(Echo):
    """A broken replica: one output short."""

    def generate(self, prompts):
        super().generate(prompts)
        return [[0]] * (len(prompts) - 1)


def _prompts(n=12, width=4):
    return [[i % 5, i % 3, i, i + 1][:width] for i in range(n)]


def _shared():
    shared = list(range(100, 120))
    return [shared + [i] for i in range(4)] + [[i, i, i] for i in range(8)]


# name -> (replica factories, router kwargs, faults {victim: [Fault args]}, drive)
# a victim "home" is the home replica of the first request (rendezvous homes
# depend on the keys, so a fixed index would not always own work)
def _scenarios():
    echo, fake = Echo, FakeReplica
    return {
        "affine": ([echo] * 3, {}, {}, "once"),
        "affine-shared-prefix": ([fake] * 4, {}, {}, "shared"),
        "affine-spill-2": ([echo] * 2, {"spill_margin": 2}, {}, "same"),
        "affine-spill-1": ([echo] * 3, {"spill_margin": 1}, {}, "once"),
        "rr": ([echo] * 3, {"policy": "rr"}, {}, "once"),
        "sessions": ([echo] * 4, {}, {}, "sessions"),
        "requests": ([Tokens] * 2, {"max_retries": 0}, {"home": [("raise", 0)]}, "requests"),
        "raise": ([echo] * 2, {"max_retries": 1}, {"home": [("raise", 0)]}, "once"),
        "raise-late": ([echo] * 3, {"max_retries": 0}, {"home": [("raise", 1)]}, "twice"),
        "transient": ([echo] * 2, {"max_retries": 2}, {"home": [("transient", 0)]}, "once"),
        "transient-exhausted": ([echo] * 2, {"max_retries": 1},
                                {"home": [("transient", 0, 5)]}, "once"),
        "hang-past-deadline": ([echo] * 2, {"max_retries": 1, "dispatch_timeout": 0.05},
                               {"home": [("hang", 0, 1, 0.2)]}, "once"),
        "two-deaths": ([echo] * 3, {"max_retries": 0},
                       {"home": [("raise", 0)], "second": [("raise", 0)]}, "once"),
        "all-dead": ([echo] * 2, {"max_retries": 0}, {0: [("raise", 0)], 1: [("raise", 0)]},
                     "once"),
        "short-output": ([Short, echo], {"max_retries": 0}, {}, "once"),
        "short-alone": ([Short], {"max_retries": 0}, {}, "once"),
        "rejoin": ([echo] * 3, {"max_retries": 0}, {"home": [("raise", 0)]}, "rejoin"),
        "no-failover": ([echo] * 2, {"policy": "rr", "failover": False}, {1: [("raise", 0)]},
                        "once"),
        "no-failover-early": ([echo] * 3, {"policy": "rr", "failover": False},
                              {0: [("raise", 0)]}, "once"),
    }


def _victims(rt, prompts, spec):
    """The replica indices a scenario's faults name."""
    homes = []
    for p in prompts:
        h = rt.home_of(p)
        if h not in homes:
            homes.append(h)
    return {"home": homes[0], "second": homes[1] if len(homes) > 1 else 1 - homes[0]}.get(
        spec, spec)


def _stats(st):
    out = {k: v for k, v in dict(st).items() if k not in ("s", "steps")}
    return out


def _run(pkg, name):
    Rm, Fm, DLm = PKGS[pkg]
    factories, kw, faults, drive = _scenarios()[name]
    fakes = [f() for f in factories]
    seats = [Fm.FaultyReplica(f, name=f"replica{i}") for i, f in enumerate(fakes)]
    rt = Rm.ReplicaRouter(seats, warn=quiet, **kw)
    prompts = _shared() if drive == "shared" else _prompts()
    if drive == "same":
        prompts = [[7, 7, 7]] * 6
    sessions = None
    if drive == "sessions":
        sessions = [f"tenant-{i % 5}" for i in range(len(prompts))]
    if drive == "requests":
        prompts = [DLm.Request(tokens=(i, i + 1, i + 2), priority=i % 2, arrival=i,
                               itl_slo=4.0 + i, prefill_chunks=2, tier="interactive",
                               session=f"tenant-{i % 3}") for i in range(9)]
    for spec, fl in faults.items():
        v = _victims(rt, prompts, spec)
        seats[v].faults.extend(Fm.Fault(*f) for f in fl)
    rec = {"homes": [rt.home_of(p, None if sessions is None else sessions[i])
                     for i, p in enumerate(prompts)]}
    rounds = 2 if drive in ("twice", "rejoin") else 1
    outs = []
    for _ in range(rounds):
        try:
            outs.append(rt.generate(prompts, sessions=sessions))
        except Exception as e:  # the types and messages are compared
            outs.append((type(e).__name__, str(e)))
    if drive == "rejoin":
        dead = [r for r, h in enumerate(rt.health) if h == rt.DEAD]
        for r in dead:
            seats[r].heal()
            rec[f"rejoin {r}"] = rt.rejoin(r)
        rec["homes after rejoin"] = [rt.home_of(p) for p in prompts]
        outs.append(rt.generate(prompts))
    if drive == "requests":  # the objects themselves reach the replicas, re-homed too
        rec["same objects"] = ({id(r) for r in prompts}
                               == {id(r) for f in fakes for r in f.got})
    rec.update(outs=outs, stats=_stats(rt.last_stats), health=list(rt.health),
               depth=list(rt.depth), calls=[[[list(getattr(p, "tokens", p)) for p in c]
                                             for c in f.calls] for f in fakes],
               seats=[(s.dispatches, s.injected, s.hung) for s in seats],
               lifetime=(rt.deaths, rt.retries, rt.timeouts),
               events=rt.telemetry.tracer.deterministic_view(),
               counters={k: rt.telemetry.registry.value(k)
                         for k in ("router_deaths", "router_retries", "router_timeouts")})
    return rec


@pytest.mark.parametrize("name", list(_scenarios()))
def test_router_equals_jax(name):
    jax_rec, port_rec = _run("jax", name), _run("port", name)
    assert port_rec == jax_rec


@pytest.mark.parametrize("spec", ["1:raise@2; 0:transient@1x3 ;2:hang@0~0.25", "0:raise@0",
                                  "3:transient@2x2~0.1;3:raise@5", "", "1-raise-2",
                                  "0:explode@1", "0:raise@-1", "x:raise@1"])
def test_fault_plan_equals_jax(spec):
    def parse(mod):
        try:
            return {r: [(f.kind, f.at_dispatch, f.count, f.hang_s) for f in fl]
                    for r, fl in mod.parse_fault_plan(spec).items()}
        except Exception as e:
            return type(e).__name__, str(e)

    assert parse(F) == parse(JF)


# ---------------------------------------------------------------------------
# real engines: the acceptance scenario through both packages
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _model():
    from repro.configs import get_config as jget, reduced as jreduced
    from repro.models import transformer as JT
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import from_jax_params

    kw = dict(param_dtype="float32", remat="none")
    jc = dataclasses.replace(jreduced(jget("llama3.2-1b")), **kw)
    tc = dataclasses.replace(reduced(get_config("llama3.2-1b")), **kw)
    jp = JT.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, from_jax_params(jax.device_get(jp), "cpu")


def _engine(pkg):
    """tests/test_faults.py's ``make_engine``, in either package."""
    from repro.runtime import paged as JPG
    from repro_torch.runtime import paged as PG

    jc, tc, jp, tp = _model()
    cfg, params, mod = (jc, jp, JPG) if pkg == "jax" else (tc, tp, PG)
    return mod.PagedServeEngine(cfg, params, slots=2, bucket=24, max_new_tokens=4,
                                page_size=4, segment=1, spill_pages=32)


def _workload(seed):
    """tests/test_faults.py's ``session_workload``."""
    rng = np.random.default_rng(seed)
    V = _model()[0].vocab_size
    shared = [int(t) for t in rng.integers(0, V, 8)]
    prompts, sessions = [], []
    for s in range(4):
        prompts.append(shared + [int(t) for t in rng.integers(0, V, 8)])
        sessions.append(f"tenant-{s}")
    return prompts, sessions


FO_KEYS = ("deaths", "dead", "retries", "timeouts", "rehomed_requests", "rehomed_sessions",
           "recovered_prefix_tokens", "recovered_pages", "health", "live", "lifetime")


def _crash_run(pkg, tmp, seed, max_retries, rejoin=False):
    """Two rounds with the first session's home replica dying on its
    second dispatch (and, with ``rejoin``, its seat back as a fresh engine
    and a third round)."""
    Rm, Fm, _ = PKGS[pkg]
    KVm = JKV if pkg == "jax" else KV
    prompts, sessions = _workload(seed)
    engines = [_engine(pkg) for _ in range(2)]
    rt = Rm.ReplicaRouter(engines, max_retries=max_retries,
                          kv_store=KVm.SharedKVStore(str(tmp / pkg)), warn=quiet)
    victim = rt.home_of(prompts[0], sessions[0])
    faulty = Fm.FaultyReplica(engines[victim], [Fm.Fault("raise", 1)], name=f"replica{victim}")
    rt.replicas[victim] = faulty
    rec = {"victim": victim,
           "rounds": [rt.generate(prompts, sessions=sessions) for _ in range(2)]}
    rec["failover"] = {k: rt.last_stats["failover"][k] for k in FO_KEYS}
    if rejoin:
        faulty.inner = _engine(pkg)
        faulty.heal()
        rec["restored"] = rt.rejoin(victim)
        rec["home"] = rt.home_of(prompts[0], sessions[0])
        rec["round3"] = rt.generate(prompts, sessions=sessions)
        rec["hit"] = rt.last_stats["per_replica"][victim].get("prefix_hit_tokens", 0)
    return rec


@pytest.fixture(scope="module")
def no_fault():
    """The port's no-fault reference: fresh engines, the same two rounds."""
    out = {}
    for seed in (0, 1):
        prompts, sessions = _workload(seed)
        rt = R.ReplicaRouter([_engine("port") for _ in range(2)], warn=quiet)
        out[seed] = [rt.generate(prompts, sessions=sessions) for _ in range(2)]
    return out


def test_seeded_crash_equals_jax(tmp_path, no_fault):
    got = {pkg: _crash_run(pkg, tmp_path, 0, max_retries=1) for pkg in PKGS}
    assert got["port"] == got["jax"]
    assert got["port"]["rounds"] == no_fault[0]
    fo = got["port"]["failover"]
    assert fo["deaths"] == 1 and fo["rehomed_requests"] > 0 and fo["rehomed_sessions"] > 0
    assert fo["recovered_pages"] > 0 and fo["recovered_prefix_tokens"] > 0


def test_rejoin_equals_jax(tmp_path, no_fault):
    got = {pkg: _crash_run(pkg, tmp_path, 1, max_retries=0, rejoin=True) for pkg in PKGS}
    assert got["port"] == got["jax"]
    assert got["port"]["rounds"] == no_fault[1]
    assert got["port"]["round3"] == no_fault[1][1]
    assert got["port"]["restored"] > 0 and got["port"]["hit"] > 0
    assert got["port"]["home"] == got["port"]["victim"]


def test_store_crosses_between_packages(tmp_path):
    """A replica's published store, JAX's into a port engine and the
    port's into a JAX engine: the same pages restore and the restored
    engine serves the prompts with the writer's tokens and hits."""
    prompts, sessions = _workload(2)
    outs, n = {}, {}
    for pkg in PKGS:
        KVm = JKV if pkg == "jax" else KV
        eng = _engine(pkg)
        outs[pkg] = eng.generate(prompts)
        n[pkg] = KVm.SharedKVStore(str(tmp_path / pkg)).publish(0, eng)
    assert outs["port"] == outs["jax"] and n["port"] == n["jax"] > 0
    for writer, reader in (("jax", "port"), ("port", "jax")):
        KVm = JKV if reader == "jax" else KV
        eng = _engine(reader)
        got = KVm.SharedKVStore(str(tmp_path / writer)).recover(0, [eng])
        assert got == n[writer]
        assert eng.generate(prompts) == outs[writer]
        assert eng.last_stats["prefix_hit_tokens"] > 0
