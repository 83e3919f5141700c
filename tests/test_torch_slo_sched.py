"""The port's SLO-aware scheduler (``runtime/paged.py::SLOPagedServeEngine``)
against the JAX package's, on reduced llama3.2-1b in fp32 with the same
(converted) parameters: preemption of a decoding request and of one
mid-prefill, prefill-budget pauses, the fifo and slo policies and a pool
under sustained pressure give JAX's tokens and per-request records, and
the tokens of uninterrupted solo runs; the three refusals are JAX's.  The
JAX engines run with ``n_host_chunks=0``, but for the port's parked pool's
case, held to JAX's engine with ``n_host_chunks=2`` and no
``ParallelContext`` (its page-by-page pass with nothing parked: JAX's
parked pool fails on this box, ROADMAP Queue C)."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models import transformer as JT
from repro.runtime import decode_loop as JDL
from repro.runtime import paged as JPG
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_params
from repro_torch.runtime import decode_loop as DL
from repro_torch.runtime import paged as PG

STATS = ("policy", "preemptions", "prefill_pauses", "deferrals", "prefix_hit_tokens",
         "prefilled_tokens", "spill_promotes", "dispatches", "pending_len", "capacity")


@functools.lru_cache(maxsize=None)
def _model(arch="llama3.2-1b"):
    kw = dict(param_dtype="float32", remat="none")
    jc = dataclasses.replace(j_reduced(j_get_config(arch)), **kw)
    tc = dataclasses.replace(reduced(get_config(arch)), **kw)
    jparams = JT.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jparams, from_jax_params(jax.device_get(jparams), "cpu")


def _tokens(seed, *lens):
    rng = np.random.default_rng(seed)
    return [tuple(int(t) for t in rng.integers(0, 256, n)) for n in lens]


def _both(reqs, **kw):
    """(port engine, its outputs, JAX engine, its outputs) for one workload."""
    jc, tc, jparams, tparams = _model()
    eng = PG.SLOPagedServeEngine(tc, tparams, **kw)
    jeng = JPG.SLOPagedServeEngine(jc, jparams, **kw)
    got = eng.generate([DL.Request(**r) for r in reqs])
    want = jeng.generate([JDL.Request(**r) for r in reqs])
    return eng, got, jeng, want


def _assert_as_jax(eng, got, jeng, want):
    assert got == want
    assert {k: eng.last_stats[k] for k in STATS} == {k: jeng.last_stats[k] for k in STATS}
    assert eng.last_stats["requests"] == jeng.last_stats["requests"]


def _solo(prompt, gen=8, bucket=16, **kw):
    """An uninterrupted one-slot run of ``prompt`` on a fresh port engine."""
    _, tc, _, tparams = _model()
    eng = PG.SLOPagedServeEngine(tc, tparams, slots=1, bucket=bucket, max_new_tokens=gen,
                                 page_size=4, segment=1, **kw)
    return eng.generate([list(prompt)])[0]


ONE_SLOT = dict(slots=1, bucket=16, max_new_tokens=8, page_size=4, segment=1, spill_pages=8)


@functools.lru_cache(maxsize=None)
def _policies():
    """tests/test_slo_sched.py's fifo-vs-slo workload on both packages: a
    low-priority 13-token request decoding when two priority-0 requests
    arrive."""
    long_p, short_p = _tokens(0, 13, 5)
    reqs = [dict(tokens=long_p, priority=1, arrival=0),
            dict(tokens=short_p, priority=0, arrival=6),
            dict(tokens=short_p[::-1], priority=0, arrival=7)]
    return reqs, {policy: _both(reqs, policy=policy, **ONE_SLOT) for policy in ("slo", "fifo")}


def test_preempt_resume_matches_jax_and_solo():
    """slo preempts the decoding low-priority request (its pages published,
    the slot released, resumed with its remaining budget): JAX's tokens,
    stats and request records, and every request's solo tokens."""
    reqs, runs = _policies()
    eng, got, jeng, want = runs["slo"]
    _assert_as_jax(eng, got, jeng, want)
    assert eng.last_stats["preemptions"] >= 1
    assert eng.last_stats["requests"][0]["preemptions"] >= 1
    assert got == [_solo(r["tokens"]) for r in reqs]


def test_preempt_resume_on_the_host_pool():
    """tests/test_slo_sched.py's host case (which fails on this box: JAX
    parks nothing here, ROADMAP Queue C) on the port's parked pool
    (n_host_chunks=2): slo preempts and resumes with JAX's tokens, stats
    and records (JAX's engine with n_host_chunks=2 and no
    ParallelContext: its page-by-page pass, S rounded to whole slabs) and
    every request's solo tokens."""
    reqs, _ = _policies()
    eng, got, jeng, want = _both(reqs, policy="slo", n_host_chunks=2, **ONE_SLOT)
    _assert_as_jax(eng, got, jeng, want)
    assert eng.last_stats["preemptions"] >= 1 and eng.last_stats["host_kv_pages"] > 0
    assert got == [_solo(r["tokens"]) for r in reqs]


def test_fifo_equals_slo_as_jax():
    """fifo never preempts and gives slo's tokens; its records are JAX's."""
    _, runs = _policies()
    eng, got, jeng, want = runs["fifo"]
    _assert_as_jax(eng, got, jeng, want)
    assert eng.last_stats["preemptions"] == 0
    assert got == runs["slo"][1]


def test_preempt_mid_prefill_matches_jax():
    """A slot preempted while still prefilling publishes its computed
    pages; the resume maps them back (prefix hits): JAX's tokens and
    records, and the solo tokens."""
    long_p, short_p = _tokens(3, 30)[0], _tokens(0, 13, 5)[1]
    reqs = [dict(tokens=long_p, priority=1, arrival=0),
            dict(tokens=short_p, priority=0, arrival=3)]
    kw = dict(slots=1, bucket=40, max_new_tokens=8, page_size=4, segment=1, prefill_chunk=4,
              spill_pages=16)
    eng, got, jeng, want = _both(reqs, **kw)
    _assert_as_jax(eng, got, jeng, want)
    assert eng.last_stats["preemptions"] >= 1 and eng.last_stats["prefix_hit_tokens"] > 0
    assert got == [_solo(r["tokens"], bucket=40, prefill_chunk=4) for r in reqs]


def test_prefill_budget_pause_matches_jax():
    """A long prefill past its one-chunk budget pauses on the trash row
    while the short request decodes, then resumes: JAX's tokens and
    records, and the unbudgeted solo tokens."""
    long_p, short_p = _tokens(4, 25)[0], _tokens(0, 13, 5)[1]
    reqs = [dict(tokens=short_p, priority=0, arrival=0),
            dict(tokens=long_p, priority=1, arrival=1)]
    kw = dict(slots=2, bucket=32, max_new_tokens=8, page_size=4, segment=1, prefill_chunk=4,
              prefill_budget=1)
    eng, got, jeng, want = _both(reqs, **kw)
    _assert_as_jax(eng, got, jeng, want)
    assert eng.last_stats["prefill_pauses"] >= 1
    assert got == [_solo(r["tokens"], bucket=32, prefill_chunk=4) for r in reqs]


def test_no_starvation_under_pressure_as_jax():
    """Priority-0 requests arriving every 3 steps over a pool for about two
    requests: the low-priority ones are deferred and preempted, and every
    request still emits its whole budget, as in JAX."""
    rng = np.random.default_rng(5)
    reqs = [dict(tokens=tuple(int(t) for t in rng.integers(0, 256, 14)), priority=1, arrival=0)
            for _ in range(2)]
    reqs += [dict(tokens=tuple(int(t) for t in rng.integers(0, 256, 4)), priority=0,
                  arrival=2 + 3 * i) for i in range(6)]
    kw = dict(slots=2, bucket=20, max_new_tokens=6, page_size=4, segment=1, n_pages=14,
              spill_pages=16)
    eng, got, jeng, want = _both(reqs, **kw)
    _assert_as_jax(eng, got, jeng, want)
    assert eng.last_stats["preemptions"] >= 1
    assert all(len(o) == 6 for o in got)


def test_raw_prompts_as_paged_engine():
    """Raw token lists are default requests: the same tokens as the
    PagedServeEngine."""
    _, tc, _, tparams = _model()
    prompts = [list(p) for p in _tokens(0, 13, 5)]
    kw = dict(slots=2, bucket=16, max_new_tokens=4, page_size=4, segment=1)
    assert (PG.SLOPagedServeEngine(tc, tparams, **kw).generate(prompts)
            == PG.PagedServeEngine(tc, tparams, **kw).generate(prompts))


@pytest.mark.parametrize("arch, over, match", [
    ("falcon-mamba-7b", {}, "recurrent"), ("recurrentgemma-9b", {}, "recurrent"),
    ("llama3.2-1b", {"radix": False}, "radix"), ("llama3.2-1b", {"policy": "lifo"}, "policy")])
def test_refusals_as_jax(arch, over, match):
    """Recurrent layouts, radix off and an unknown policy are refused with
    JAX's messages (at construction: no weight is read, so a stand-in
    tree says where the engine runs)."""
    kw = dict(param_dtype="float32", remat="none")
    jc = dataclasses.replace(j_reduced(j_get_config(arch)), **kw)
    tc = dataclasses.replace(reduced(get_config(arch)), **kw)
    kw = dict(slots=1, bucket=8, max_new_tokens=2, page_size=4, **over)
    with pytest.raises(ValueError, match=match) as got:
        PG.SLOPagedServeEngine(tc, {"embed": torch.zeros(1)}, **kw)
    with pytest.raises(ValueError) as want:
        JPG.SLOPagedServeEngine(jc, {}, **kw)
    assert str(got.value) == str(want.value)
