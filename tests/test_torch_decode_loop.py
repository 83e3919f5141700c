"""The port's continuous-batching engines (``runtime/decode_loop.py``)
against the JAX package's on reduced configs in fp32 with the same
(converted) parameters: ``ServeEngine`` greedy tokens equal JAX's for
llama3.2-1b, falcon-mamba-7b and recurrentgemma-9b on the workloads of
``tests/test_serve_sched.py`` and ``tests/test_serve.py`` (mixed lengths,
prompts longer than the bucket, stop tokens firing at different steps and
from the prefill logits); ``BlockingServeEngine`` equals JAX's, refusals
included; host-streamed KV changes no token; and the JAX engine edge
cases (zero budget, every slot finishing in one step, a long queue, an
empty prompt) hold against the port's solo generation."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models import transformer as JT
from repro.runtime import decode_loop as JDL
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_params
from repro_torch.models import serve as SV
from repro_torch.runtime import decode_loop as DL

ARCHS = ["llama3.2-1b", "falcon-mamba-7b", "recurrentgemma-9b"]


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(JAX config, port config, JAX params, port params) of the reduced
    ``arch`` in fp32, built once a file."""
    kw = dict(param_dtype="float32", remat="none")
    jc = dataclasses.replace(j_reduced(j_get_config(arch)), **kw)
    tc = dataclasses.replace(reduced(get_config(arch)), **kw)
    jparams = JT.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jparams, from_jax_params(jax.device_get(jparams), "cpu")


def _prompts(arch, seed, lengths):
    vocab = _model(arch)[0].vocab_size
    rng = np.random.default_rng(seed)
    return tuple(tuple(rng.integers(0, vocab, size=n).tolist()) for n in lengths)


@functools.lru_cache(maxsize=None)
def _jax(arch, prompts, blocking=False, **kw):
    """The JAX engine's greedy output, once per workload and setting."""
    jc, _, jparams, _ = _model(arch)
    cls = JDL.BlockingServeEngine if blocking else JDL.ServeEngine
    return cls(jc, jparams, **kw).generate([list(p) for p in prompts])


def _port(arch, prompts, blocking=False, **kw):
    _, tc, _, tparams = _model(arch)
    cls = DL.BlockingServeEngine if blocking else DL.ServeEngine
    return cls(tc, tparams, **kw).generate([list(p) for p in prompts])


def _solo(arch, prompt, max_new):
    """The port's whole-prompt prefill + per-token greedy decode."""
    _, tc, _, tparams = _model(arch)
    if max_new <= 0:
        return []
    logits, cache = SV.prefill_step(tc, None, tparams, {"tokens": torch.tensor([prompt])},
                                    max_len=len(prompt) + max_new)
    out = [int(torch.argmax(logits[:, : tc.vocab_size], -1)[0])]
    for i in range(max_new - 1):
        logits, cache = SV.decode_step(tc, None, tparams, cache,
                                       {"tokens": torch.tensor([[out[-1]]])}, len(prompt) + i)
        out.append(int(torch.argmax(logits[:, : tc.vocab_size], -1)[0]))
    return out


def _trunc(g, stop):
    return g[: g.index(stop) + 1] if stop in g else g


# tests/test_serve_sched.py::test_engine_recurrent_mixed_lengths' workload
MIXED = dict(slots=2, bucket=8, max_new_tokens=5, segment=2, prefill_chunk=4)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax(arch):
    """Mixed lengths over 2 slots, a 12-token prompt longer than the
    bucket (three chunks), then a stop token from prompt 0's third token:
    the port's tokens are the JAX engine's, and its own solo generation's."""
    prompts = _prompts(arch, 0, (3, 8, 5, 12, 6))
    want = _jax(arch, prompts, **MIXED)
    assert _port(arch, prompts, **MIXED) == want
    assert want == [_solo(arch, list(p), 5) for p in prompts]
    stop = want[0][2]
    got = _port(arch, prompts, stop_tokens=(stop,), **MIXED)
    assert got == _jax(arch, prompts, stop_tokens=(stop,), **MIXED)
    assert got == [_trunc(g, stop) for g in want]


def test_engine_staggered_finishes_match_jax():
    """tests/test_serve.py::test_continuous_batching_staggered_finishes:
    a stop token firing at different steps, and one sampled from the
    prefill logits (a one-token output), as in the JAX engine."""
    arch = "llama3.2-1b"
    prompts = _prompts(arch, 0, (3, 8, 5, 6))
    kw = dict(slots=2, bucket=8, max_new_tokens=6, segment=2)
    plain = _jax(arch, prompts, **kw)
    stop, stop0 = plain[0][2], plain[2][0]
    for s in (stop, stop0):
        got = _port(arch, prompts, stop_tokens=(s,), **kw)
        assert got == _jax(arch, prompts, stop_tokens=(s,), **kw)
        assert got == [_trunc(g, s) for g in plain]
    assert len({len(_trunc(g, stop)) for g in plain}) > 1  # finishes staggered
    assert len(_trunc(plain[2], stop0)) == 1


def test_engine_prompts_longer_than_bucket():
    """Prompts longer than the bucket stream in over more chunks; the
    blocking engine refuses them, naming the offender, as JAX's does."""
    arch = "llama3.2-1b"
    prompts = _prompts(arch, 1, (20, 3, 17))
    kw = dict(slots=2, bucket=8, max_new_tokens=4, segment=3, prefill_chunk=8)
    assert _port(arch, prompts, **kw) == _jax(arch, prompts, **kw)
    _, tc, _, tparams = _model(arch)
    blk = DL.BlockingServeEngine(tc, tparams, slots=2, bucket=8, max_new_tokens=4)
    with pytest.raises(ValueError, match="prompt 0 has length 20"):
        blk.generate([list(p) for p in prompts])


@pytest.mark.parametrize("arch", ["llama3.2-1b", "falcon-mamba-7b"])
def test_blocking_matches_jax(arch):
    """The blocking engine's batched and refill prefills, segments and
    harvest give JAX's tokens: llama on mixed lengths with a stop token
    (position-masked prefill), falcon on prompts that fill the bucket (the
    only way a recurrent layout takes this engine)."""
    if arch == "llama3.2-1b":
        prompts = _prompts(arch, 0, (3, 8, 5, 6))
        kw = dict(slots=2, bucket=8, max_new_tokens=6, segment=2)
        stop = _jax(arch, prompts, **kw)[0][2]
        kw["stop_tokens"] = (stop,)
    else:
        prompts = _prompts(arch, 1, (6, 6, 6))
        kw = dict(slots=2, bucket=6, max_new_tokens=4, segment=2)
    want = _jax(arch, prompts, blocking=True, **kw)
    assert _port(arch, prompts, blocking=True, **kw) == want
    assert want == _jax(arch, prompts, **kw)  # the fused engine's tokens too


def test_host_streamed_engines_change_no_token():
    """Both engines with the full-attention KV streamed in slabs (the CPU's
    identity offload: the slab loop, live skip and write-back run) give
    the tokens of on-device attention; a count that does not divide the
    blocking engine's cache is refused."""
    arch = "llama3.2-1b"
    prompts = _prompts(arch, 0, (3, 8, 5, 12, 6))
    SV.reset_host_kv()
    assert _port(arch, prompts, n_host_chunks=4, **MIXED) == _jax(arch, prompts, **MIXED)
    assert SV.host_kv["fetched"] > 0 and SV.host_kv["skipped"] > 0
    short = _prompts(arch, 0, (3, 8, 5, 6))
    kw = dict(slots=2, bucket=8, max_new_tokens=6, segment=2)
    assert (_port(arch, short, blocking=True, n_host_chunks=2, **kw)
            == _jax(arch, short, blocking=True, **kw))
    _, tc, _, tparams = _model(arch)
    with pytest.raises(ValueError, match="does not divide"):
        DL.BlockingServeEngine(tc, tparams, n_host_chunks=3, **kw)
    with pytest.raises(ValueError, match="does not divide"):
        JDL.BlockingServeEngine(_model(arch)[0], _model(arch)[2], n_host_chunks=3, **kw)


def test_engine_edge_cases():
    """tests/test_serve_sched.py::test_engine_edge_cases, each against the
    port's solo generation: zero budget, a stop token from the prefill
    logits, every slot finishing in the same step, a queue longer than the
    slots, an empty prompt refused."""
    arch = "llama3.2-1b"
    _, tc, _, tparams = _model(arch)
    rng = np.random.default_rng(2)

    def mk(n):
        return rng.integers(0, tc.vocab_size, size=n).tolist()

    def engine(**kw):
        return DL.ServeEngine(tc, tparams, bucket=8, prefill_chunk=4, **kw)

    prompts = [mk(3), mk(6), mk(4)]
    assert engine(slots=2, max_new_tokens=0, segment=2).generate(prompts) == [[]] * 3

    solos = [_solo(arch, p, 5) for p in prompts]
    stop0 = solos[1][0]
    got = engine(slots=2, max_new_tokens=5, segment=2, stop_tokens=(stop0,)).generate(prompts)
    assert got == [_trunc(g, stop0) for g in solos] and len(got[1]) == 1

    same = [prompts[0]] * 3
    assert (engine(slots=3, max_new_tokens=4, segment=4).generate(same)
            == [_solo(arch, prompts[0], 4)] * 3)

    many = [mk(n) for n in (2, 7, 4, 8, 3, 5, 6, 1)]
    engq = engine(slots=2, max_new_tokens=3, segment=2)
    assert engq.generate(many) == [_solo(arch, p, 3) for p in many]
    assert engq.last_stats["resets"] == len(many)
    with pytest.raises(ValueError, match="prompt 1 is empty"):
        engq.generate([mk(3), []])


def test_segment_schedule_is_the_device_state():
    """The host's view of a segment (which steps prefill, each slot's write
    span) agrees with the device state it runs: the slots' positions after
    every step lie in the next step's spans, and a step prefills exactly
    when some slot's mode is PREFILL."""
    _, tc, _, tparams = _model("llama3.2-1b")
    B, P, cp = 3, 12, 4
    cache = SV.init_cache(tc, B, 24, "cpu")
    mode = np.array([DL.PREFILL, DL.DECODE, DL.FREE], np.int32)
    pos = np.array([0, 5, 2], np.int32)
    pfill = np.zeros(B, np.int32)
    plen = np.array([9, 1, 1], np.int32)
    pend = torch.randint(0, tc.vocab_size, (B, P), dtype=torch.int32)
    sched = DL.segment_schedule(mode, pos, pfill, plen, num_steps=6, prefill_chunk=cp)
    assert [s[0] for s in sched] == [True, True, True, False, False, False]
    state = [torch.as_tensor(x, dtype=torch.int32) for x in (mode, pos, pfill)]
    tok = torch.zeros((B, 1), dtype=torch.int32)
    rem = torch.full((B,), 10, dtype=torch.int32)
    for any_pf, spans in sched:
        m, p, f = state
        assert any_pf == bool((m == DL.PREFILL).any())
        for i, (lo, hi) in enumerate(spans):
            if m[i] == DL.PREFILL:
                assert (lo, hi) == (int(f[i]), int(min(f[i] + cp, plen[i])) - 1)
            elif not (any_pf and m[i] == DL.FREE):
                assert lo <= int(p[i]) <= hi
        _, _, aux = DL.mixed_segment(tc, None, tparams, cache, m, tok, p, None, rem, f, pend,
                                     torch.from_numpy(plen), schedule=[(any_pf, spans)],
                                     prefill_chunk=cp)
        state, tok, rem = [aux["mode"], aux["pos"], aux["pfill"]], aux["tok"], aux["rem"]
