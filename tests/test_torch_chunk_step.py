"""The port's fused mixed step (``models/serve.py::chunk_step``) and
host-streamed decode KV against the JAX package, on reduced configs in
fp32 with the same (converted) parameters: right-padded prompts streamed
in 4-token chunks (lengths 5 and 9) give the JAX logits and the same
written cache (k, v, kpos) for llama3.2-1b and a windowed ring; the
recurrent state leaves of falcon-mamba-7b and recurrentgemma-9b match JAX
and the port's own exact-length prefill (the state-at-length gather);
granite's MoE branch drops what JAX's drops on the same window; decode
and chunk steps with the KV streamed in 4 slabs match on-device attention
(the port's and JAX's) with the live skip counted; audio is refused."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models import mamba as JM
from repro.models import serve as JSV
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_params
from repro_torch.models import mamba as M
from repro_torch.models import serve as SV

TOL = 2e-4
STATE_TOL = 3e-4  # tests/test_serve_sched.py's state-at-length tolerance
HOST_TOL = 1e-4
LENGTHS = (5, 9)
CP, MAX_LEN = 4, 16
WINDOWED = dict(num_layers=2, block_pattern=("attn", "local_attn"), window=8)

_MODELS = {}


def _model(arch, **over):
    """(JAX config, port config, JAX params, port params, tokens [2, 9]) of
    the reduced ``arch`` in fp32, built once a file."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _MODELS:
        kw = dict(param_dtype="float32", remat="none", **over)
        jc = dataclasses.replace(j_reduced(j_get_config(arch)), **kw)
        tc = dataclasses.replace(reduced(get_config(arch)), **kw)
        jparams = JT.init_params(jc, jax.random.PRNGKey(0))
        tokens = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 9)).astype(np.int32)
        _MODELS[key] = (jc, tc, jparams, from_jax_params(jax.device_get(jparams), "cpu"), tokens)
    return _MODELS[key]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


_CHUNKED = {}


def _chunked(jc, tc, jparams, tparams, tokens, n_host_chunks=0):
    """Stream the right-padded prompts (LENGTHS) in CP-token chunks through
    both packages' ``chunk_step`` (JAX on the device, the port with
    ``n_host_chunks``), once a model and chunk count.  Returns (JAX
    logits, port logits at each row's last real token, JAX cache, port
    cache)."""
    key = (id(tparams), n_host_chunks)
    if key not in _CHUNKED:
        _CHUNKED[key] = _stream(jc, tc, jparams, tparams, tokens, LENGTHS, CP, n_host_chunks)
    return _CHUNKED[key]


def _stream(jc, tc, jparams, tparams, tokens, lengths, cp, n_host_chunks):
    b = tokens.shape[0]
    jcache = JSV.init_cache(jc, b, MAX_LEN)
    tcache = SV.init_cache(tc, b, MAX_LEN, "cpu")
    pfill = np.zeros(b, np.int32)
    plen = np.asarray(lengths, np.int32)
    jlog = np.zeros((b, jc.padded_vocab), np.float32)
    tlog = np.zeros_like(jlog)
    while (pfill < plen).any():
        live = np.clip(plen - pfill, 0, cp).astype(np.int32)
        idx = np.clip(pfill[:, None] + np.arange(cp)[None], 0, tokens.shape[1] - 1)
        chunk = tokens[np.arange(b)[:, None], idx]
        jl, jcache = JSV.chunk_step(jc, None, jparams, jcache, jnp.asarray(chunk),
                                    jnp.asarray(pfill), jnp.asarray(live))
        bounds = [(int(p), int(p + n - 1)) for p, n in zip(pfill, live)]
        tl, tcache = SV.chunk_step(tc, None, tparams, tcache, torch.from_numpy(chunk),
                                   torch.from_numpy(pfill), torch.from_numpy(live),
                                   n_host_chunks=n_host_chunks, bounds=bounds)
        fin = (pfill + live >= plen) & (pfill < plen)
        jlog[fin] = np.asarray(jl)[fin]
        tlog[fin] = tl.numpy()[fin]
        pfill = pfill + live
    return jlog, tlog, jcache, tcache


def _assert_cache(tcache, jcache, tol, names=None):
    jl = dict(_leaves(jax.device_get(jcache)))
    tl = dict(_leaves(tcache))
    assert jl.keys() == tl.keys()
    for name, j in jl.items():
        if names and name.rsplit("/", 1)[1] not in names:
            continue
        t = tl[name]
        assert tuple(t.shape) == j.shape, name
        if name.endswith("kpos"):
            assert t.tolist() == np.asarray(j).tolist(), name
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                                   rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("layout", ["llama", "windowed"])
def test_chunk_step_matches_jax(layout):
    """Logits at each row's last token and the written cache (k, v, kpos,
    untouched slots included) equal JAX's; the windowed ring (8 slots)
    keeps only the last live tokens of the 9-token prompt."""
    jc, tc, jparams, tparams, tokens = _model("llama3.2-1b",
                                              **(WINDOWED if layout == "windowed" else {}))
    jl, tl, jcache, tcache = _chunked(jc, tc, jparams, tparams, tokens)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    _assert_cache(tcache, jcache, TOL)
    if layout == "windowed":  # the ring holds positions 1..8 of row 1, 0..4 of row 0
        ring = tcache["pos1"]["kpos"][0]
        assert sorted(ring[1].tolist()) == list(range(1, 9))
        assert sorted(p for p in ring[0].tolist() if p >= 0) == list(range(5))


def test_chunk_step_matches_masked_prefill():
    """Attention layout: the chunked prefill is the port's position-masked
    whole-prompt prefill (logits, and k at every filled slot)."""
    jc, tc, jparams, tparams, tokens = _model("llama3.2-1b")
    _, tl, _, tcache = _chunked(jc, tc, jparams, tparams, tokens)
    ref, rcache = SV.prefill_step(tc, None, tparams, {"tokens": torch.from_numpy(tokens)},
                                  max_len=MAX_LEN, lengths=torch.tensor(LENGTHS))
    np.testing.assert_allclose(tl, ref.numpy(), rtol=TOL, atol=TOL)
    kp = rcache["pos0"]["kpos"]
    assert torch.equal(kp, tcache["pos0"]["kpos"])
    m = kp >= 0
    torch.testing.assert_close(tcache["pos0"]["k"][m], rcache["pos0"]["k"][m],
                               rtol=1e-5, atol=1e-5)


def _state_leaves(cache, row):
    out = {}
    for key in cache:
        blocks = enumerate(cache["tail"]) if key == "tail" else [(key, cache[key])]
        for bk, blk in blocks:
            for n, v in blk.items():
                if n in ("conv", "ssm", "h"):
                    a = np.asarray(v.float() if isinstance(v, torch.Tensor) else v, np.float32)
                    out[f"{bk}.{n}"] = a[row] if key == "tail" else a[:, row]
    return out


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_recurrent_state_at_length(arch):
    """The recurrent states after a partial final chunk are the states at
    the true length: against JAX's chunk_step, and against the port's own
    exact-length prefill of each row (which refuses padded prompts)."""
    jc, tc, jparams, tparams, tokens = _model(arch)
    jl, tl, jcache, tcache = _chunked(jc, tc, jparams, tparams, tokens)
    np.testing.assert_allclose(tl, jl, rtol=STATE_TOL, atol=STATE_TOL)
    _assert_cache(tcache, jcache, STATE_TOL, names=("conv", "ssm", "h"))
    for i, n in enumerate(LENGTHS):
        ref, rcache = SV.prefill_step(tc, None, tparams,
                                      {"tokens": torch.from_numpy(tokens[i:i + 1, :n])},
                                      max_len=MAX_LEN)
        np.testing.assert_allclose(tl[i], ref.numpy()[0], rtol=STATE_TOL, atol=STATE_TOL)
        got, want = _state_leaves(tcache, i), _state_leaves(rcache, 0)
        assert got.keys() == want.keys() and want
        for leaf in want:
            np.testing.assert_allclose(got[leaf], want[leaf], rtol=STATE_TOL, atol=STATE_TOL,
                                       err_msg=f"row {i} {leaf}")


def test_conv_state_at_matches_jax():
    """The gather of the conv carry at each row's length, live 0 included."""
    xp = np.random.default_rng(2).standard_normal((3, 3 + 4, 5)).astype(np.float32)
    live = np.array([0, 2, 4], np.int32)
    got = M._conv_state_at(torch.from_numpy(xp), torch.from_numpy(live), 4)
    want = JM._conv_state_at(jnp.asarray(xp), jnp.asarray(live), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[0].numpy(), xp[0, :3])


def test_granite_moe_chunk_matches_jax():
    """The MoE branch routes the whole [b, cp] window (pads and idle rows
    take queue places as in JAX), so on the same batch the logits and the
    written cache equal JAX's, drops included."""
    jc, tc, jparams, tparams, tokens = _model("granite-moe-1b-a400m")
    jl, tl, jcache, tcache = _chunked(jc, tc, jparams, tparams, tokens)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    _assert_cache(tcache, jcache, TOL)


def test_write_rows_has_no_colliding_writes():
    """A window wider than the buffer goes in passes: the last live column
    of each slot wins, dead columns leave their slot as it was."""
    buf = torch.full((1, 4), -1, dtype=torch.int32)
    slot = torch.arange(10)[None] % 4
    val = torch.arange(10, dtype=torch.int32)[None]
    mask = torch.arange(10)[None] < 7
    SV._write_rows(buf, 0, slot, val, mask)
    assert buf.tolist() == [[4, 5, 6, 3]]


@pytest.mark.parametrize("layout", ["llama", "windowed"])
def test_host_streamed_chunks_match_on_device(layout):
    """chunk_step with the full-attention KV streamed in 4 slabs (the
    offload is the identity on the CPU; the slab loop, the live skip and
    the write-back run) equals JAX's on-device chunk_step at 1e-4, logits
    and cache; slabs past every row's position are skipped."""
    jc, tc, jparams, tparams, tokens = _model(
        "llama3.2-1b", **(WINDOWED if layout == "windowed" else {}))
    SV.reset_host_kv()
    jl, tl, jcache, tcache = _stream(jc, tc, jparams, tparams, tokens, LENGTHS, CP, 4)
    np.testing.assert_allclose(tl, jl, rtol=HOST_TOL, atol=HOST_TOL)
    _assert_cache(tcache, jcache, HOST_TOL)
    # slabs of 4 positions; the chunks' highest live positions 3, 7, 8
    # -> 1, 2 and 3 of the 4 slabs live in each full-attention layer
    n_full = sum(k == "attn" for k in tc.layer_kinds())
    assert SV.host_kv == {"fetched": 6 * n_full, "skipped": 6 * n_full}


def test_host_streamed_decode_matches_on_device():
    """decode_tokens with the KV in 4 slabs (after offload_kv) gives the
    tokens and logits of on-device decode, the port's and JAX's, at 1e-4,
    and merges only the slabs up to each step's highest position."""
    from repro.runtime import decode_loop as JDL
    from repro_torch.runtime import decode_loop as DL

    jc, tc, jparams, tparams, tokens = _model("llama3.2-1b")
    S, steps = 32, 8
    jl, jcache = JSV.prefill_step(jc, None, jparams, {"tokens": jnp.asarray(tokens)},
                                  max_len=S)
    jtok0 = JDL.sample_token(jl[:, : jc.vocab_size], None)
    jtoks, jaux = JDL.decode_tokens(jc, None, jparams, jcache, jtok0[:, None],
                                    jnp.full((2,), 9, jnp.int32), num_steps=steps,
                                    collect_logits=True)
    runs = {}
    for n in (0, 4):
        tl, tcache = SV.prefill_step(tc, None, tparams, {"tokens": torch.from_numpy(tokens)},
                                     max_len=S)
        if n:
            SV.offload_kv(tc, tcache, "cpu")
        SV.reset_host_kv()
        tok0 = torch.argmax(tl[:, : tc.vocab_size], dim=-1).to(torch.int32)
        runs[n] = DL.decode_tokens(tc, None, tparams, tcache, tok0[:, None], 9,
                                   num_steps=steps, n_host_chunks=n, collect_logits=True)
        runs[n] = runs[n] + (dict(SV.host_kv),)
    (t0, a0, c0), (t4, a4, c4) = runs[0], runs[4]
    assert t4.tolist() == t0.tolist() == np.asarray(jtoks).tolist()
    np.testing.assert_allclose(a4["logits"].numpy(), a0["logits"].numpy(),
                               rtol=HOST_TOL, atol=HOST_TOL)
    np.testing.assert_allclose(a4["logits"].numpy(), np.asarray(jaux["logits"]),
                               rtol=HOST_TOL, atol=HOST_TOL)
    _assert_cache(a4["cache"], jaux["cache"], HOST_TOL)
    # positions 9..16, slabs of 8: steps 0-6 merge slabs 0-1, step 7 slabs 0-2
    n_full = sum(k == "attn" for k in tc.layer_kinds())
    assert c4 == {"fetched": (7 * 2 + 3) * n_full, "skipped": (7 * 2 + 1) * n_full}
    assert c0 == {"fetched": 0, "skipped": 0}


def test_host_streamed_cache_must_divide():
    """A host cache whose length the chunk count does not divide is refused
    (it cannot be attended on the device); on the CPU a device cache just
    attends whole, as in the JAX package."""
    _, tc, _, tparams, tokens = _model("llama3.2-1b")
    _, cache = SV.prefill_step(tc, None, tparams, {"tokens": torch.from_numpy(tokens)},
                               max_len=MAX_LEN)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    SV.reset_host_kv()
    SV.decode_step(tc, None, tparams, cache, {"tokens": tok}, 9, n_host_chunks=3)
    assert SV.host_kv == {"fetched": 0, "skipped": 0}
    assert not SV._streams({"k": torch.zeros(1, 16)}, 3, 0, "cpu")
    with pytest.raises(ValueError, match="does not stream"):
        SV._streams({"k": torch.zeros(1, 16)}, 3, 0, "meta")


def test_chunk_step_refuses_audio():
    _, tc, _, tparams, _ = _model("llama3.2-1b")
    audio = dataclasses.replace(tc, frontend="audio_frames")
    with pytest.raises(ValueError, match="chunk_step feeds token ids"):
        SV.chunk_step(audio, None, tparams, {}, torch.zeros((1, 4), dtype=torch.int32), 0, 4)
    jc = _model("llama3.2-1b")[0]
    with pytest.raises(ValueError, match="chunk_step feeds token ids"):
        JSV.chunk_step(dataclasses.replace(jc, frontend="audio_frames"), None, {}, {},
                       jnp.zeros((1, 4), jnp.int32), 0, 4)
