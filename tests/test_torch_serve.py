"""The port's serve slice against the JAX package's on reduced(llama3.2-1b)
with the same (converted) parameters and prompts: prefill logits and cache
at u in {1, 4}, position-masked prefill, greedy decode over 8 steps (tokens
and per-step logits), and the CLI on the CPU.  The same for the reduced
recurrent archs, recurrentgemma-9b (RG-LRU and a local_attn ring) and
falcon-mamba-7b (Mamba-1): prefill logits and every cache leaf (conv, h,
ssm, k, v, kpos), greedy tokens, per-step logits and the cache after
decode, bf16 prefill, and the CLI."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models import serve as JSV
from repro.models import transformer as JT
from repro.runtime import decode_loop as JDL
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve as CLI
from repro_torch.models import serve as SV
from repro_torch.models import transformer as T
from repro_torch.runtime import decode_loop as DL

B, S, MAX_LEN = 2, 16, 32
TOL = 2e-4
# the recurrent archs: RG-LRU + local attention, and Mamba-1
RECURRENT = ["recurrentgemma-9b", "falcon-mamba-7b"]


def _cfgs(u=1, dtype="float32"):
    kw = dict(param_dtype=dtype, remat="none", fpdt_chunks=u)
    return (dataclasses.replace(j_reduced(j_get_config("llama3.2-1b")), **kw),
            dataclasses.replace(reduced(get_config("llama3.2-1b")), **kw))


@pytest.fixture(scope="module")
def model():
    jc, _ = _cfgs()
    jparams = JT.init_params(jc, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(11).integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    return jparams, from_jax_params(jax.device_get(jparams), "cpu"), tokens


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_cache(tcache, jcache, tol):
    jl = dict(_leaves(jax.device_get(jcache)))
    tl = dict(_leaves(tcache))
    assert jl.keys() == tl.keys()
    for name, j in jl.items():
        t = tl[name]
        assert tuple(t.shape) == j.shape, name
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                                   rtol=tol, atol=tol, err_msg=name)


def test_param_tree_matches_jax(model):
    jparams, _, _ = model
    _, tc = _cfgs()
    mine = T.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    jl = {k: v.shape for k, v in _leaves(jax.device_get(jparams))}
    tl = {k: tuple(v.shape) for k, v in _leaves(mine)}
    assert jl == tl


@pytest.mark.parametrize("u", [1, 4])
def test_prefill_matches_jax(model, u):
    jparams, tparams, tokens = model
    jc, tc = _cfgs(u)
    jl, jcache = JSV.prefill_step(jc, None, jparams, {"tokens": jnp.asarray(tokens)},
                                  max_len=MAX_LEN)
    tl, tcache = SV.prefill_step(tc, None, tparams, {"tokens": torch.from_numpy(tokens)},
                                 max_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    _assert_cache(tcache, jcache, TOL)


def test_position_masked_prefill_matches_jax(model):
    jparams, tparams, tokens = model
    jc, tc = _cfgs(4)
    lengths = np.array([S, 11], np.int32)
    jl, jcache = JSV.prefill_step(jc, None, jparams, {"tokens": jnp.asarray(tokens)},
                                  max_len=MAX_LEN, lengths=jnp.asarray(lengths))
    tl, tcache = SV.prefill_step(tc, None, tparams, {"tokens": torch.from_numpy(tokens)},
                                 max_len=MAX_LEN, lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    _assert_cache(tcache, jcache, TOL)


def test_greedy_decode_matches_jax(model):
    jparams, tparams, tokens = model
    jc, tc = _cfgs()
    steps = 8
    jl, jcache = JSV.prefill_step(jc, None, jparams, {"tokens": jnp.asarray(tokens)},
                                  max_len=MAX_LEN)
    jtok0 = JDL.sample_token(jl[:, : jc.vocab_size], None)
    jtoks, jaux = JDL.decode_tokens(jc, None, jparams, jcache, jtok0[:, None],
                                    jnp.full((B,), S, jnp.int32), num_steps=steps,
                                    collect_logits=True)
    tl, tcache = SV.prefill_step(tc, None, tparams, {"tokens": torch.from_numpy(tokens)},
                                 max_len=MAX_LEN)
    ttok0 = DL.sample_token(tl[:, : tc.vocab_size], None)
    ttoks, taux = DL.decode_tokens(tc, None, tparams, tcache, ttok0[:, None],
                                   torch.full((B,), S, dtype=torch.int32), num_steps=steps,
                                   collect_logits=True)
    assert ttok0.tolist() == np.asarray(jtok0).tolist()
    assert ttoks.tolist() == np.asarray(jtoks).tolist()
    np.testing.assert_allclose(taux["logits"].numpy(), np.asarray(jaux["logits"]),
                               rtol=TOL, atol=TOL)
    assert taux["pos"].tolist() == np.asarray(jaux["pos"]).tolist()
    _assert_cache(taux["cache"], jaux["cache"], TOL)


def test_decode_stops_and_budgets(model):
    """Per-row stop tokens and budgets follow the JAX carry contract."""
    jparams, tparams, tokens = model
    jc, tc = _cfgs()
    jl, jcache = JSV.prefill_step(jc, None, jparams, {"tokens": jnp.asarray(tokens)},
                                  max_len=MAX_LEN)
    tl, tcache = SV.prefill_step(tc, None, tparams, {"tokens": torch.from_numpy(tokens)},
                                 max_len=MAX_LEN)
    tok0 = np.array(JDL.sample_token(jl[:, : jc.vocab_size], None))
    free, _ = JDL.decode_tokens(jc, None, jparams, jcache, jnp.asarray(tok0)[:, None],
                                jnp.full((B,), S, jnp.int32), num_steps=6)
    stop = int(np.asarray(free)[0, 2])  # row 0 stops on its third emission
    kw = dict(num_steps=6, stop_tokens=(stop,), pad_id=-1)
    jtoks, jaux = JDL.decode_tokens(jc, None, jparams, jcache, jnp.asarray(tok0)[:, None],
                                    jnp.full((B,), S, jnp.int32),
                                    remaining=jnp.asarray([6, 4], jnp.int32), **kw)
    ttoks, taux = DL.decode_tokens(tc, None, tparams, tcache, torch.from_numpy(tok0)[:, None],
                                   torch.full((B,), S, dtype=torch.int32),
                                   remaining=torch.tensor([6, 4], dtype=torch.int32), **kw)
    assert ttoks.tolist() == np.asarray(jtoks).tolist()
    for key in ("pos", "done", "remaining"):
        assert taux[key].tolist() == np.asarray(jaux[key]).tolist(), key


def test_bf16_prefill_close_to_jax(model):
    jparams, _, tokens = model
    jc, tc = _cfgs(4, "bfloat16")
    jp16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    jl, _ = JSV.prefill_step(jc, None, jp16, {"tokens": jnp.asarray(tokens)}, max_len=MAX_LEN)
    tl, _ = SV.prefill_step(tc, None, from_jax_params(jax.device_get(jp16), "cpu"),
                            {"tokens": torch.from_numpy(tokens)}, max_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=3e-2, atol=3e-2)


def test_sampling_respects_top_k():
    logits = torch.tensor([[0.0, 5.0, 4.0, -1.0, 3.0]] * 64)
    gen = torch.Generator().manual_seed(0)
    ids = DL.sample_token(logits, gen, DL.SamplingConfig(temperature=1.0, top_k=2))
    assert set(ids.tolist()) <= {1, 2} and len(set(ids.tolist())) == 2
    assert DL.sample_token(logits, None).tolist() == [1] * 64


def test_cli_on_cpu(capsys):
    out = CLI.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "16", "--gen", "4"])
    text = capsys.readouterr().out
    assert out["tokens"].shape == (2, 4)
    timed = [ln for ln in text.splitlines() if " ms" in ln]
    assert len(timed) == 2 and all(ln.endswith("on cpu") for ln in timed)


@pytest.mark.parametrize("flag", [["--engine", "--paged", "--host-kv-chunks", "4"],
                                  ["--engine", "--mesh", "1x2", "--host-kv-chunks", "4"],
                                  ["--engine", "--paged", "--mesh", "2x1", "--replicas", "2",
                                   "--host-kv-chunks", "2"]])
def test_cli_refuses_unported(capsys, flag):
    with pytest.raises(SystemExit) as ex:
        CLI.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", *flag])
    assert ex.value.code == 2
    assert "not yet ported" in capsys.readouterr().err


_ENGINE_OUTS = {}  # the first mode's tokens, which every other mode must give
ENGINE_ARGV = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "16", "--gen",
               "4", "--requests", "5", "--segment", "2", "--prefill-chunk", "4"]


@pytest.mark.parametrize("mode", [[], ["--blocking"], ["--host-kv-chunks", "4"],
                                  ["--blocking", "--host-kv-chunks", "4"]])
def test_cli_engine_on_cpu(capsys, mode):
    """--engine (fused, blocking, with host-streamed KV): every request gets
    its --gen tokens (no stop token), the same tokens in every mode, and
    the summary and dispatch lines name the CPU."""
    run = CLI.main(["--arch", "llama3.2-1b", "--engine", *ENGINE_ARGV, *mode])
    text = capsys.readouterr().out
    prompts, lens = CLI.engine_prompts(run["engine"].cfg, 5, 16)
    assert [len(p) for p in prompts] == lens.tolist() and 4 <= min(lens) <= max(lens) <= 16
    assert [len(o) for o in run["outs"]] == [4] * 5
    _ENGINE_OUTS.setdefault(run["engine"].cfg.name, run["outs"])
    assert run["outs"] == _ENGINE_OUTS[run["engine"].cfg.name]  # every mode, the same tokens
    timed = [ln for ln in text.splitlines() if " ms" in ln]
    assert len(timed) == 2 and all(ln.endswith("on cpu") for ln in timed)
    assert "steady p50" in timed[1] and "refill-active p95" in timed[1]


def test_cli_host_kv_without_engine(capsys):
    """--host-kv-chunks on the one-batch path: the tokens of on-device
    decode, slabs counted; a count that does not divide prompt + gen exits 2."""
    argv = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "16", "--gen", "4"]
    out = CLI.main([*argv, "--host-kv-chunks", "4"])
    text = capsys.readouterr().out
    assert out["tokens"].tolist() == CLI.main(argv)["tokens"].tolist()
    assert "host KV: 4 slabs of 5 positions" in text
    with pytest.raises(SystemExit) as ex:
        CLI.main([*argv, "--host-kv-chunks", "3"])
    assert ex.value.code == 2


@pytest.mark.parametrize("arch", RECURRENT)
def test_cli_engine_recurrent_arch_on_cpu(capsys, arch):
    run = CLI.main(["--arch", arch, "--engine", *ENGINE_ARGV])
    assert [len(o) for o in run["outs"]] == [4] * 5
    assert capsys.readouterr().out.splitlines()[0].endswith("on cpu")


def test_cli_engine_telemetry(tmp_path, capsys):
    """--trace-out / --metrics-out: a Chrome trace holding each request's
    admit, emit and complete events, and the Prometheus series; both need
    --engine."""
    import json

    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    CLI.main(["--arch", "llama3.2-1b", "--engine", *ENGINE_ARGV, "--trace-out", str(trace),
              "--metrics-out", str(prom)])
    names = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]]
    assert names.count("request.admit") == names.count("request.complete") == 5
    assert names.count("request.emit") >= 5
    assert "dispatch_ms" in prom.read_text()
    with pytest.raises(SystemExit) as ex:
        CLI.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--trace-out",
                  str(trace)])
    assert ex.value.code == 2


@pytest.mark.parametrize("arch", RECURRENT)
def test_cli_serves_recurrent_arch_on_cpu(capsys, arch):
    """The recurrent archs serve through the CLI: exit 0, the tokens asked
    for, both timed lines naming the CPU."""
    out = CLI.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "16", "--gen", "4"])
    text = capsys.readouterr().out
    assert out["tokens"].shape == (2, 4)
    assert int(out["tokens"].min()) >= 0 and int(out["tokens"].max()) < 256
    timed = [ln for ln in text.splitlines() if " ms" in ln]
    assert len(timed) == 2 and all(ln.endswith("on cpu") for ln in timed)


def test_windowed_layout_matches_jax():
    """An (attn, local_attn) cycle: the ring cache keeps slot = pos % window
    through prefill and decode, as the JAX package does."""
    kw = dict(param_dtype="float32", remat="none", fpdt_chunks=4, num_layers=2,
              block_pattern=("attn", "local_attn"), window=8)
    jc = dataclasses.replace(j_reduced(j_get_config("llama3.2-1b")), **kw)
    tc = dataclasses.replace(reduced(get_config("llama3.2-1b")), **kw)
    jparams = JT.init_params(jc, jax.random.PRNGKey(5))
    tparams = from_jax_params(jax.device_get(jparams), "cpu")
    tokens = np.random.default_rng(3).integers(0, jc.vocab_size, (B, 20)).astype(np.int32)
    jl, jcache = JSV.prefill_step(jc, None, jparams, {"tokens": jnp.asarray(tokens)},
                                  max_len=MAX_LEN)
    tl, tcache = SV.prefill_step(tc, None, tparams, {"tokens": torch.from_numpy(tokens)},
                                 max_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    _assert_cache(tcache, jcache, TOL)
    jtok0 = JDL.sample_token(jl[:, : jc.vocab_size], None)
    jtoks, jaux = JDL.decode_tokens(jc, None, jparams, jcache, jtok0[:, None],
                                    jnp.full((B,), 20, jnp.int32), num_steps=6)
    ttoks, taux = DL.decode_tokens(tc, None, tparams, tcache,
                                   DL.sample_token(tl[:, : tc.vocab_size], None)[:, None],
                                   torch.full((B,), 20, dtype=torch.int32), num_steps=6)
    assert ttoks.tolist() == np.asarray(jtoks).tolist()
    _assert_cache(taux["cache"], jaux["cache"], TOL)
    with pytest.raises(ValueError, match="global-attention"):
        SV.prefill_step(tc, None, tparams, {"tokens": torch.from_numpy(tokens)},
                        max_len=MAX_LEN, lengths=torch.tensor([20, 12]))


_RECURRENT_MODELS = {}


def _recurrent(arch, dtype="float32"):
    """(JAX config, port config, JAX params, port params, prompts) of the
    reduced ``arch`` at u = 4; 20-token prompts wrap the hybrid's 8-slot
    local_attn ring."""
    if (arch, dtype) not in _RECURRENT_MODELS:
        kw = dict(param_dtype=dtype, remat="none", fpdt_chunks=4)
        jc = dataclasses.replace(j_reduced(j_get_config(arch)), **kw)
        tc = dataclasses.replace(reduced(get_config(arch)), **kw)
        jparams = JT.init_params(jc, jax.random.PRNGKey(7))
        tokens = np.random.default_rng(13).integers(0, jc.vocab_size, (B, 20)).astype(np.int32)
        _RECURRENT_MODELS[arch, dtype] = (jc, tc, jparams,
                                          from_jax_params(jax.device_get(jparams), "cpu"), tokens)
    return _RECURRENT_MODELS[arch, dtype]


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_param_tree_matches_jax(arch):
    jc, tc, jparams, _, _ = _recurrent(arch)
    mine = T.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    jl = {k: (v.shape, str(v.dtype)) for k, v in _leaves(jax.device_get(jparams))}
    tl = {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in _leaves(mine)}
    assert jl == tl


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_prefill_matches_jax(arch):
    """Logits and every cache leaf; the recurrent states in the dtypes the
    JAX cache has (conv in the parameter dtype, h and ssm fp32)."""
    jc, tc, jparams, tparams, tokens = _recurrent(arch)
    jl, jcache = JSV.prefill_step(jc, None, jparams, {"tokens": jnp.asarray(tokens)},
                                  max_len=MAX_LEN)
    tl, tcache = SV.prefill_step(tc, None, tparams, {"tokens": torch.from_numpy(tokens)},
                                 max_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    _assert_cache(tcache, jcache, TOL)
    names = {name.rsplit("/", 1)[1] for name, _ in _leaves(tcache)}
    assert names == ({"conv", "h", "k", "v", "kpos"} if arch == RECURRENT[0]
                     else {"conv", "ssm"})
    jdt = {name: str(v.dtype) for name, v in _leaves(jax.device_get(jcache))}
    assert {name: str(v.dtype).split(".")[-1] for name, v in _leaves(tcache)} == jdt


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_greedy_decode_matches_jax(arch):
    """8 greedy steps: tokens, per-step logits, positions and the cache
    after them; the cache dict comes back as the same object, written in
    place."""
    jc, tc, jparams, tparams, tokens = _recurrent(arch)
    steps, s = 8, tokens.shape[1]
    jl, jcache = JSV.prefill_step(jc, None, jparams, {"tokens": jnp.asarray(tokens)},
                                  max_len=MAX_LEN)
    jtok0 = JDL.sample_token(jl[:, : jc.vocab_size], None)
    jtoks, jaux = JDL.decode_tokens(jc, None, jparams, jcache, jtok0[:, None],
                                    jnp.full((B,), s, jnp.int32), num_steps=steps,
                                    collect_logits=True)
    tl, tcache = SV.prefill_step(tc, None, tparams, {"tokens": torch.from_numpy(tokens)},
                                 max_len=MAX_LEN)
    ttok0 = DL.sample_token(tl[:, : tc.vocab_size], None)
    ttoks, taux = DL.decode_tokens(tc, None, tparams, tcache, ttok0[:, None],
                                   torch.full((B,), s, dtype=torch.int32), num_steps=steps,
                                   collect_logits=True)
    assert ttok0.tolist() == np.asarray(jtok0).tolist()
    assert ttoks.tolist() == np.asarray(jtoks).tolist()
    np.testing.assert_allclose(taux["logits"].numpy(), np.asarray(jaux["logits"]),
                               rtol=TOL, atol=TOL)
    assert taux["pos"].tolist() == np.asarray(jaux["pos"]).tolist()
    assert taux["cache"] is tcache
    _assert_cache(taux["cache"], jaux["cache"], TOL)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_bf16_prefill_close_to_jax(arch):
    """bf16 logits within 3e-2 of the largest logit: the two packages round
    the bf16 conv, silu and gates at different steps, and each rounding is
    2^-8 of its value (held, like the mixers' bf16 tests, relative to the
    largest magnitude rather than elementwise)."""
    jc, tc, jparams, tparams, tokens = _recurrent(arch, "bfloat16")
    jl, _ = JSV.prefill_step(jc, None, jparams, {"tokens": jnp.asarray(tokens)},
                             max_len=MAX_LEN)
    tl, _ = SV.prefill_step(tc, None, tparams, {"tokens": torch.from_numpy(tokens)},
                            max_len=MAX_LEN)
    jl = np.asarray(jl)
    assert np.abs(tl.numpy() - jl).max() <= 3e-2 * np.abs(jl).max()


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_position_masked_prefill_refused(arch):
    """A recurrent state integrates pad tokens: both packages refuse
    ``lengths=...`` for these layouts."""
    jc, tc, jparams, tparams, tokens = _recurrent(arch)
    lengths = np.array([20, 12], np.int32)
    with pytest.raises(ValueError, match="global-attention"):
        JSV.prefill_step(jc, None, jparams, {"tokens": jnp.asarray(tokens)},
                         max_len=MAX_LEN, lengths=jnp.asarray(lengths))
    with pytest.raises(ValueError, match="global-attention"):
        SV.prefill_step(tc, None, tparams, {"tokens": torch.from_numpy(tokens)},
                        max_len=MAX_LEN, lengths=torch.from_numpy(lengths))


# granite-moe-1b-a400m: the attention blocks' MoE FFN, chunked in prefill
# (mlp_chunks 2: two chunks of 8 tokens x 2 rows, one group each) and one
# group of the b tokens in decode
GRANITE = "granite-moe-1b-a400m"


def _granite_cfgs(u=1, dtype="float32"):
    kw = dict(param_dtype=dtype, remat="none", fpdt_chunks=u, mlp_chunks=2)
    return (dataclasses.replace(j_reduced(j_get_config(GRANITE)), **kw),
            dataclasses.replace(reduced(get_config(GRANITE)), **kw))


@pytest.fixture(scope="module")
def granite():
    jc, _ = _granite_cfgs()
    jparams = JT.init_params(jc, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(12).integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    return jparams, from_jax_params(jax.device_get(jparams), "cpu"), tokens


def test_granite_param_tree_matches_jax(granite):
    jparams, _, _ = granite
    _, tc = _granite_cfgs()
    mine = T.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    jl = {k: (v.shape, str(v.dtype)) for k, v in _leaves(jax.device_get(jparams))}
    tl = {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in _leaves(mine)}
    assert jl == tl and "/cycles/pos0/moe/router" in tl


@pytest.mark.parametrize("u", [1, 4])
def test_granite_prefill_matches_jax(granite, u):
    jparams, tparams, tokens = granite
    jc, tc = _granite_cfgs(u)
    jl, jcache = JSV.prefill_step(jc, None, jparams, {"tokens": jnp.asarray(tokens)},
                                  max_len=MAX_LEN)
    tl, tcache = SV.prefill_step(tc, None, tparams, {"tokens": torch.from_numpy(tokens)},
                                 max_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    _assert_cache(tcache, jcache, TOL)


def test_granite_position_masked_prefill_matches_jax(granite):
    """Right-padded row 1: its pad tokens route and take queue places, as
    in the JAX package."""
    jparams, tparams, tokens = granite
    jc, tc = _granite_cfgs(4)
    lengths = np.array([S, 11], np.int32)
    jl, jcache = JSV.prefill_step(jc, None, jparams, {"tokens": jnp.asarray(tokens)},
                                  max_len=MAX_LEN, lengths=jnp.asarray(lengths))
    tl, tcache = SV.prefill_step(tc, None, tparams, {"tokens": torch.from_numpy(tokens)},
                                 max_len=MAX_LEN, lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    _assert_cache(tcache, jcache, TOL)


def test_granite_greedy_decode_matches_jax(granite):
    jparams, tparams, tokens = granite
    jc, tc = _granite_cfgs()
    steps = 8
    jl, jcache = JSV.prefill_step(jc, None, jparams, {"tokens": jnp.asarray(tokens)},
                                  max_len=MAX_LEN)
    jtok0 = JDL.sample_token(jl[:, : jc.vocab_size], None)
    jtoks, jaux = JDL.decode_tokens(jc, None, jparams, jcache, jtok0[:, None],
                                    jnp.full((B,), S, jnp.int32), num_steps=steps,
                                    collect_logits=True)
    tl, tcache = SV.prefill_step(tc, None, tparams, {"tokens": torch.from_numpy(tokens)},
                                 max_len=MAX_LEN)
    ttok0 = DL.sample_token(tl[:, : tc.vocab_size], None)
    ttoks, taux = DL.decode_tokens(tc, None, tparams, tcache, ttok0[:, None],
                                   torch.full((B,), S, dtype=torch.int32), num_steps=steps,
                                   collect_logits=True)
    assert ttok0.tolist() == np.asarray(jtok0).tolist()
    assert ttoks.tolist() == np.asarray(jtoks).tolist()
    np.testing.assert_allclose(taux["logits"].numpy(), np.asarray(jaux["logits"]),
                               rtol=TOL, atol=TOL)
    _assert_cache(taux["cache"], jaux["cache"], TOL)


def test_granite_bf16_prefill_close_to_jax():
    """bf16 weights with the router in fp32, from each package's own init
    converted: the JAX tree's."""
    jc, tc = _granite_cfgs(4, "bfloat16")
    jp16 = JT.init_params(jc, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(12).integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    jl, _ = JSV.prefill_step(jc, None, jp16, {"tokens": jnp.asarray(tokens)}, max_len=MAX_LEN)
    tl, _ = SV.prefill_step(tc, None, from_jax_params(jax.device_get(jp16), "cpu"),
                            {"tokens": torch.from_numpy(tokens)}, max_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=3e-2, atol=3e-2)


def test_granite_cli_on_cpu(capsys):
    out = CLI.main(["--arch", GRANITE, "--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "16", "--gen", "4"])
    assert tuple(out["tokens"].shape) == (2, 4)
    assert "on cpu" in capsys.readouterr().out
