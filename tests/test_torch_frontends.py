"""The port's modality frontends against the JAX package's, on the reduced
configs with the same (converted) parameters and inputs: musicgen-medium
(audio frames: frame embeddings plus the sinusoidal table, no token table)
and internvl2-2b (vision patches put before the tokens, no loss on them).

Each: the pipeline's batches bit for bit, the parameter tree, prefill
logits and every cache leaf at u in {1, 4} (vision also position-masked),
decode (musicgen's ``decode_step`` on frame embeddings, several steps;
internvl's greedy ``decode_tokens``), the loss and every gradient leaf
under remat full at u in {1, 4}, and the serve CLI on the CPU.  Besides:
``sinusoidal_pos_emb`` at 1e-6, ``decode_tokens`` refusing audio as the
JAX loop does, ``--per-token``, a vision prompt no longer than its patches
refused, the checkpoint read back through the JAX manager (musicgen's
without an embed key), and the three plain dense configs (qwen1.5-4b with
its qkv bias, mistral-nemo-12b, yi-34b) field for field with their loss
and gradients.

The JAX side runs attention as ``xla_flash`` with host offload off, as
tests/test_torch_train.py does.  Tolerances: logits 2e-4 (the FPDT
tolerance of tests/test_torch_serve.py), loss 2e-4 and every gradient leaf
5e-4 of its largest magnitude (tests/test_fpdt.py)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import ShapeConfig as JShape, get_config as j_get_config, reduced as j_reduced
from repro.core.parallel import ParallelContext as JPar
from repro.data.pipeline import make_batch_fn as j_make_batch_fn
from repro.models import layers as JL
from repro.models import serve as JSV
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.runtime import decode_loop as JDL
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.convert import from_jax_params
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.launch import serve as CLI
from repro_torch.models import layers as L
from repro_torch.models import serve as SV
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.runtime import decode_loop as DL
from repro_torch.runtime import train_loop as TL
from repro_torch.tree import tree_leaves

AUDIO, VISION = "musicgen-medium", "internvl2-2b"
FRONTENDS = [AUDIO, VISION]
B, S, MAX_LEN = 2, 16, 32  # S positions: internvl's 4 patches and 12 tokens
TOL, LOSS_TOL, GRAD_TOL = 2e-4, 2e-4, 5e-4
JPAR = JPar(mesh=None, attn_impl="xla_flash", offload_to_host=False)
_MODELS = {}


def _cfgs(arch, **kw):
    kw = dict(param_dtype="float32", **kw)
    return (dataclasses.replace(j_reduced(j_get_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


def _model(arch):
    """(JAX params, port params, the pipeline's batch 0 at B x S)."""
    if arch not in _MODELS:
        jc, _ = _cfgs(arch)
        jparams = JT.init_params(jc, jax.random.PRNGKey(0))
        batch = j_make_batch_fn(jc, JShape("t", S, B, "train"))(0)
        _MODELS[arch] = (jparams, from_jax_params(jax.device_get(jparams), "cpu"), batch)
    return _MODELS[arch]


def _prompt(batch):
    """The batch's inputs, without labels, for JAX and for the port."""
    inp = {k: v for k, v in batch.items() if k != "labels"}
    return ({k: jnp.asarray(v) for k, v in inp.items()},
            {k: torch.from_numpy(v) for k, v in inp.items()})


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_cache(tcache, jcache):
    jl = dict(_leaves(jax.device_get(jcache)))
    tl = dict(_leaves(tcache))
    assert jl.keys() == tl.keys()
    for name, j in jl.items():
        np.testing.assert_allclose(tl[name].float().numpy(), np.asarray(j, np.float32),
                                   rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_batches_match_jax_bit_for_bit(arch):
    jc, tc = _cfgs(arch)
    for shape in ((S, B), (24, 3)):
        want = j_make_batch_fn(jc, JShape("t", *shape, "train"))
        got = make_batch_fn(tc, ShapeConfig("t", *shape, "train"))
        for step in (0, 5):
            w, g = want(step), got(step)
            assert w.keys() == g.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), (shape, step, k)
    keys = {AUDIO: {"frame_embeds", "labels"}, VISION: {"patch_embeds", "tokens", "labels"}}
    assert set(got(0)) == keys[arch]


@pytest.mark.parametrize("arch", FRONTENDS)
def test_param_tree_matches_jax(arch):
    jparams, _, _ = _model(arch)
    _, tc = _cfgs(arch)
    mine = T.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    jl = {k: (v.shape, str(v.dtype)) for k, v in _leaves(jax.device_get(jparams))}
    tl = {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in _leaves(mine)}
    assert jl == tl
    assert ("/embed" in tl) == (arch == VISION)


def test_sinusoidal_pos_emb_matches_jax():
    """1e-6 at the first positions.  Far out the angle pos / 10000^(i/d)
    carries the fp32 power's last-bit difference between XLA and PyTorch
    (neither is correctly rounded; they differ by one ulp in 13 of d 1536's
    768 frequencies) times the position: there the bound is two ulps of
    the frequency times the position."""
    cases = ((16, 64, 0, 1e-6), (16, 1536, 0, 1e-6), (7, 1536, 8185, 8192 * 2**-22))
    for s, d, off, tol in cases:
        want = np.asarray(JL.sinusoidal_pos_emb(s, d, off))
        np.testing.assert_allclose(L.sinusoidal_pos_emb(s, d, off).numpy(), want, rtol=0,
                                   atol=tol)
        pos = torch.arange(off, off + s).reshape(1, s).expand(2, s)
        np.testing.assert_allclose(L.sinusoidal_pos_emb(pos, d).numpy(), np.stack([want] * 2),
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("u", [1, 4])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_prefill_matches_jax(arch, u):
    jparams, tparams, batch = _model(arch)
    jc, tc = _cfgs(arch, remat="none", fpdt_chunks=u)
    jin, tin = _prompt(batch)
    jl, jcache = JSV.prefill_step(jc, None, jparams, jin, max_len=MAX_LEN)
    tl, tcache = SV.prefill_step(tc, None, tparams, tin, max_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    _assert_cache(tcache, jcache)


def test_vision_position_masked_prefill_matches_jax():
    """Row 1 right-padded to 11 positions: 4 patches and 7 tokens."""
    jparams, tparams, batch = _model(VISION)
    jc, tc = _cfgs(VISION, remat="none", fpdt_chunks=4)
    jin, tin = _prompt(batch)
    lengths = np.array([S, 11], np.int32)
    jl, jcache = JSV.prefill_step(jc, None, jparams, jin, max_len=MAX_LEN,
                                  lengths=jnp.asarray(lengths))
    tl, tcache = SV.prefill_step(tc, None, tparams, tin, max_len=MAX_LEN,
                                 lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    _assert_cache(tcache, jcache)


def test_audio_decode_step_matches_jax():
    """Five decode steps on new frame embeddings, rows at different
    positions: logits each step and the cache after them."""
    jparams, tparams, batch = _model(AUDIO)
    jc, tc = _cfgs(AUDIO, remat="none")
    jin, tin = _prompt(batch)
    _, jcache = JSV.prefill_step(jc, None, jparams, jin, max_len=MAX_LEN)
    _, tcache = SV.prefill_step(tc, None, tparams, tin, max_len=MAX_LEN)
    frames = np.random.default_rng(5).standard_normal((5, B, 1, jc.d_model)).astype(np.float32)
    pos = np.array([S, S - 3], np.int32)
    for t, f in enumerate(frames):
        jlg, jcache = JSV.decode_step(jc, None, jparams, jcache, {"frame_embeds": jnp.asarray(f)},
                                      jnp.asarray(pos + t))
        tlg, tcache = SV.decode_step(tc, None, tparams, tcache,
                                     {"frame_embeds": torch.from_numpy(f)},
                                     torch.from_numpy(pos + t))
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=TOL, atol=TOL,
                                   err_msg=f"step {t}")
    _assert_cache(tcache, jcache)


def test_vision_greedy_decode_matches_jax():
    jparams, tparams, batch = _model(VISION)
    jc, tc = _cfgs(VISION, remat="none")
    jin, tin = _prompt(batch)
    steps = 6
    jl, jcache = JSV.prefill_step(jc, None, jparams, jin, max_len=MAX_LEN)
    jtok0 = JDL.sample_token(jl[:, : jc.vocab_size], None)
    jtoks, jaux = JDL.decode_tokens(jc, None, jparams, jcache, jtok0[:, None],
                                    jnp.full((B,), S, jnp.int32), num_steps=steps,
                                    collect_logits=True)
    tl, tcache = SV.prefill_step(tc, None, tparams, tin, max_len=MAX_LEN)
    ttok0 = DL.sample_token(tl[:, : tc.vocab_size], None)
    ttoks, taux = DL.decode_tokens(tc, None, tparams, tcache, ttok0[:, None],
                                   torch.full((B,), S, dtype=torch.int32), num_steps=steps,
                                   collect_logits=True)
    assert ttok0.tolist() == np.asarray(jtok0).tolist()
    assert ttoks.tolist() == np.asarray(jtoks).tolist()
    np.testing.assert_allclose(taux["logits"].numpy(), np.asarray(jaux["logits"]),
                               rtol=TOL, atol=TOL)
    _assert_cache(taux["cache"], jaux["cache"])


def test_decode_tokens_refuses_audio():
    jparams, tparams, batch = _model(AUDIO)
    jc, tc = _cfgs(AUDIO, remat="none")
    tok = np.zeros((B, 1), np.int32)
    with pytest.raises(ValueError, match="frame embeddings"):
        JDL.decode_tokens(jc, None, jparams, {}, jnp.asarray(tok), S, num_steps=2)
    with pytest.raises(ValueError, match="frame embeddings"):
        DL.decode_tokens(tc, None, tparams, {}, torch.from_numpy(tok), S, num_steps=2)


def _assert_loss_and_grads(jc, tc, jparams, batch, tparams=None):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(jc, JPAR, p, b), has_aux=True))(jparams, jb)
    tparams = tparams or from_jax_params(jax.device_get(jparams), "cpu")
    tl, tm, tg = TL.value_and_grad(tc, None, tparams, {k: torch.from_numpy(v)
                                                       for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL, atol=LOSS_TOL)
    assert float(tm["tokens"]) == float(jm["tokens"])
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert [tuple(t.shape) for t in tleaves] == [j.shape for j in jleaves]
    for t, j in zip(tleaves, jleaves):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= GRAD_TOL * max(np.abs(j).max(), 1e-30)
    return tm


@pytest.mark.parametrize("u", [1, 4])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_loss_and_grads_match_jax(arch, u):
    """Remat full; internvl counts no loss on its 4 patch positions."""
    jparams, tparams, batch = _model(arch)
    jc, tc = _cfgs(arch, fpdt_chunks=u, mlp_chunks=2 * u, remat="full")
    tm = _assert_loss_and_grads(jc, tc, jparams, batch, tparams)
    assert float(tm["tokens"]) == B * (S - tc.num_patches)


def test_cli_serves_audio_on_cpu(capsys):
    """Frame embeddings in, the per-token loop (each step a fresh frame),
    both timed lines on the CPU."""
    out = CLI.main(["--arch", AUDIO, "--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "16", "--gen", "4"])
    text = capsys.readouterr().out
    assert out["tokens"].shape == (2, 4) and out["mode"] == "per-token loop"
    assert int(out["tokens"].min()) >= 0 and int(out["tokens"].max()) < 256
    timed = [ln for ln in text.splitlines() if " ms" in ln]
    assert len(timed) == 2 and all(ln.endswith("on cpu") for ln in timed)
    assert "decode [per-token loop] 3 steps" in text


@pytest.mark.parametrize("per_token", [False, True])
def test_cli_serves_vision_on_cpu(capsys, per_token):
    """A 16-position prompt is 4 patches and 12 tokens; --per-token gives
    decode_tokens' greedy tokens."""
    argv = ["--arch", VISION, "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
            "16", "--gen", "5"]
    out = CLI.main(argv + ["--per-token"] * per_token)
    text = capsys.readouterr().out
    assert out["mode"] == ("per-token loop" if per_token else "loop")
    assert f"decode [{out['mode']}] 4 steps x 2 seqs" in text
    if per_token:
        assert out["tokens"].tolist() == CLI.main(argv)["tokens"].tolist()
    timed = [ln for ln in text.splitlines() if " ms" in ln]
    assert len(timed) == 2 and all(ln.endswith("on cpu") for ln in timed)


def test_cli_refuses_a_vision_prompt_within_its_patches(capsys):
    with pytest.raises(SystemExit) as ex:
        CLI.main(["--arch", VISION, "--reduced", "--device", "cpu", "--prompt-len", "4"])
    assert ex.value.code == 2
    assert "must exceed the patches" in capsys.readouterr().err


def test_serve_batch_asks_audio_for_its_frames():
    _, tparams, batch = _model(AUDIO)
    _, tc = _cfgs(AUDIO, remat="none")
    with pytest.raises(ValueError, match="frames"):
        CLI.serve_batch(tc, tparams, _prompt(batch)[1], gen=3)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_checkpoint_restores_through_jax(arch, tmp_path):
    """The port's checkpoint of the parameters (bf16) and AdamW state
    reads back through the JAX manager into the JAX tree, the same bits
    leaf by leaf: musicgen's has no embed key, as the JAX layout has none."""
    jc, tc = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    params = T.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    oc = A.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    state = {"params": params, "opt": A.init(oc, params)}
    CheckpointManager(str(tmp_path)).save(1, state, blocking=True)
    with open(tmp_path / "step_1" / "MANIFEST.json") as f:
        keys = json.load(f)["index"]
    assert any(k.startswith("params/embed") for k in keys) == (arch == VISION)
    jp = JT.init_params(jc, jax.random.PRNGKey(1))
    got, _ = JManager(str(tmp_path)).restore(
        1, {"params": jp, "opt": JA.init(JA.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10),
                                         jp)})
    want = tree_leaves(params)
    got = jax.tree.leaves(got["params"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g).view(np.uint16),
                              w.view(torch.int16).numpy().view(np.uint16))


# the plain dense configs: one layer and u = 4 reach each one's branch (the
# FPDT backward with qwen's qkv bias; GQA 2:1 at mistral's and yi's rope
# theta)
DENSE = ["qwen1.5-4b", "mistral-nemo-12b", "yi-34b"]


@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_loss_and_grads_match_jax(arch):
    jfull, tfull = j_get_config(arch), get_config(arch)
    assert dataclasses.asdict(tfull) == dataclasses.asdict(jfull)
    assert tfull.num_params() == jfull.num_params()
    jc, tc = _cfgs(arch, num_layers=1, fpdt_chunks=4, mlp_chunks=8, remat="full")
    assert (tc.qkv_bias, tc.num_kv_heads) == ((True, 4) if arch == "qwen1.5-4b" else (False, 2))
    jparams = JT.init_params(jc, jax.random.PRNGKey(1))
    if tc.qkv_bias:  # zeros at init: give the biases values, so their gradients reach q, k, v
        keys = jax.random.split(jax.random.PRNGKey(2), 3)
        attn = jparams["cycles"]["pos0"]["attn"]
        for k, name in zip(keys, ("bq", "bk", "bv")):
            attn[name] = 0.1 * jax.random.normal(k, attn[name].shape, attn[name].dtype)
    batch = j_make_batch_fn(jc, JShape("t", 32, 1, "train"))(0)
    _assert_loss_and_grads(jc, tc, jparams, batch)
