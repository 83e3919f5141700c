"""The port's training path against the JAX package's on reduced
llama3.2-1b (fp32 parameters, the same converted weights and the same
pipeline batches): ``loss_fn`` and every gradient leaf at u in {1, 4} with
remat full and none; a 3-step loss and grad-norm trajectory of
``make_train_step`` (and one step with grad_accum 2); the CLI on the CPU,
with ``--compress-grads`` (alone and with ``--grad-accum 2``), with
``--trace-out`` and ``--metrics-out`` (their files' spans and series), and
all three on a 1 x 2 gloo mesh, where rank 0 alone writes (``--mesh``:
tests/test_torch_train_dist.py; the checkpoint flags:
tests/test_torch_checkpoint.py; compression against JAX:
tests/test_torch_compression.py).  The JAX side runs
attention as ``xla_flash``, which its own tests hold equal to the Pallas
kernels (tests/test_kernels_flash.py), with host offload off.  Tolerances:
loss 2e-4 and gradients 5e-4 (tests/test_fpdt.py); the trajectory's losses
and gradient norms 1e-4 relative, since AdamW's first steps move each
weight by about lr * sign(g) and a near-zero gradient may take either sign
in the two implementations.

Reduced recurrentgemma-9b (rglru, rglru, local_attn: the RG-LRU blocks and
a windowed MQA attention block) is held the same way against JAX
``loss_fn`` with ``par=None``, the JAX trainer's own single-device path,
which runs the Pallas linear-scan and flash kernels in interpret mode.
Reduced falcon-mamba-7b (three Mamba-1 blocks) at 512 tokens, two blocks
of the selective scan, likewise: loss and gradients under remat none and
full, a 3-step trajectory and the CLI.

Reduced granite-moe-1b-a400m (three attention blocks with the MoE FFN: 4
experts, top-2, drops at u = 4's 8-token groups): the total ``loss +
0.01 * aux``, the cross-entropy and aux apart, and every gradient leaf
(the fp32 router included) under remat none, full and offload at u in
{1, 4} against JAX ``loss_fn`` (remat offload against JAX's remat full,
as tests/test_torch_paper_models.py holds it), remat offload equal to
remat full bit for bit, a 3-step trajectory (aux included), one
grad_accum step (the loss there is the mean total, as in the JAX loop)
and the CLI, whose log lines print aux.  Reduced llama4-maverick-400b-a17b
(top-1 of 4 experts, rope theta 5e5, bf16 optimizer state): the loss and
every leaf, and its full size's parameter counts."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig as JShape, get_config as j_get_config, reduced as j_reduced
from repro.core.parallel import ParallelContext as JPar
from repro.data.pipeline import make_batch_fn as j_make_batch_fn
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.runtime import train_loop as JTL
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_params
from repro_torch.launch import train as CLI
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.optim import compression as C
from repro_torch.runtime import train_loop as TL
from repro_torch.tree import tree_leaves

B, S = 2, 32
JPAR = JPar(mesh=None, attn_impl="xla_flash", offload_to_host=False)


HYBRID = "recurrentgemma-9b"
FALCON = "falcon-mamba-7b"


def _cfgs(arch="llama3.2-1b", **kw):
    kw = dict(param_dtype="float32", **kw)
    return (dataclasses.replace(j_reduced(j_get_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


def _model(arch, seq=S, batch=B):
    jc, _ = _cfgs(arch)
    jparams = JT.init_params(jc, jax.random.PRNGKey(0))
    batches = [j_make_batch_fn(jc, JShape("t", seq, batch, "train"))(step) for step in range(3)]
    return jparams, batches


@pytest.fixture(scope="module")
def model():
    return _model("llama3.2-1b")


@pytest.fixture(scope="module")
def hybrid():
    return _model(HYBRID)


@pytest.fixture(scope="module")
def falcon():
    """512 tokens: two of the selective scan's 256-token blocks, the state
    carried between them."""
    return _model(FALCON, seq=512, batch=1)


def _torch(tree):
    return from_jax_params(jax.device_get(tree), "cpu")


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("u,remat", [(1, "none"), (1, "full"), (4, "none"), (4, "full")])
def test_loss_and_grads_match_jax(model, u, remat):
    jparams, batches = model
    jc, tc = _cfgs(fpdt_chunks=u, mlp_chunks=2 * u, remat=remat)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(jc, JPAR, p, b), has_aux=True))(jparams, jb)
    tl, tm, tg = TL.value_and_grad(tc, None, _torch(jparams), _tbatch(batches[0]))
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-4, atol=2e-4)
    assert float(tm["tokens"]) == float(jm["tokens"]) == B * S
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert [tuple(t.shape) for t in tleaves] == [j.shape for j in jleaves]
    for t, j in zip(tleaves, jleaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=5e-4, atol=5e-4)


def _trajectories(model, steps, grad_accum, arch="llama3.2-1b", jpar=JPAR):
    jparams, batches = model
    jc, tc = _cfgs(arch, fpdt_chunks=4, mlp_chunks=8, remat="full")
    oc = dict(lr=1e-3, warmup_steps=2, total_steps=steps)
    jstep = jax.jit(JTL.make_train_step(jc, jpar, JA.OptConfig(**oc),
                                        JTL.TrainConfig(grad_accum=grad_accum)))
    tstep = TL.make_train_step(tc, None, A.OptConfig(**oc), TL.TrainConfig(grad_accum=grad_accum))
    jp, js = jparams, JA.init(JA.OptConfig(**oc), jparams)
    tp = _torch(jparams)
    ts = A.init(A.OptConfig(**oc), tp)
    out = []
    for step in range(steps):
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in batches[step].items()})
        tp, ts, tm = tstep(tp, ts, _tbatch(batches[step]))
        out.append({k: (float(tm[k]), float(jm[k])) for k in ("loss", "grad_norm", "lr")})
    return out


def test_three_step_trajectory_matches_jax(model):
    for rec in _trajectories(model, 3, 1):
        for k, (got, want) in rec.items():
            np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=k)


def test_grad_accum_step_matches_jax(model):
    (rec,) = _trajectories(model, 1, 2)
    for k, (got, want) in rec.items():
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("u", [1, 4])
def test_hybrid_loss_and_grads_match_jax(hybrid, u):
    """Every gradient leaf, stacked cycle leaves and the fp32 gate
    parameters included, against JAX loss_fn(par=None) with remat full."""
    jparams, batches = hybrid
    jc, tc = _cfgs(HYBRID, fpdt_chunks=u, mlp_chunks=2 * u, remat="full")
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(jc, None, p, b), has_aux=True))(jparams, jb)
    tl, tm, tg = TL.value_and_grad(tc, None, _torch(jparams), _tbatch(batches[0]))
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-4, atol=2e-4)
    assert float(tm["tokens"]) == float(jm["tokens"]) == B * S
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert [tuple(t.shape) for t in tleaves] == [j.shape for j in jleaves]
    for t, j in zip(tleaves, jleaves):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 5e-4 * max(np.abs(j).max(), 1e-30)


def test_hybrid_three_step_trajectory_matches_jax(hybrid):
    for rec in _trajectories(hybrid, 3, 1, HYBRID, None):
        for k, (got, want) in rec.items():
            np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_falcon_loss_and_grads_match_jax(falcon, remat):
    """Reduced falcon-mamba-7b (three ssm blocks, no attention, no MLP):
    the loss and every gradient leaf (A_log, b_dt and D in fp32 included)
    against JAX loss_fn(par=None) under the same remat."""
    jparams, batches = falcon
    jc, tc = _cfgs(FALCON, remat=remat)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(jc, None, p, b), has_aux=True))(jparams, jb)
    tl, tm, tg = TL.value_and_grad(tc, None, _torch(jparams), _tbatch(batches[0]))
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-4, atol=2e-4)
    assert float(tm["tokens"]) == float(jm["tokens"]) == 512
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert [tuple(t.shape) for t in tleaves] == [j.shape for j in jleaves]
    assert [t.dtype for t in tleaves] == [t.dtype for t in tree_leaves(_torch(jparams))]
    for t, j in zip(tleaves, jleaves):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 5e-4 * max(np.abs(j).max(), 1e-30)


def test_falcon_three_step_trajectory_matches_jax(falcon):
    for rec in _trajectories(falcon, 3, 1, FALCON, None):
        for k, (got, want) in rec.items():
            np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=k)


def test_falcon_cli_on_cpu(capsys):
    history = CLI.main(["--arch", FALCON, "--reduced", "--device", "cpu", "--steps", "2",
                        "--batch", "1", "--seq", "512", "--remat", "full", "--log-every", "1"])
    assert [r["step"] for r in history] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in history)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "tokens/s" in ln]
    assert len(lines) == 2 and all(ln.endswith("on cpu") for ln in lines)


def test_cli_on_cpu(capsys):
    history = CLI.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--steps", "2",
                        "--batch", "2", "--seq", "32", "--chunks", "4", "--offload",
                        "--remat", "full", "--log-every", "1"])
    assert [r["step"] for r in history] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in history)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "tokens/s" in ln]
    assert len(lines) == 2 and all(ln.endswith("on cpu") for ln in lines)


def test_hybrid_cli_on_cpu(capsys):
    history = CLI.main(["--arch", HYBRID, "--reduced", "--device", "cpu", "--steps", "2",
                        "--batch", "2", "--seq", "32", "--chunks", "4", "--offload",
                        "--remat", "full", "--log-every", "1"])
    assert [r["step"] for r in history] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in history)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "tokens/s" in ln]
    assert len(lines) == 2 and all(ln.endswith("on cpu") for ln in lines)


CLI_LLAMA = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--steps", "2",
             "--batch", "2", "--seq", "32", "--chunks", "4", "--log-every", "1"]


@pytest.mark.parametrize("accum", [1, 2])
def test_cli_compress_grads(monkeypatch, accum):
    """--compress-grads (with --grad-accum): a finite history, the step
    quantizes every step, and the residuals it carries are nonzero after
    step 1 and shaped like the parameters."""
    real, calls, runs = C.tree_quantize_with_feedback_, [], []
    real_steps = CLI.train_steps

    def counted(grads, residuals, par=None, plans=None):
        out = real(grads, residuals, par, plans)
        calls.append(sum(int(r.count_nonzero()) for r in tree_leaves(residuals)))
        return out

    def kept(*a, **kw):
        runs.append(real_steps(*a, **kw))
        return runs[-1]

    monkeypatch.setattr(C, "tree_quantize_with_feedback_", counted)
    monkeypatch.setattr(CLI, "train_steps", kept)
    history = CLI.main(CLI_LLAMA + ["--compress-grads", "--grad-accum", str(accum)])
    assert [r["step"] for r in history] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in history)
    assert len(calls) == 2 and calls[0] > 0
    (run,) = runs
    assert [tuple(r.shape) for r in tree_leaves(run.residuals)] == [
        tuple(p.shape) for p in tree_leaves(run.params)]
    assert all(r.dtype == torch.float32 for r in tree_leaves(run.residuals))


def test_cli_trace_and_metrics_out(tmp_path, capsys):
    """--trace-out: one train.step span a step, its duration the history's
    dt; --metrics-out: the step counter, the step-time summary and the
    loss gauge; the JAX CLI's three [telemetry] lines."""
    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    history = CLI.main(CLI_LLAMA + ["--trace-out", str(trace), "--metrics-out", str(prom)])
    spans = [e for e in json.loads(trace.read_text())["traceEvents"] if e["name"] == "train.step"]
    assert [e["ph"] for e in spans] == ["X", "X"]
    assert [e["args"]["step"] for e in spans] == [1, 2]
    for e, rec in zip(spans, history):
        assert e["dur"] == pytest.approx(rec["dt"] * 1e6, rel=1e-12)
        assert e["args"]["loss"] == rec["loss"]
    text = prom.read_text()
    assert 'repro_train_steps{component="train"} 2' in text
    assert 'repro_train_step_ms_count{component="train"} 2' in text
    assert f'repro_train_loss{{component="train"}} {history[-1]["loss"]}' in text
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[telemetry]")]
    assert len(lines) == 3 and lines[0].endswith(str(trace)) and lines[1].endswith(str(prom))
    assert "over 2 steps on cpu" in lines[2]


def test_cli_mesh_compress_and_trace(tmp_path):
    """--mesh 1x2 with --compress-grads and --trace-out: the two ranks
    train and rank 0 alone prints and writes the trace."""
    from _torch_dist import run_cli

    out = run_cli(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--mesh", "1x2",
                   "--dist-backend", "gloo", "--steps", "2", "--batch", "2", "--seq", "32",
                   "--chunks", "2", "--compress-grads", "--trace-out", "t.json",
                   "--log-every", "1"], tmp_path)
    assert out.count("[telemetry] wrote") == 1 and out.count("[telemetry] train_step_ms") == 1
    assert sorted(p.name for p in tmp_path.glob("*.json")) == ["t.json"]
    spans = [e for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"]
             if e["name"] == "train.step"]
    assert [e["args"]["step"] for e in spans] == [1, 2]
    assert all(np.isfinite(e["args"]["loss"]) for e in spans)


GRANITE, LLAMA4 = "granite-moe-1b-a400m", "llama4-maverick-400b-a17b"


@pytest.fixture(scope="module")
def granite():
    return _model(GRANITE)


_GRANITE_JAX = {}


def _granite_reference(granite, u, remat):
    """JAX (total, loss, aux, leaves) of the first batch, once per (u, remat)."""
    if (u, remat) not in _GRANITE_JAX:
        jparams, batches = granite
        jc, _ = _cfgs(GRANITE, fpdt_chunks=u, mlp_chunks=2 * u, remat=remat)
        jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
        (jt, jm), jg = jax.jit(jax.value_and_grad(
            lambda p, b: JT.loss_fn(jc, JPAR, p, b), has_aux=True))(jparams, jb)
        _GRANITE_JAX[u, remat] = (float(jt), float(jm["loss"]), float(jm["aux"]),
                                  [np.asarray(j) for j in jax.tree.leaves(jg)])
    return _GRANITE_JAX[u, remat]


@pytest.mark.parametrize("remat", ["none", "full", "offload"])
@pytest.mark.parametrize("u", [1, 4])
def test_granite_loss_and_grads_match_jax(granite, u, remat):
    """The gradients are those of the total (test_granite_remat_offload_is_
    remat_full_bit_for_bit reads loss_fn's total itself)."""
    jt, jl, jaux, jleaves = _granite_reference(granite, u, "none" if remat == "none" else "full")
    jparams, batches = granite
    _, tc = _cfgs(GRANITE, fpdt_chunks=u, mlp_chunks=2 * u, remat=remat)
    _, tm, tg = TL.value_and_grad(tc, None, _torch(jparams), _tbatch(batches[0]))
    total = float(tm["loss"]) + 0.01 * float(tm["aux"])
    np.testing.assert_allclose(total, jt, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(tm["loss"]), jl, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(tm["aux"]), jaux, rtol=2e-4)
    assert jaux > 0 and abs(jt - jl - 0.01 * jaux) <= 1e-5 * abs(jt)
    tleaves = tree_leaves(tg)
    assert [tuple(t.shape) for t in tleaves] == [j.shape for j in jleaves]
    assert [t.dtype for t in tleaves] == [t.dtype for t in tree_leaves(_torch(granite[0]))]
    for t, j in zip(tleaves, jleaves):
        assert np.abs(t.numpy() - j).max() <= 5e-4 * max(np.abs(j).max(), 1e-30)


def test_granite_remat_offload_is_remat_full_bit_for_bit(granite):
    jparams, batches = granite
    out = {}
    for remat in ("full", "offload"):
        _, tc = _cfgs(GRANITE, fpdt_chunks=4, mlp_chunks=8, remat=remat)
        total, m = T.loss_fn(tc, None, _torch(jparams), _tbatch(batches[0]))
        assert torch.equal(total, m["loss"] + 0.01 * m["aux"])
        _, tm, grads = TL.value_and_grad(tc, None, _torch(jparams), _tbatch(batches[0]))
        out[remat] = [total.detach(), tm["aux"], *tree_leaves(grads)]
    assert all(torch.equal(a, b) for a, b in zip(out["full"], out["offload"]))


def test_granite_three_step_trajectory_matches_jax(granite):
    jparams, batches = granite
    jc, tc = _cfgs(GRANITE, fpdt_chunks=4, mlp_chunks=8, remat="full")
    oc = dict(lr=1e-3, warmup_steps=2, total_steps=3)
    jstep = jax.jit(JTL.make_train_step(jc, JPAR, JA.OptConfig(**oc), JTL.TrainConfig()))
    tstep = TL.make_train_step(tc, None, A.OptConfig(**oc), TL.TrainConfig())
    jp, js = jparams, JA.init(JA.OptConfig(**oc), jparams)
    tp = _torch(jparams)
    ts = A.init(A.OptConfig(**oc), tp)
    for step in range(3):
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in batches[step].items()})
        tp, ts, tm = tstep(tp, ts, _tbatch(batches[step]))
        for k in ("loss", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)


def test_granite_grad_accum_step_matches_jax(granite):
    """Two micro-batches: the loss is the mean total (cross-entropy plus
    0.01 * aux), as the JAX loop reports it, and aux the mean aux."""
    jparams, batches = granite
    jc, tc = _cfgs(GRANITE, fpdt_chunks=4, mlp_chunks=8, remat="full")
    oc = dict(lr=1e-3, warmup_steps=2, total_steps=1)
    tcfg = dict(grad_accum=2)
    _, _, jm = jax.jit(JTL.make_train_step(jc, JPAR, JA.OptConfig(**oc), JTL.TrainConfig(
        **tcfg)))(jparams, JA.init(JA.OptConfig(**oc), jparams),
                  {k: jnp.asarray(v) for k, v in batches[0].items()})
    tp = _torch(jparams)
    _, _, tm = TL.make_train_step(tc, None, A.OptConfig(**oc), TL.TrainConfig(**tcfg))(
        tp, A.init(A.OptConfig(**oc), tp), _tbatch(batches[0]))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    assert float(tm["aux"]) > 0
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)


def test_granite_cli_on_cpu(capsys):
    history = CLI.main(["--arch", GRANITE, "--reduced", "--device", "cpu", "--steps", "2",
                        "--batch", "2", "--seq", "32", "--chunks", "4", "--offload",
                        "--remat", "full", "--log-every", "1"])
    assert [r["step"] for r in history] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["aux"] > 0 for r in history)
    out = capsys.readouterr().out.splitlines()
    lines = [ln for ln in out if "tokens/s" in ln]
    assert len(lines) == 2 and all(ln.endswith("on cpu") and " aux " in ln for ln in lines)
    assert sum(ln.startswith("step ") and " aux " in ln for ln in out) == 4


def test_llama4_reduced_loss_and_grads_match_jax():
    """Top-1 routing (the renormalised weight is exactly 1), rope theta 5e5
    and bf16 optimizer state in the config, at u = 4 with remat full."""
    jparams, batches = _model(LLAMA4)
    jc, tc = _cfgs(LLAMA4, fpdt_chunks=4, mlp_chunks=8, remat="full")
    assert (tc.experts_per_token, tc.rope_theta, tc.attn_impl, tc.opt_state_dtype) == (
        1, 500000.0, "cp", "bfloat16")
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    (jt, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(jc, JPAR, p, b), has_aux=True))(jparams, jb)
    params, batch = _torch(jparams), _tbatch(batches[0])
    total, _ = T.loss_fn(tc, None, params, batch)
    _, tm, tg = TL.value_and_grad(tc, None, params, batch)
    np.testing.assert_allclose(float(total), float(jt), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=2e-4)
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert [tuple(t.shape) for t in tleaves] == [j.shape for j in jleaves]
    for t, j in zip(tleaves, jleaves):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 5e-4 * max(np.abs(j).max(), 1e-30)
    full = get_config(LLAMA4)
    assert (full.num_params(), full.num_active_params()) == (778214937600, 11160622080)
