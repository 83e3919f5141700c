"""The port's training path against the JAX package's on reduced
llama3.2-1b (fp32 parameters, the same converted weights and the same
pipeline batches): ``loss_fn`` and every gradient leaf at u in {1, 4} with
remat full and none; a 3-step loss and grad-norm trajectory of
``make_train_step`` (and one step with grad_accum 2); the CLI on the CPU,
and the CLI refusing the flags that are not yet ported (``--mesh`` is
ported: tests/test_torch_train_dist.py).  The JAX side runs
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
full, a 3-step trajectory and the CLI."""
import dataclasses

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
from repro_torch.optim import adamw as A
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


@pytest.mark.parametrize("flag", [
    ["--ckpt-dir", "ckpt"], ["--ckpt-every", "5"], ["--resume", "auto"],
    ["--compress-grads"], ["--trace-out", "t.json"], ["--metrics-out", "m.prom"],
])
def test_cli_refuses_unported(capsys, flag):
    with pytest.raises(SystemExit) as ex:
        CLI.main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", *flag])
    assert ex.value.code == 2
    assert "not yet ported" in capsys.readouterr().err
