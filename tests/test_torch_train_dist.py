"""Sequence- and data-parallel training on a 2 x 2 mesh against the JAX
package's single-device train step.

In this process JAX computes, for reduced llama3.2-1b and reduced gpt-2.7b
(fp32, u = 2, remat full), the loss and every gradient leaf of the first
pipeline batch and a 2-step ``make_train_step`` trajectory (``xla_flash``
attention, offload off, as tests/test_torch_train.py runs it).  One spawn
of 4 gloo ranks (``tests/_torch_dist.py``, torch only) runs the port on
mesh 2 x 2 from the same weights and batches, each rank on its rows and
tokens: the world-summed gradients, within 5e-4 of each leaf's largest
magnitude, and the trajectory's losses and gradient norms within 5e-4
relative, under ``ulysses`` (llama, gpt) and ``cp`` (llama, forced through
``attn_impl``); after the steps the parameters are the same bits on every
rank; an rglru arch under sp = 2 raises ``NotImplementedError``.  The
train CLI at ``--mesh host8 --device cpu --dist-backend gloo`` spawns its 8
ranks, trains 2 steps and exits 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import (TRAIN_B, TRAIN_CASES, TRAIN_OPT, TRAIN_S, TRAIN_STEPS, run_cli,
                         run_ranks, train_cfg)
from repro import configs as jconfigs
from repro.configs import ShapeConfig
from repro.core.parallel import ParallelContext as JPar
from repro.data.pipeline import make_batch_fn
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.runtime import train_loop as JTL

JPAR = JPar(mesh=None, attn_impl="xla_flash", offload_to_host=False)
TOL = 5e-4


def _reference(arch):
    cfg = train_cfg(jconfigs, arch)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    batch_fn = make_batch_fn(cfg, ShapeConfig("t", TRAIN_S, TRAIN_B, "train"))
    b0 = {k: jnp.asarray(v) for k, v in batch_fn(0).items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(cfg, JPAR, p, b), has_aux=True))(params, b0)
    oc = JA.OptConfig(**TRAIN_OPT)
    step = jax.jit(JTL.make_train_step(cfg, JPAR, oc, JTL.TrainConfig()))
    p, state, steps = params, JA.init(oc, params), []
    for s in range(TRAIN_STEPS):
        p, state, m = step(p, state, {k: jnp.asarray(v) for k, v in batch_fn(s).items()})
        steps.append([float(m["loss"]), float(m["grad_norm"])])
    out = {f"{arch}/p{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(params))}
    out.update({f"{arch}/g{i}": np.asarray(g) for i, g in enumerate(jax.tree.leaves(grads))})
    return out, float(loss), steps


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    ref, losses, steps = {}, {}, {}
    for arch in sorted({a for a, _ in TRAIN_CASES}):
        arrays, losses[arch], steps[arch] = _reference(arch)
        ref.update(arrays)
    np.savez(tmp / "train.npz", **ref)
    return run_ranks("train", 4, tmp), losses, steps


CASES = [f"{a} {k}" for a, k in TRAIN_CASES]


@pytest.mark.parametrize("case", CASES)
def test_first_batch_loss_and_grads_match_jax(readings, case):
    ranks, losses, _ = readings
    want = losses[case.split()[0]]
    for got in ranks:
        np.testing.assert_allclose(got[case]["loss"], want, rtol=TOL)
        assert got[case]["grad_rel"] <= TOL, got[case]["grad_rel"]


@pytest.mark.parametrize("case", CASES)
def test_trajectory_matches_jax(readings, case):
    ranks, _, steps = readings
    want = steps[case.split()[0]]
    for got in ranks:
        assert len(got[case]["steps"]) == TRAIN_STEPS
        np.testing.assert_allclose(got[case]["steps"], want, rtol=TOL)


@pytest.mark.parametrize("case", CASES)
def test_parameters_identical_across_ranks(readings, case):
    ranks, _, _ = readings
    digests = {d for got in ranks for d in got[case]["digests"]}
    assert len(digests) == 1


def test_recurrent_block_under_sequence_parallel_raises(readings):
    ranks, _, _ = readings
    assert all(got["rglru raises"] for got in ranks)


def test_cli_mesh_host8_on_cpu(tmp_path):
    out = run_cli(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--dist-backend",
                   "gloo", "--mesh", "host8", "--steps", "2", "--batch", "2", "--seq", "32",
                   "--chunks", "2", "--log-every", "1"], tmp_path)
    assert "mesh 2 data x 4 model (gloo), attention kind ulysses" in out
    lines = [ln for ln in out.splitlines() if "tokens/s" in ln]
    assert len(lines) == 2 and all(ln.endswith("on cpu, 8 ranks") for ln in lines), out
