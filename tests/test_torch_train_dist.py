"""Sequence- and data-parallel training on a 2 x 2 mesh against the JAX
package's single-device train step.

In this process JAX computes, for reduced llama3.2-1b, gpt-2.7b,
recurrentgemma-9b, falcon-mamba-7b, musicgen-medium (audio frames) and
internvl2-2b (vision patches, 8 of them: one model rank's span of a chunk)
(fp32, u = 2, remat full), the loss, the labelled tokens
and every gradient leaf of the first pipeline batch and a 2-step
``make_train_step`` trajectory (``xla_flash`` attention, offload off, as
tests/test_torch_train.py runs it).  One spawn of 4 gloo ranks
(``tests/_torch_dist.py``, torch only) runs the port on mesh 2 x 2 from
the same weights and batches, each rank on its rows and tokens: the
world-summed gradients, within 5e-4 of each leaf's largest magnitude, and
the trajectory's losses and gradient norms within 5e-4 relative, under
``ulysses`` (llama, gpt, and the hybrid's MQA local attention with its kv
head gathered, and internvl, whose model rank 0 holds every patch and
model rank 1 none) and ``cp`` (llama, forced through ``attn_impl``, and
musicgen, whose sinusoidal table each rank adds at its tokens' global
positions); the
hybrid's RG-LRU and falcon's Mamba layers run their two-pass scans with
the conv halo over the model group, and remat offload gives remat full's
gradients bit for bit there; after the steps the parameters are the same
bits on every rank.  The train CLI at ``--device cpu --dist-backend
gloo`` spawns its ranks (``--mesh host8`` for llama, ``1x2`` for falcon),
trains 2 steps and exits 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import (TRAIN_B, TRAIN_CASES, TRAIN_OPT, TRAIN_PATCHES, TRAIN_S, TRAIN_STEPS,
                         run_cli, run_ranks, train_cfg)
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
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(cfg, JPAR, p, b), has_aux=True))(params, b0)
    oc = JA.OptConfig(**TRAIN_OPT)
    step = jax.jit(JTL.make_train_step(cfg, JPAR, oc, JTL.TrainConfig()))
    p, state, steps = params, JA.init(oc, params), []
    for s in range(TRAIN_STEPS):
        p, state, m = step(p, state, {k: jnp.asarray(v) for k, v in batch_fn(s).items()})
        steps.append([float(m["loss"]), float(m["grad_norm"])])
    out = {f"{arch}/p{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(params))}
    out.update({f"{arch}/g{i}": np.asarray(g) for i, g in enumerate(jax.tree.leaves(grads))})
    return out, (float(loss), float(metrics["tokens"])), steps


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
    want = losses[case.split()[0]][0]
    for got in ranks:
        np.testing.assert_allclose(got[case]["loss"], want, rtol=TOL)
        assert got[case]["grad_rel"] <= TOL, got[case]["grad_rel"]


@pytest.mark.parametrize("case", CASES)
def test_world_token_count_matches_jax(readings, case):
    """Every rank's loss counts the world's labelled tokens, JAX's count
    (the vision case's: B (S - TRAIN_PATCHES)); there model rank 0 (ranks 0
    and 2) holds all the patches, a whole chunk span of them, and model
    rank 1 none."""
    ranks, losses, _ = readings
    want = losses[case.split()[0]][1]
    assert all(got[case]["tokens"] == want for got in ranks)
    if case.startswith("internvl2-2b"):
        assert want == TRAIN_B * (TRAIN_S - TRAIN_PATCHES)
        assert [got[case]["patches"] for got in ranks] == [TRAIN_PATCHES, 0] * 2


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


@pytest.mark.parametrize("case", [c for c in CASES if c.split()[0] in
                                  ("recurrentgemma-9b", "falcon-mamba-7b")])
def test_recurrent_remat_offload_equals_full_on_the_mesh(readings, case):
    """remat offload reruns each cycle's gathers in its recompute, in the
    same order on every rank: the gradients are remat full's bits."""
    ranks, _, _ = readings
    assert all(got[case]["remat_offload_same_bits"] for got in ranks)


def test_cli_mesh_host8_on_cpu(tmp_path):
    out = run_cli(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--dist-backend",
                   "gloo", "--mesh", "host8", "--steps", "2", "--batch", "2", "--seq", "32",
                   "--chunks", "2", "--log-every", "1"], tmp_path)
    assert "mesh 2 data x 4 model (gloo), attention kind ulysses" in out
    lines = [ln for ln in out.splitlines() if "tokens/s" in ln]
    assert len(lines) == 2 and all(ln.endswith("on cpu, 8 ranks") for ln in lines), out


def test_cli_mesh_1x2_trains_falcon_on_cpu(tmp_path):
    out = run_cli(["--arch", "falcon-mamba-7b", "--reduced", "--device", "cpu", "--dist-backend",
                   "gloo", "--mesh", "1x2", "--steps", "2", "--batch", "2", "--seq", "64",
                   "--chunks", "2", "--log-every", "1"], tmp_path)
    assert ("mesh 1 data x 2 model (gloo), attention kind none, on cpu; layout: 2 chunks of 32 "
            "tokens, 16 of each on every model rank; the recurrent scans run in two passes over "
            "4 spans") in out, out
    lines = [ln for ln in out.splitlines() if "tokens/s" in ln]
    assert len(lines) == 2 and all(ln.endswith("on cpu, 2 ranks") for ln in lines), out
