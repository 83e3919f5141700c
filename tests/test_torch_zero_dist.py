"""ZeRO-3 training on 2 x 2 and 1 x 4 meshes against the JAX package's
single-device step and the port's one-rank step.

In this process JAX computes, for reduced llama3.2-1b and
granite-moe-1b-a400m at 4 layers (fp32, b 2, s 64, u 2, remat full;
``tests/_torch_dist.py::ZERO_CASES``), the loss and every gradient leaf of
the first pipeline batch and a 2-step ``make_train_step`` trajectory
(``xla_flash`` attention, offload off, as tests/test_torch_train.py runs
it).  One spawn of 4 gloo ranks runs the port from the same weights, each
rank holding only its shards of the weights and AdamW moments as
``launch/shardings.py`` places them (granite's router stack split along
its cycles axis over model, its expert stacks over both axes, the tied
table over both).  Held: each rank's state is its plan's shards (shapes,
the one-rank initialisation's blocks, the reckoned bytes), and gathering
them gives the whole tree back; the loss within 5e-4 relative and the
gathered gradients within 5e-4 of each leaf's largest magnitude against
JAX and against the port on one rank; remat offload's gradients are remat
full's bits; the trajectory within 5e-4 relative of JAX's and of one
rank's, and the parameters after it within 5e-4 of one rank's; the
gather_params, reduce_scatter_grads and all_reduce_sum calls and bytes of
the gradient and of a whole step as reckoned below from the plans (under
granite's expert parallelism its expert stacks gathered and
reduce-scattered over data only), and the slot collectives' as reckoned
from the shapes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import (TRAIN_OPT, ZERO_B, ZERO_CASES, ZERO_S, ZERO_STEPS, reckon_slots,
                         reckon_zero, run_ranks, zero_cfg)
from repro import configs as jconfigs
from repro.configs import ShapeConfig
from repro.core.parallel import ParallelContext as JPar
from repro.data.pipeline import make_batch_fn
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.runtime import train_loop as JTL
from repro_torch import configs

JPAR = JPar(mesh=None, attn_impl="xla_flash", offload_to_host=False)
TOL = 5e-4


def _reference(arch):
    cfg = zero_cfg(jconfigs, arch)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    batch_fn = make_batch_fn(cfg, ShapeConfig("t", ZERO_S, ZERO_B, "train"))
    b0 = {k: jnp.asarray(v) for k, v in batch_fn(0).items()}
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(cfg, JPAR, p, b), has_aux=True))(params, b0)
    oc = JA.OptConfig(**TRAIN_OPT)
    step = jax.jit(JTL.make_train_step(cfg, JPAR, oc, JTL.TrainConfig()))
    p, state, steps = params, JA.init(oc, params), []
    for s in range(ZERO_STEPS):
        p, state, m = step(p, state, {k: jnp.asarray(v) for k, v in batch_fn(s).items()})
        steps.append([float(m["loss"]), float(m["grad_norm"])])
    out = {f"{arch}/p{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(params))}
    out.update({f"{arch}/g{i}": np.asarray(g) for i, g in enumerate(jax.tree.leaves(grads))})
    return out, float(metrics["loss"]), steps  # the cross-entropy, as the port's loss


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero")
    ref, losses, steps = {}, {}, {}
    for arch in sorted({a for a, _ in ZERO_CASES}):
        arrays, losses[arch], steps[arch] = _reference(arch)
        ref.update(arrays)
    np.savez(tmp / "zero.npz", **ref)
    return run_ranks("zero", 4, tmp), losses, steps


CASES = [f"{a} {m[0]}x{m[1]}" for a, m in ZERO_CASES]


def _reckon(arch, dp, sp, data_rank, step: bool):
    """{name: [calls, bytes]} of gather_params, reduce_scatter_grads and
    all_reduce_sum (``_torch_dist.reckon_zero``: granite's expert stacks,
    whose e splits over model, gathered and reduce-scattered over data
    only) and of the slot collectives (``_torch_dist.reckon_slots``) in one
    value_and_grad + reduce_grads under remat full (``step``: a whole
    train step)."""
    cfg = zero_cfg(configs, arch)
    return {**reckon_zero(cfg, dp, sp, step),
            **reckon_slots(cfg, dp, sp, ZERO_B, ZERO_S, data_rank)}


@pytest.mark.parametrize("case", CASES)
def test_rank_holds_its_shards_only(readings, case):
    ranks, _, _ = readings
    assert all(got[case]["state_is_shards"] for got in ranks)
    assert all(got[case]["shard_gather_identity"] for got in ranks)


@pytest.mark.parametrize("case", CASES)
def test_first_batch_matches_jax_and_one_rank(readings, case):
    ranks, losses, _ = readings
    for got in ranks:
        np.testing.assert_allclose(got[case]["loss"], losses[case.split()[0]], rtol=TOL)
        assert got[case]["grad_rel_jax"] <= TOL, got[case]["grad_rel_jax"]
        assert got[case]["grad_rel_one_rank"] <= TOL, got[case]["grad_rel_one_rank"]


@pytest.mark.parametrize("case", CASES)
def test_steps_match_jax_and_one_rank(readings, case):
    ranks, _, steps = readings
    for got in ranks:
        np.testing.assert_allclose(got[case]["steps"], steps[case.split()[0]], rtol=TOL)
        np.testing.assert_allclose(got[case]["steps"], got[case]["one_rank_steps"], rtol=TOL)
        assert got[case]["param_rel_one_rank"] <= TOL, got[case]["param_rel_one_rank"]


@pytest.mark.parametrize("case", CASES)
def test_remat_offload_is_remat_full(readings, case):
    ranks, _, _ = readings
    assert all(got[case]["remat_offload_same_bits"] for got in ranks)


@pytest.mark.parametrize("case", CASES)
def test_collectives_as_reckoned(readings, case):
    ranks, _, _ = readings
    arch, mesh = case.split()
    dp, sp = (int(x) for x in mesh.split("x"))
    for r, got in enumerate(ranks):
        assert got[case]["grad_counts"] == _reckon(arch, dp, sp, r // sp, False)
        assert got[case]["step_counts"] == _reckon(arch, dp, sp, r // sp, True)
