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
the gradient and of a whole step as reckoned below from the plans."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import (TRAIN_OPT, ZERO_B, ZERO_CASES, ZERO_S, ZERO_STEPS, run_ranks,
                         zero_cfg)
from repro import configs as jconfigs
from repro.configs import ShapeConfig
from repro.core.parallel import ParallelContext as JPar
from repro.data.pipeline import make_batch_fn
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.runtime import train_loop as JTL
from repro_torch import configs
from repro_torch.launch import shardings as SH
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

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


def _reckon(arch, dp, sp, step: bool):
    """(calls, bytes) of gather_params, reduce_scatter_grads and
    all_reduce_sum in one value_and_grad + reduce_grads under remat full
    (``step``: a whole train step, with the global norm's sums).

    A gather sends the rank's shard over data, then what it has over model;
    its adjoint sends the whole gradient over model, then what is left over
    data.  A cycle's leaf is gathered twice a cycle (the checkpoint's pass
    and the recompute, a view of its cycle, or the whole stack where its
    cycles axis is split) and reduce-scattered once; the tied table twice
    (lookup and head), every other leaf once.  Each leaf replicated on an
    axis is all-reduced once (over the world where it is split on
    neither); loss_fn sums (loss, count[, aux]) once; the step's global
    norm sums 8 bytes over data and 4 over model where the axis has
    ranks."""
    cfg = zero_cfg(configs, arch)
    _, n_cycles, _ = T.layout_of(cfg)
    calls = dict.fromkeys(("gather_params", "reduce_scatter_grads", "all_reduce_sum"), 0)
    nbytes = dict(calls)
    for names, plan in SH.by_path(SH.param_plans(cfg, dp, sp)).items():
        full = int(np.prod(plan.shape)) * plan.dtype.itemsize
        local = plan.local_bytes()
        uses = 1
        if names.startswith("cycles/"):
            uses = n_cycles
            if not plan.splits_cycles:
                full, local = full // n_cycles, local // n_cycles
        elif names == "embed" and cfg.tie_embeddings:
            uses = 2
        passes = 2 if names.startswith("cycles/") else 1
        if plan.data_split:
            calls["gather_params"] += passes * uses
            nbytes["gather_params"] += passes * uses * local
            calls["reduce_scatter_grads"] += uses
            nbytes["reduce_scatter_grads"] += uses * (full // sp if plan.model_split else full)
        if plan.model_split:
            calls["gather_params"] += passes * uses
            nbytes["gather_params"] += passes * uses * local * (dp if plan.data_split else 1)
            calls["reduce_scatter_grads"] += uses
            nbytes["reduce_scatter_grads"] += uses * full
        if (dp > 1 and not plan.data_split) or (sp > 1 and not plan.model_split):
            calls["all_reduce_sum"] += 1
            nbytes["all_reduce_sum"] += plan.local_bytes()
    calls["all_reduce_sum"] += 1
    nbytes["all_reduce_sum"] += 12 if cfg.num_experts else 8
    if step:
        calls["all_reduce_sum"] += (dp > 1) + (sp > 1)
        nbytes["all_reduce_sum"] += 8 * (dp > 1) + 4 * (sp > 1)
    return {k: [calls[k], nbytes[k]] for k in calls}


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
    for got in ranks:
        assert got[case]["grad_counts"] == _reckon(arch, dp, sp, False)
        assert got[case]["step_counts"] == _reckon(arch, dp, sp, True)
