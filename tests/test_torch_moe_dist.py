"""The MoE FFN trained sequence- and data-parallel against the JAX
package's single-device step.

In this process JAX computes, for reduced granite-moe-1b-a400m (fp32, b 2,
s 64, u 2, remat full; ``tests/_torch_dist.py::MOE_CASES``), the loss, aux
and every gradient leaf of the first pipeline batch (``xla_flash``
attention, offload off, as tests/test_torch_train.py runs it).  One spawn
of 4 gloo ranks runs the port from the same weights and batch, each rank
on its rows and tokens, on four layouts.  Three run expert-parallel (4
experts split over the model ranks, the JAX ``"expert"`` placement): 1x4
with a MoE chunk's one group over the four model ranks, 2x2 with it over
both data and both model ranks, and 1x4 at mlp_chunks 8, where each MoE
chunk is one rank's span and every group is local (every rank still
serves every chunk with its experts).  The fourth has 6 experts on 1x4:
they do not split, so the stacks stay whole on every model rank and no
slot moves.  Held: loss and aux within 5e-4 relative, the world-summed
gradients within 5e-4 of each leaf's largest magnitude, the calls and
bytes of ``gather_counts`` (none where every group and chunk is local),
of ``dispatch_slots`` and ``combine_slots``, and of ``gather_params`` and
``reduce_scatter_grads`` (the expert stacks over data only under expert
parallelism, so none on 1x4) as reckoned from the code's shapes, the
parameters the same bits on every rank after a step, and on 1x4 remat
offload equal to remat full bit for bit.  The train CLI trains granite on
``--mesh 1x2`` (gloo, on the CPU), its log lines printing aux."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import (MOE_B, MOE_CASES, MOE_S, moe_cfg, reckon_slots, reckon_zero, run_cli,
                         run_ranks)
from repro import configs as jconfigs
from repro.configs import ShapeConfig
from repro.core.parallel import ParallelContext as JPar
from repro.data.pipeline import make_batch_fn
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.launch import shardings as SH

JPAR = JPar(mesh=None, attn_impl="xla_flash", offload_to_host=False)
TOL = 5e-4
LAYERS = 3  # reduced granite: three attention blocks with the MoE FFN
# gather_counts (calls, bytes) of one value_and_grad under remat full: each
# layer gathers once in the forward and once in its recompute.  1x4: a rank
# holds 8 tokens of each row in each of 2 chunks, 2 pieces of the chunk's
# group a chunk, so 4 rows of piece counts and 2 of top-1 counts; 2x2: one
# row, 16 tokens of a chunk, 1 piece a chunk: 2 + 2 rows; int32 by expert.
GATHERS = {"1x4": (2 * LAYERS, 2 * LAYERS * (4 + 2) * 4 * 4),
           "2x2": (2 * LAYERS, 2 * LAYERS * (2 + 2) * 4 * 4), "1x4 local": (0, 0),
           "1x4 e6": (2 * LAYERS, 2 * LAYERS * (4 + 2) * 6 * 4)}
# the slot collectives (calls, bytes) of that value_and_grad, by hand:
# [e, G, cap, d] fp32 slots, G = 1 group a chunk, cap 40 of a 64-token
# group (10 of a 16-token one at mlp_chunks 8); on every rank, a layer's n
# chunks each run 1 backward and 3 forwards, but the last chunk 2
# (``reckon_slots``): 3n - 1 forwards a layer
SLOT_BYTES = {"1x4": 4 * 40 * 64 * 4, "2x2": 4 * 40 * 64 * 4, "1x4 local": 4 * 10 * 64 * 4}
SLOTS = {label: {"dispatch_slots": [LAYERS * 4 * n - LAYERS, LAYERS * (
                     (3 * n - 1) * SLOT_BYTES[label] + n * SLOT_BYTES[label] // sp)],
                 "combine_slots": [LAYERS * 4 * n - LAYERS, LAYERS * (
                     (3 * n - 1) * SLOT_BYTES[label] // sp + n * SLOT_BYTES[label])]}
         for label, sp, n in (("1x4", 4, 2), ("2x2", 2, 2), ("1x4 local", 4, 8))}
SLOTS["1x4 e6"] = {"dispatch_slots": [0, 0], "combine_slots": [0, 0]}


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    ref, want = {}, {}
    for label, _, chunks, experts in MOE_CASES:
        cfg = moe_cfg(jconfigs, chunks, experts=experts)
        params = JT.init_params(cfg, jax.random.PRNGKey(0))
        b0 = {k: jnp.asarray(v) for k, v in
              make_batch_fn(cfg, ShapeConfig("t", MOE_S, MOE_B, "train"))(0).items()}
        (_, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p, b: JT.loss_fn(cfg, JPAR, p, b), has_aux=True))(params, b0)
        ref.update({f"{label}/p{i}": np.asarray(x)
                    for i, x in enumerate(jax.tree.leaves(params))})
        ref.update({f"{label}/g{i}": np.asarray(g) for i, g in enumerate(jax.tree.leaves(grads))})
        want[label] = (float(metrics["loss"]), float(metrics["aux"]))
    np.savez(tmp / "moe.npz", **ref)
    return run_ranks("moe", 4, tmp), want


CASES = [label for label, *_ in MOE_CASES]


@pytest.mark.parametrize("case", CASES)
def test_first_batch_matches_jax(readings, case):
    ranks, want = readings
    loss, aux = want[case]
    for got in ranks:
        np.testing.assert_allclose(got[case]["loss"], loss, rtol=TOL)
        np.testing.assert_allclose(got[case]["aux"], aux, rtol=TOL)
        assert got[case]["grad_rel"] <= TOL, got[case]["grad_rel"]


@pytest.mark.parametrize("case", CASES)
def test_gather_counts_as_reckoned(readings, case):
    ranks, _ = readings
    assert all(got[case]["gather_counts"] == list(GATHERS[case]) for got in ranks), \
        [got[case]["gather_counts"] for got in ranks]


@pytest.mark.parametrize("case", CASES)
def test_slot_collectives_as_reckoned(readings, case):
    ranks, _ = readings
    _, (dp, sp), chunks, experts = next(c for c in MOE_CASES if c[0] == case)
    cfg = moe_cfg(configs, chunks, experts=experts)
    for r, got in enumerate(ranks):
        want = reckon_slots(cfg, dp, sp, MOE_B, MOE_S, r // sp)
        assert want == SLOTS[case]
        assert {k: got[case][k] for k in want} == want


@pytest.mark.parametrize("case", CASES)
def test_expert_stacks_gathered_over_data_only(readings, case):
    """gather_params and reduce_scatter_grads as the plans give them, with
    no model-axis bytes for an expert stack whose e splits: on 1x4 the
    gathers are the tied table's alone."""
    ranks, _ = readings
    _, (dp, sp), chunks, experts = next(c for c in MOE_CASES if c[0] == case)
    cfg = moe_cfg(configs, chunks, experts=experts)
    want = reckon_zero(cfg, dp, sp)
    plans = SH.by_path(SH.param_plans(cfg, dp, sp))
    split = [p for n, p in plans.items() if n.endswith(("moe/wu", "moe/wg", "moe/wd"))
             and p.model_split]
    assert bool(split) == (experts % sp == 0)
    if dp == 1:  # the tied table's two uses, one gather each; no stack is gathered
        assert want["gather_params"] == [2, 2 * plans["embed"].local_bytes()]
    for got in ranks:
        assert [got[case]["gather_params"], got[case]["reduce_scatter_grads"]] == [
            want["gather_params"], want["reduce_scatter_grads"]]


@pytest.mark.parametrize("case", CASES)
def test_parameters_identical_across_ranks(readings, case):
    ranks, _ = readings
    assert len({d for got in ranks for d in got[case]["digests"]}) == 1


def test_remat_offload_is_remat_full_on_the_mesh(readings):
    ranks, _ = readings
    assert all(got["1x4"]["remat_offload_same_bits"] for got in ranks)


def test_cli_mesh_1x2_trains_granite_on_cpu(tmp_path):
    out = run_cli(["--arch", "granite-moe-1b-a400m", "--reduced", "--device", "cpu",
                   "--dist-backend", "gloo", "--mesh", "1x2", "--steps", "1", "--batch", "2",
                   "--seq", "64", "--chunks", "2", "--log-every", "1"], tmp_path)
    assert "mesh 1 data x 2 model (gloo), attention kind ulysses" in out, out
    lines = [ln for ln in out.splitlines() if "tokens/s" in ln]
    assert len(lines) == 1 and " aux " in lines[0] and lines[0].endswith("on cpu, 2 ranks"), out
