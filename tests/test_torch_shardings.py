"""The port's ZeRO-3 placement (``launch/shardings.py``) against the JAX
package's ``launch/shardings.py::param_spec``.

For every registered arch, reduced, and the meshes (dp, sp) in {(1, 2),
(2, 1), (2, 2), (1, 4), (4, 1)}: every leaf of the JAX parameter tree
(``jax.eval_shape`` of its ``init_params``) has the port's plan at the same
path, and the plan's split dimensions are ``param_spec``'s, called with a
stub context that holds only what it reads (``dp_axes``, ``dp``,
``sp_axis``, ``sp``).  Every rank's ``shard`` of the port's parameters,
put back together in the mesh's rank order, is the whole tree bit for bit
(what ``gather`` does, whose collective ``tests/test_torch_parallel.py``
holds), each shard has its plan's local shape, and the bytes the ranks
hold sum to the reckoning: each leaf's bytes once for each rank that
replicates it.  On one rank every plan is the identity.  For the MoE
archs, the expert parallelism (``expert_parallel``) holds exactly where
``param_spec`` splits the expert stacks' e over model, and there their
gradients are summed over no model group (``reduce_axes``)."""
import types

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.shardings import param_spec
from repro.models import transformer as JT
from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.core.parallel import ParallelContext
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

ARCHS = list_configs()
MESHES = ((1, 2), (2, 1), (2, 2), (1, 4), (4, 1))
_JAX = {}


def _jax_leaves(arch):
    """(path names, shape) of every leaf of the reduced JAX parameter tree."""
    if arch not in _JAX:
        cfg = jconfigs.reduced(jconfigs.get_config(arch))
        shapes = jax.eval_shape(lambda: JT.init_params(cfg, jax.random.PRNGKey(0)))
        flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
        _JAX[arch] = [
            ([str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p)))) for p in path],
             leaf) for path, leaf in flat]
    return _JAX[arch]


def _par(dp, sp, rank):
    return ParallelContext(Mesh(dp, sp, rank, "gloo", None, None))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_is_param_spec(arch, mesh):
    dp, sp = mesh
    stub = types.SimpleNamespace(dp_axes=SH.DATA, dp=dp, sp_axis=SH.MODEL, sp=sp)
    plans = SH.by_path(SH.param_plans(reduced(get_config(arch)), dp, sp))
    leaves = _jax_leaves(arch)
    assert sorted(plans) == sorted("/".join(names) for names, _ in leaves)
    for names, leaf in leaves:
        plan = plans["/".join(names)]
        assert plan.shape == tuple(leaf.shape), names
        want = tuple(param_spec(None, stub, names, leaf))
        want += (None,) * (len(leaf.shape) - len(want))
        assert plan.spec() == want, (names, plan.spec(), want)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_shards_reassemble_and_bytes_add_up(arch, mesh):
    dp, sp = mesh
    cfg = reduced(get_config(arch))
    full = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    plans = SH.param_plans(cfg, dp, sp)
    ranks = [SH.shard_params(cfg, _par(dp, sp, r), full) for r in range(dp * sp)]
    held = 0
    for i, (plan, whole) in enumerate(zip(tree_leaves(plans), tree_leaves(full))):
        shards = [tree_leaves(t)[i] for t in ranks]  # rank r = d * sp + m
        assert all(tuple(s.shape) == plan.local_shape() for s in shards)
        rows = []
        for d in range(dp):
            row = [shards[d * sp + m] for m in range(sp)]
            rows.append(torch.cat(row, plan.model_dim) if plan.model_split else row[0])
        again = torch.cat(rows, plan.data_dim) if plan.data_split else rows[0]
        assert torch.equal(again, whole)
        held += sum(s.numel() * s.element_size() for s in shards)
        copies = ((1 if plan.data_split else dp) * (1 if plan.model_split else sp))
        assert sum(s.numel() for s in shards) == whole.numel() * copies
    reckoned = sum(
        p.local_bytes() for p in tree_leaves(plans)) * dp * sp
    assert held == reckoned
    moments = SH.state_bytes(plans, torch.float32) - 4 - sum(
        p.local_bytes() for p in tree_leaves(plans))
    assert moments == 2 * 4 * sum(p.local_bytes() // p.dtype.itemsize
                                  for p in tree_leaves(plans))


@pytest.mark.parametrize("mesh", MESHES + ((1, 3),), ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", [a for a in ARCHS if get_config(a).num_experts])
def test_expert_parallel_is_the_jax_expert_placement(arch, mesh):
    """``expert_parallel`` holds where ``param_spec`` splits the expert
    stacks' e over a model axis of more than one rank (the reduced MoE
    configs' 4 experts: not over 3).  There each expert stack's gradient,
    whole after the slot exchange, is summed over no model group after its
    data-only reduce-scatter; elsewhere the stacks are replicated over
    model and summed there."""
    dp, sp = mesh
    cfg = reduced(get_config(arch))
    par = ParallelContext(Mesh(dp, sp, 0, "gloo", "data group", "model group"))
    stub = types.SimpleNamespace(dp_axes=SH.DATA, dp=dp, sp_axis=SH.MODEL, sp=sp)
    plans = SH.by_path(SH.param_plans(cfg, dp, sp))
    ep = SH.expert_parallel(cfg, par)
    assert ep == (sp > 1 and cfg.num_experts % sp == 0)
    experts = [(names, leaf) for names, leaf in _jax_leaves(arch) if SH.is_expert_leaf(names)]
    assert {names[-1] for names, _ in experts} == {"wu", "wg", "wd"}
    for names, leaf in experts:
        spec = tuple(param_spec(None, stub, names, leaf))
        assert (sp > 1 and spec[len(leaf.shape) - 3] == SH.MODEL) == ep, (names, spec)
        axes = SH.reduce_axes(plans["/".join(names)], par)
        over_model = axes is None or axes == "model group"
        assert over_model == (sp > 1 and not ep), (names, axes)
    others = [names for names, _ in _jax_leaves(arch) if "router" in names]
    assert others and not any(SH.is_expert_leaf(n) for n in others)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_is_the_identity(arch):
    cfg = reduced(get_config(arch))
    full = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert SH.plans_of(cfg, None) is None
    assert SH.shard_params(cfg, None, full) is full
    plans = SH.param_plans(cfg, 1, 1)
    assert not any(p.data_split or p.model_split for p in tree_leaves(plans))
    assert SH.shard_params(cfg, _par(1, 1, 0), full) is not None
    for p, x in zip(tree_leaves(plans), tree_leaves(full)):
        assert SH.shard(p, x, _par(1, 1, 0)) is x
