"""Int8 gradient compression on ZeRO-3 shards (2 x 2 gloo ranks) against
the JAX package's whole-leaf quantizer and its compressed train step.

Under ZeRO-3 a rank holds shards cut along dimensions other than the
first, so the whole leaf's 2048-element blocks can hold elements of
several shards; the port quantizes with the whole leaf's blocks
(``repro_torch/optim/compression.py``).  In this process JAX quantizes,
leaf by leaf, seeded random gradients (fp32 and bf16) and residuals shaped
like every parameter leaf of the ZeRO-3 cases (reduced llama3.2-1b and
granite-moe-1b-a400m, ``tests/_torch_dist.py::compress_leaves``) and like
hand-made leaves whose blocks straddle a data split, a model split and
both, and one whose shards hold whole blocks; and it takes
``COMPRESS_STEPS`` compressed steps of reduced llama3.2-1b with the
residuals carried by hand.  One spawn of 4 gloo ranks on 2 x 2 quantizes
each rank's shards: each leaf alone and all at once (the step's call), the
shard of JAX's ``g_hat`` and new residual bit for bit, with the
``all_reduce_max`` calls and bytes as reckoned below; and takes the
compressed steps: (loss, grad norm) within 5e-4 relative of JAX's, the
parameters after them within 5e-4 of each leaf's largest magnitude."""
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import (COMPRESS_ARCHS, COMPRESS_LEAVES, COMPRESS_STEPS, TRAIN_OPT, ZERO_B,
                         ZERO_S, compress_leaves, run_ranks, zero_cfg)
from repro import configs as jconfigs
from repro.configs import ShapeConfig
from repro.core.parallel import ParallelContext as JPar
from repro.data.pipeline import make_batch_fn
from repro.launch.shardings import param_spec
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro.runtime import train_loop as JTL

JPAR = JPar(mesh=None, attn_impl="xla_flash", offload_to_host=False)
TOL = 5e-4
BLOCK = 2048


def _jax_plans(cfg):
    """(shape, data_dim, model_dim) of each parameter leaf on 2 x 2, from the
    JAX package's ``param_spec``."""
    stub = types.SimpleNamespace(dp_axes="data", dp=2, sp_axis="model", sp=2)
    shapes = jax.eval_shape(lambda: JT.init_params(cfg, jax.random.PRNGKey(0)))
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = [str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p)))) for p in path]
        spec = tuple(param_spec(None, stub, names, leaf))
        spec += (None,) * (len(leaf.shape) - len(spec))
        out.append((tuple(leaf.shape), spec.index("data") if "data" in spec else None,
                    spec.index("model") if "model" in spec else None))
    return out


def _reference(tmp):
    rng = np.random.default_rng(0)
    arrays = {}
    for name, (shape, dtype, _, _) in sorted(compress_leaves(jconfigs, _jax_plans).items()):
        key = name.replace("/", "_")
        g = jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                        * np.float32(10.0 ** rng.integers(-4, 2))).astype(dtype)
        r = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * np.float32(1e-3))
        g_hat, r_new = JC.quantize_with_feedback(g, r)
        arrays.update({f"{key}/g": np.asarray(g.astype(jnp.float32)), f"{key}/r": np.asarray(r),
                       f"{key}/g_hat": np.asarray(g_hat.astype(jnp.float32)),
                       f"{key}/r_new": np.asarray(r_new)})
    cfg = zero_cfg(jconfigs, "llama3.2-1b")
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    arrays.update({f"step/p{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(params))})
    oc = JA.OptConfig(**TRAIN_OPT)
    step = jax.jit(JTL.make_train_step(cfg, JPAR, oc, JTL.TrainConfig(compress_grads=True)))
    batch_fn = make_batch_fn(cfg, ShapeConfig("t", ZERO_S, ZERO_B, "train"))
    p, state, res, steps = params, JA.init(oc, params), JC.init_residuals(params), []
    for s in range(COMPRESS_STEPS):
        p, state, m, res = step(p, state, {k: jnp.asarray(v) for k, v in batch_fn(s).items()},
                                res)
        steps.append([float(m["loss"]), float(m["grad_norm"])])
    np.savez(tmp / "compress.npz", **arrays)
    return steps, [np.asarray(x) for x in jax.tree.leaves(p)]


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compress")
    steps, params = _reference(tmp)
    ranks = run_ranks("compress", 4, tmp)
    got = np.load(tmp / "compress-params.npz")
    return ranks, steps, params, [got[f"arr_{i}"] for i in range(len(params))]


def _reckon(leaves):
    """(calls, bytes) of all_reduce_max in one quantization of ``leaves``
    ((shape, data_dim, model_dim) on 2 x 2): a leaf straddles where it is
    split and its shards' runs of the whole flat leaf (the local extent of
    the innermost split dimension times the elements after it) are not
    whole blocks; one call for each of the (data, model, both) groups that
    a straddling leaf is split over, 4 bytes for each block of those
    leaves."""
    groups = {}
    for shape, ddim, mdim in leaves:
        dims = [d for d in (ddim, mdim) if d is not None]
        if not dims:
            continue
        d = max(dims)
        run = shape[d] // 2 * math.prod(shape[d + 1:])
        if run % BLOCK:
            key = (ddim is not None, mdim is not None)
            groups[key] = groups.get(key, 0) + 4 * -(-math.prod(shape) // BLOCK)
    return [len(groups), sum(groups.values())]


def test_quantizer_equals_jax_leaf_by_leaf(readings):
    ranks, _, _, _ = readings
    for got in ranks:
        assert got["one_leaf"] and all(got["one_leaf"].values()), [
            k for k, ok in got["one_leaf"].items() if not ok]
        assert len(got["one_leaf"]) == len(compress_leaves(jconfigs, _jax_plans))


def test_tree_quantizer_equals_jax(readings):
    ranks, _, _, _ = readings
    for got in ranks:
        assert got["tree"]


def test_every_straddle_kind_is_exercised(readings):
    """Blocks straddle a data split, a model split and both; the aligned
    leaf has none; the archs' own plans straddle too."""
    ranks, _, _, _ = readings
    for got in ranks:
        s = got["straddling"]
        assert s["data"] > 0 and s["model"] > 0 and s["both"] > 0 and s["aligned"] == 0
        for arch in COMPRESS_ARCHS:
            assert sum(v for k, v in s.items() if k.startswith(arch + "/")) > 0
    assert set(COMPRESS_LEAVES) <= set(ranks[0]["straddling"])


def test_max_reduces_as_reckoned(readings):
    ranks, _, _, _ = readings
    leaves = compress_leaves(jconfigs, _jax_plans)
    want_tree = _reckon([(sh, d, m) for _, (sh, _, d, m) in sorted(leaves.items())])
    want_step = _reckon(_jax_plans(zero_cfg(jconfigs, "llama3.2-1b")))
    assert want_tree[0] == 3 and want_step[0] > 0
    for got in ranks:
        assert got["tree_counts"] == want_tree
        assert got["step_counts"] == want_step


def test_compressed_steps_match_jax(readings):
    ranks, steps, params, gathered = readings
    for got in ranks:
        np.testing.assert_allclose(got["steps"], steps, rtol=TOL)
    for a, b in zip(gathered, params):
        assert a.shape == b.shape
        assert float(np.abs(a - b).max()) <= TOL * max(float(np.abs(b).max()), 1e-30)
