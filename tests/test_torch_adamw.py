"""repro_torch AdamW against the JAX package's: three ``apply`` steps on the
same numpy gradients from the same parameters, in fp32 and bf16 parameters,
comparing parameters, both moments, the learning rate and the gradient norm
after every step; and the schedule ``lr_at`` over warmup and decay."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro_torch.convert import from_jax_params
from repro_torch.optim import adamw as A
from repro_torch.tree import tree_leaves

SHAPES = {"embed": (40, 8), "cycles": {"w": (3, 8, 8), "b": (3, 8)}, "tail": [(8,), (4, 8)]}


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(rng, v, scale) for v in shapes]
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_steps_match_jax(dtype):
    rng = np.random.default_rng(0)
    oc = dict(lr=1e-2, warmup_steps=2, total_steps=5)
    joc, toc = JA.OptConfig(**oc), A.OptConfig(**oc)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, dtype), _tree(rng, SHAPES))
    tparams = from_jax_params(jax.device_get(jparams), "cpu")
    jstate, tstate = JA.init(joc, jparams), A.init(toc, tparams)
    for step in range(3):
        # gradients large enough that clipping engages on the first step
        grads = _tree(rng, SHAPES, scale=0.3 if step else 3.0)
        jg = jax.tree.map(lambda a: jnp.asarray(a, dtype), grads)
        jparams, jstate, jm = JA.apply(joc, jparams, jg, jstate)
        tparams, tstate, tm = A.apply(toc, tparams, from_jax_params(jax.device_get(jg), "cpu"),
                                      tstate)
        assert int(tstate.step) == int(jstate.step) == step + 1
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        for t, j in zip(tree_leaves(tstate.m) + tree_leaves(tstate.v),
                        jax.tree.leaves(jstate.m) + jax.tree.leaves(jstate.v)):
            assert t.dtype == torch.float32
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-7)
        for t, j in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
            assert str(t.dtype) == f"torch.{dtype}"
            np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                                       rtol=1e-6, atol=1e-7)


def test_mixed_dtype_hybrid_params_match_jax():
    """recurrentgemma's bf16 model keeps Lambda and the gate biases in fp32:
    conversion keeps every leaf's dtype, and AdamW updates each leaf in its
    own dtype, as the JAX optimizer does."""
    from repro.configs import get_config as j_get_config, reduced as j_reduced
    from repro.models import transformer as JT

    jc = j_reduced(j_get_config("recurrentgemma-9b"))
    jparams = JT.init_params(jc, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.device_get(jparams), "cpu")
    jdt = [str(j.dtype) for j in jax.tree.leaves(jparams)]
    assert [str(t.dtype).split(".")[1] for t in tree_leaves(tparams)] == jdt
    assert {"float32", "bfloat16"} == set(jdt)
    rng = np.random.default_rng(1)
    jg = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.1, p.dtype),
                      jparams)
    oc = dict(lr=1e-2, warmup_steps=1, total_steps=5)
    jnew, _, _ = JA.apply(JA.OptConfig(**oc), jparams, jg, JA.init(JA.OptConfig(**oc), jparams))
    tnew, _, _ = A.apply(A.OptConfig(**oc), tparams, from_jax_params(jax.device_get(jg), "cpu"),
                         A.init(A.OptConfig(**oc), tparams))
    for t, j in zip(tree_leaves(tnew), jax.tree.leaves(jnew)):
        assert str(t.dtype).split(".")[1] == str(j.dtype)
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), rtol=1e-6,
                                   atol=1e-7)


def test_update_in_slices_is_the_whole_update(monkeypatch):
    """A leaf above UPDATE_SLICE elements is updated slice by slice along
    its leading axis, bit for bit as in one piece."""
    rng = np.random.default_rng(2)
    p0 = {"w": torch.from_numpy(rng.standard_normal((7, 5)).astype(np.float32)).to(torch.bfloat16),
          "b": torch.from_numpy(rng.standard_normal((9,)).astype(np.float32))}
    g = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32)).to(v.dtype)
         for k, v in p0.items()}
    oc = A.OptConfig(lr=1e-2, warmup_steps=1)
    outs = []
    for limit in (A.UPDATE_SLICE, 6):
        monkeypatch.setattr(A, "UPDATE_SLICE", limit)
        params = {k: v.clone() for k, v in p0.items()}
        state = A.init(oc, params)
        for _ in range(2):
            params, state, _ = A.apply(oc, params, g, state)
        outs.append(tree_leaves(params) + tree_leaves(state.m) + tree_leaves(state.v))
    assert len(list(A._slices(torch.zeros(7, 5)))) == 7 and len(list(A._slices(torch.zeros(9)))) == 2
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_lr_schedule_matches_jax():
    oc = dict(lr=3e-4, warmup_steps=10, total_steps=50, min_lr_frac=0.1)
    for step in (0, 1, 5, 10, 11, 30, 50, 70):
        np.testing.assert_allclose(float(A.lr_at(A.OptConfig(**oc), step)),
                                   float(JA.lr_at(JA.OptConfig(**oc), step)), rtol=1e-6)


def test_apply_updates_in_place():
    params = {"w": torch.ones(4, 4)}
    oc = A.OptConfig(lr=0.1, warmup_steps=0)
    state = A.init(oc, params)
    w = params["w"]
    new, state, _ = A.apply(oc, params, {"w": torch.full((4, 4), 0.5)}, state)
    assert new["w"] is w and not torch.equal(w, torch.ones(4, 4))


def test_global_norm_in_slices_is_the_whole_norm(monkeypatch):
    """A leaf above NORM_SLICE elements is squared and summed slice by slice:
    the same norm as in one piece, up to fp32 summation order."""
    rng = np.random.default_rng(3)
    g = {"w": torch.from_numpy(rng.standard_normal((7, 5)).astype(np.float32)).to(torch.bfloat16),
         "b": torch.from_numpy(rng.standard_normal((9,)).astype(np.float32))}
    whole = float(A.global_norm(g))
    monkeypatch.setattr(A, "NORM_SLICE", 6)
    assert len(list(A._slices(g["w"], limit=A.NORM_SLICE))) == 7
    np.testing.assert_allclose(float(A.global_norm(g)), whole, rtol=1e-6)
    want = np.sqrt(sum(np.sum(np.square(v.float().numpy().astype(np.float64))) for v in g.values()))
    np.testing.assert_allclose(whole, want, rtol=1e-6)


def test_update_temporaries_are_the_peak_reckoning():
    """``launch/dryrun.py`` (whose reckoning ``chip_smoke.py`` prints and
    gates with) reckons AdamW's share of a step's peak as ADAMW_BYTES an
    element of the largest slice it updates: the bytes of temporaries
    ``apply`` holds at once, as tools/adamw_temporaries.py counts them."""
    import importlib.util
    from pathlib import Path

    from repro_torch.launch import dryrun as D

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("adamw_temporaries",
                                                  root / "tools" / "adamw_temporaries.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.bytes_per_element() == D.ADAMW_BYTES
    assert D.ADAMW_SLICE == A.UPDATE_SLICE
