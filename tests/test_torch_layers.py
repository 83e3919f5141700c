"""repro_torch.models.layers against the JAX package's layers on the same
numpy inputs (and the config registry against the JAX one): norms, rope
on [s] and [b, s] positions, qkv projection with and without bias, and the
MLP (whole and sequence-chunked)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, list_configs as j_list_configs
from repro.configs import reduced as j_reduced
from repro.models import layers as JL
from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.convert import from_jax_params
from repro_torch.models import layers as L

TOL = 1e-5


def _cfgs(**kw):
    jc = dataclasses.replace(j_reduced(j_get_config("llama3.2-1b")), param_dtype="float32", **kw)
    tc = dataclasses.replace(reduced(get_config("llama3.2-1b")), param_dtype="float32", **kw)
    return jc, tc


def _params(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32) * 0.2 for k, s in shapes.items()}


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), rtol=tol, atol=tol)


def test_configs_match_the_jax_registry():
    """Every JAX arch is registered, field for field, reduced too; an
    unknown name raises as the JAX registry's does."""
    assert list_configs() == j_list_configs()
    for name in j_list_configs():
        jc, tc = j_get_config(name), get_config(name)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc), name
        assert dataclasses.asdict(j_reduced(jc)) == dataclasses.asdict(reduced(tc)), name
        assert tc.num_params() == jc.num_params(), name
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama-1t")


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm(rng, norm):
    jc, tc = _cfgs(norm=norm)
    x = rng.standard_normal((2, 5, jc.d_model)).astype(np.float32)
    p = {"w": 1.0 + 0.1 * rng.standard_normal(jc.d_model).astype(np.float32)}
    if norm == "layernorm":
        p["b"] = 0.1 * rng.standard_normal(jc.d_model).astype(np.float32)
    want = JL.apply_norm(jc, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = L.apply_norm(tc, from_jax_params(p, "cpu"), torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("batched", [False, True])
def test_rope(rng, batched):
    b, s, h, d = 2, 7, 3, 16
    x = rng.standard_normal((b, s, h, d)).astype(np.float32)
    pos = (rng.integers(0, 5000, (b, s)) if batched else np.arange(100, 100 + s)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0)
    _close(got, want, 2e-5)  # angles up to ~5e3 rad: fp32 cos/sin differ in the last ulps


@pytest.mark.parametrize("bias", [False, True])
def test_qkv_proj(rng, bias):
    jc, tc = _cfgs(qkv_bias=bias)
    d, qd, kvd = jc.d_model, jc.q_dim, jc.kv_dim
    shapes = {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd)}
    if bias:
        shapes.update(bq=(qd,), bk=(kvd,), bv=(kvd,))
    p = _params(rng, shapes)
    x = rng.standard_normal((2, 6, d)).astype(np.float32)
    want = JL.qkv_proj(jc, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = L.qkv_proj(tc, from_jax_params(p, "cpu"), torch.from_numpy(x))
    for t, j in zip(got, want):
        assert tuple(t.shape) == j.shape
        _close(t, j)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("chunks", [1, 4])
def test_mlp(rng, act, chunks):
    jc, tc = _cfgs(mlp_act=act)
    d, ff = jc.d_model, jc.d_ff
    shapes = {"wu": (d, ff), "wd": (ff, d)}
    if act == "swiglu":
        shapes["wg"] = (d, ff)
    p = _params(rng, shapes)
    x = rng.standard_normal((2, 8, d)).astype(np.float32)
    jp, tp = {k: jnp.asarray(v) for k, v in p.items()}, from_jax_params(p, "cpu")
    want = JL.mlp_chunked(jc, jp, jnp.asarray(x), chunks)
    got = L.mlp_chunked(tc, tp, torch.from_numpy(x), chunks)
    _close(got, want, 1e-4)  # sums of d_ff=128 products of O(1) terms
    _close(L.mlp_block(tc, tp, torch.from_numpy(x)), want, 1e-4)


def test_init_shapes_and_scales():
    _, tc = _cfgs()
    gen = torch.Generator().manual_seed(0)
    p = L.init_attn(tc, gen, torch.float32, "cpu")
    assert p["wq"].shape == (tc.d_model, tc.q_dim) and p["wo"].shape == (tc.q_dim, tc.d_model)
    assert abs(float(p["wq"].std()) * tc.d_model ** 0.5 - 1.0) < 0.1
    m = L.init_mlp(tc, gen, torch.bfloat16, "cpu")
    assert m["wd"].shape == (tc.d_ff, tc.d_model) and m["wd"].dtype == torch.bfloat16
