"""repro_torch fpdt_attention against the JAX package's (Pallas kernel in
interpret mode, host offload off): chunk counts u in {1, 2, 4, 8}, windows,
qkv bias, block sparsity, one bf16 case; and pair_live as a property test
against the JAX predicate."""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, strategies as st

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.core import fpdt as JF
from repro.core.parallel import ParallelContext as JPar
from repro.models import layers as JL
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_params
from repro_torch.core import fpdt as F

B, S = 2, 64


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    return x


def _run(x, u, *, window=0, bias=False, sparsity=0.0, dtype="float32"):
    kw = dict(param_dtype=dtype, fpdt_chunks=u, qkv_bias=bias, attn_sparsity=sparsity,
              block_q=16, block_k=16)
    jc = dataclasses.replace(j_reduced(j_get_config("llama3.2-1b")), **kw)
    tc = dataclasses.replace(reduced(get_config("llama3.2-1b")), **kw)
    jp = JL.init_attn(jc, jax.random.PRNGKey(3), jnp.dtype(dtype))
    if bias:
        jp = {k: (v + 0.05 if k.startswith("b") else v) for k, v in jp.items()}
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = JF.fpdt_attention(jc, JPar(mesh=None, attn_impl="pallas"), jp, jx, kind="local",
                             window=window)
    tp = from_jax_params(jax.device_get(jp), "cpu")
    tx = from_jax_params(np.asarray(jx), "cpu")
    got = F.fpdt_attention(tc, None, tp, tx, window=window)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("u", [1, 2, 4, 8])
def test_fpdt_matches_jax(inputs, u):
    got, want = _run(inputs, u)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window,u", [(8, 4), (24, 4), (24, 8)])
def test_fpdt_windowed(inputs, window, u):
    got, want = _run(inputs, u, window=window)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_fpdt_qkv_bias(inputs):
    got, want = _run(inputs, 4, bias=True)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_fpdt_sparse(inputs):
    got, want = _run(inputs, 4, sparsity=0.5)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_fpdt_bf16(inputs):
    got, want = _run(inputs, 4, dtype="bfloat16")
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)


def test_every_u_is_the_same_function(inputs):
    base, _ = _run(inputs, 1)
    for u in (2, 4, 8):
        # the port alone: chunking changes only the order of the sums
        tc = dataclasses.replace(reduced(get_config("llama3.2-1b")), param_dtype="float32",
                                 fpdt_chunks=u)
        p = from_jax_params(jax.device_get(JL.init_attn(tc, jax.random.PRNGKey(3), jnp.float32)),
                            "cpu")
        got = F.fpdt_attention(tc, None, p, torch.from_numpy(inputs)).numpy()
        np.testing.assert_allclose(got, base, rtol=2e-4, atol=2e-4)


def test_unported_options_raise(inputs):
    tc = dataclasses.replace(reduced(get_config("llama3.2-1b")), param_dtype="float32",
                             fpdt_chunks=4, fpdt_offload=True)
    p = from_jax_params(jax.device_get(JL.init_attn(tc, jax.random.PRNGKey(3), jnp.float32)),
                        "cpu")
    x = torch.from_numpy(inputs)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        F.fpdt_attention(tc, None, p, x)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        F.fpdt_attention(dataclasses.replace(tc, fpdt_offload=False), None, p, x, kind="ulysses")
    with pytest.raises(ValueError, match="must divide"):
        F.fpdt_attention(dataclasses.replace(tc, fpdt_offload=False, fpdt_chunks=5), None, p, x)


@settings(max_examples=60, deadline=None)
@given(u=st.integers(min_value=1, max_value=8),
       cq=st.sampled_from([1, 4, 8, 512]),
       window=st.sampled_from([0, 1, 5, 8, 17, 600]),
       sparsity=st.sampled_from([0.0, 0.3, 0.5, 0.75, 0.9]))
def test_pair_live_matches_jax(u, cq, window, sparsity):
    kw = dict(cq=cq, window=window, sparsity=sparsity)
    assert F.sparsity_stride(sparsity) == JF.sparsity_stride(sparsity)
    for i, j in itertools.product(range(u), repeat=2):
        assert F.pair_live(i, j, **kw) == JF.pair_live(i, j, **kw), (i, j, kw)
