"""repro_torch fpdt_attention against the JAX package's (Pallas kernels in
interpret mode, host offload off): the output at chunk counts u in
{1, 2, 4, 8}, windows, qkv bias, block sparsity, one bf16 case; the
gradients of x and the q/k/v projections (and biases) through the Fig. 7
backward, at the same settings; the port's host offload on vs off; and
pair_live as a property test against the JAX predicate.  Tolerances: output
2e-4, gradients 5e-4 (tests/test_fpdt.py)."""
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
    """The distributed kinds are not yet ported, and u must divide S.  Host
    offload is ported (test_offload_on_off_equal)."""
    tc = dataclasses.replace(reduced(get_config("llama3.2-1b")), param_dtype="float32",
                             fpdt_chunks=4, fpdt_offload=True)
    p = from_jax_params(jax.device_get(JL.init_attn(tc, jax.random.PRNGKey(3), jnp.float32)),
                        "cpu")
    x = torch.from_numpy(inputs)
    for kind in ("ulysses", "cp"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            F.fpdt_attention(tc, None, p, x, kind=kind)
    with pytest.raises(ValueError, match="must divide"):
        F.fpdt_attention(dataclasses.replace(tc, fpdt_chunks=5), None, p, x)


def _grad_setup(u, window, bias, sparsity):
    kw = dict(param_dtype="float32", fpdt_chunks=u, qkv_bias=bias, attn_sparsity=sparsity,
              block_q=16, block_k=16)
    jc = dataclasses.replace(j_reduced(j_get_config("llama3.2-1b")), **kw)
    jp = JL.init_attn(jc, jax.random.PRNGKey(3), jnp.float32)
    if bias:
        jp = {k: (v + 0.05 if k.startswith("b") else v) for k, v in jp.items()}
    return jc, {n: jp[n] for n in ("wq", "wk", "wv", "bq", "bk", "bv") if n in jp}


def _port_grads(x, do, u, *, window=0, bias=False, sparsity=0.0, offload=False):
    """[o, dx, dwq, dwk, dwv(, dbq, dbk, dbv)] of sum(o * do) through the
    port, as float32 numpy."""
    jc, jp = _grad_setup(u, window, bias, sparsity)
    tc = dataclasses.replace(reduced(get_config("llama3.2-1b")), fpdt_offload=offload,
                             **{k: getattr(jc, k) for k in ("param_dtype", "fpdt_chunks",
                                                            "qkv_bias", "attn_sparsity")})
    tp = {n: t.requires_grad_(True) for n, t in from_jax_params(jax.device_get(jp), "cpu").items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    to = F.fpdt_attention(tc, None, tp, tx, window=window)
    tg = torch.autograd.grad((to * torch.from_numpy(do)).sum(), [tx, *(tp[n] for n in jp)])
    return [to.detach().numpy()] + [g.numpy() for g in tg]


def _jax_grads(x, do, u, *, window=0, bias=False, sparsity=0.0):
    """The same list through the JAX package (Pallas in interpret mode,
    offload off)."""
    jc, jp = _grad_setup(u, window, bias, sparsity)
    jpar = JPar(mesh=None, attn_impl="pallas")

    def f(x, p):
        o = JF.fpdt_attention(jc, jpar, p, x, kind="local", window=window)
        return (o * do).sum(), o

    (_, jo), (jdx, jdp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jp)
    return [np.asarray(jo), np.asarray(jdx)] + [np.asarray(jdp[n]) for n in jp]


def _grads(x, do, u, **kw):
    return _port_grads(x, do, u, **kw), _jax_grads(x, do, u, **kw)


@pytest.fixture(scope="module")
def cotangent():
    return np.random.default_rng(8).standard_normal((B, S, 64)).astype(np.float32)


def _assert_grads(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=2e-4, atol=2e-4)
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("u", [1, 2, 4, 8])
def test_fpdt_grads_match_jax(inputs, cotangent, u):
    _assert_grads(*_grads(inputs, cotangent, u))


@pytest.mark.parametrize("window,u", [(8, 4), (24, 4), (24, 8)])
def test_fpdt_windowed_grads(inputs, cotangent, window, u):
    _assert_grads(*_grads(inputs, cotangent, u, window=window))


def test_fpdt_bias_grads(inputs, cotangent):
    got, want = _grads(inputs, cotangent, 4, bias=True)
    assert len(got) == 8 and np.abs(got[5]).sum() > 0  # bias grads flow
    _assert_grads(got, want)


def test_fpdt_sparse_grads(inputs, cotangent):
    _assert_grads(*_grads(inputs, cotangent, 4, sparsity=0.5))


def test_offload_on_off_equal(inputs, cotangent):
    """The port's host offload (the identity on the CPU, pinned host chunks
    on the card) changes where chunks wait, not what is computed."""
    on = _port_grads(inputs, cotangent, 4, window=24, offload=True)
    off = _port_grads(inputs, cotangent, 4, window=24, offload=False)
    for a, b_ in zip(on, off):
        np.testing.assert_array_equal(a, b_)


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
