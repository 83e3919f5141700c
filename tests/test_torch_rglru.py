"""repro_torch's RG-LRU block against the JAX package's on the same numpy
parameters and inputs: ``causal_conv1d`` with and without a carried state,
``rglru_mixer``'s output, carried state and gradients (every parameter and
the input) against JAX ``rglru_mixer(scan_impl="pallas")`` (the
linear-scan kernel in interpret mode), ``rglru_decode_step`` in fp32 and
bf16, the parameter layout and dtypes of ``init_rglru``, and the
recurrentgemma-9b config.  Tolerances: the output
2e-4 and the gradients 5e-4 of each leaf's largest magnitude
(tests/test_fpdt.py's FPDT limits); the conv 1e-5 (one product and sum)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models import mamba as JM
from repro.models import rglru as JR
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_params
from repro_torch.models import mamba as M
from repro_torch.models import rglru as R
from repro_torch.tree import tree_leaves

B, S = 2, 24


def _cfgs():
    jc = dataclasses.replace(j_reduced(j_get_config("recurrentgemma-9b")), param_dtype="float32")
    tc = dataclasses.replace(reduced(get_config("recurrentgemma-9b")), param_dtype="float32")
    return jc, tc


def _params(seed=0):
    """JAX RG-LRU parameters with the gate biases moved off zero, and the
    same as torch tensors."""
    jc, _ = _cfgs()
    jp = JR.init_rglru(jc, jax.random.PRNGKey(seed), jnp.float32)
    rng = np.random.default_rng(seed)
    for name in ("b_a", "b_i", "conv_b"):
        jp[name] = jnp.asarray(0.3 * rng.standard_normal(jp[name].shape), jnp.float32)
    return jp, from_jax_params(jax.device_get(jp), "cpu")


def _rel_close(got, want, tol, name=""):
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), f"{name}: {err:.3e} vs max {np.abs(want).max():.3e}"


def test_config_matches_the_jax_registry():
    jc, tc = j_get_config("recurrentgemma-9b"), get_config("recurrentgemma-9b")
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert dataclasses.asdict(j_reduced(jc)) == dataclasses.asdict(reduced(tc))
    assert tc.num_params() == jc.num_params()
    eight = get_config("recurrentgemma-9b", num_layers=8)
    assert eight.num_params() == j_get_config("recurrentgemma-9b", num_layers=8).num_params()


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    rng = np.random.default_rng(1)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((B, S, 12), (4, 12), (12,)))
    st = rng.standard_normal((B, 3, 12)).astype(np.float32) if with_state else None
    jy, jst = JM.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               None if st is None else jnp.asarray(st))
    ty, tst = M.causal_conv1d(*map(torch.from_numpy, (x, w, b)),
                              None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), rtol=0, atol=0)


@pytest.mark.parametrize("with_state", [False, True])
def test_mixer_output_and_grads_match_jax(with_state):
    jc, tc = _cfgs()
    jp, tp = _params()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    w = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    state = None
    if with_state:
        state = {"conv": rng.standard_normal((B, jc.d_conv - 1, jc.d_inner)).astype(np.float32),
                 "h": rng.standard_normal((B, jc.d_inner)).astype(np.float32)}
    jstate = None if state is None else {k: jnp.asarray(v) for k, v in state.items()}
    tstate = None if state is None else {k: torch.from_numpy(v) for k, v in state.items()}

    def jloss(p, x):
        y, _ = JR.rglru_mixer(jc, p, x, jstate, scan_impl="pallas")
        return (y * w).sum()

    jy, jnew = JR.rglru_mixer(jc, jp, jnp.asarray(x), jstate, scan_impl="pallas")
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_(True)
    tparams = dict(zip(sorted(tp), leaves))
    ty, tnew = R.rglru_mixer(tc, tparams, tx, tstate)
    _rel_close(ty, jy, 2e-4, "out")
    _rel_close(tnew["h"], jnew["h"], 2e-4, "h")
    np.testing.assert_allclose(tnew["conv"].detach().numpy(), np.asarray(jnew["conv"]), 0, 0)
    grads = torch.autograd.grad((ty * torch.from_numpy(w)).sum(), [*leaves, tx])
    for name, g in zip(sorted(tp), grads):
        assert g.dtype == tparams[name].dtype
        _rel_close(g, jgp[name], 5e-4, name)
    _rel_close(grads[-1], jgx, 5e-4, "x")


def test_init_layout_and_dtypes_match_jax():
    """A bf16 model keeps Lambda and the gate biases in fp32, as JAX does."""
    jc, tc = (dataclasses.replace(c, param_dtype="bfloat16") for c in _cfgs())
    jp = JR.init_rglru(jc, jax.random.PRNGKey(0), jnp.bfloat16)
    tp = R.init_rglru(tc, torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    assert sorted(tp) == sorted(jp)
    for name in jp:
        assert tuple(tp[name].shape) == jp[name].shape, name
        assert str(tp[name].dtype) == f"torch.{jp[name].dtype}", name
    assert {n for n in tp if tp[n].dtype == torch.float32} == {"lam", "b_a", "b_i"}
    # a^c at r = 1 in (0.9, 0.999), the init's target band
    a8 = torch.exp(-R.C_FACTOR * R._softplus(tp["lam"]))
    assert bool(((a8 > 0.9) & (a8 < 0.999)).all())


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 3e-2)])
def test_decode_step_matches_jax(dtype, tol):
    """One token against a carried conv and h: the output and both new
    states, against JAX ``rglru_decode_step``."""
    jc, tc = (dataclasses.replace(c, param_dtype=dtype) for c in _cfgs())
    jp = JR.init_rglru(jc, jax.random.PRNGKey(4), jnp.dtype(dtype))
    rng = np.random.default_rng(4)
    for name in ("b_a", "b_i"):
        jp[name] = jnp.asarray(0.3 * rng.standard_normal(jp[name].shape), jnp.float32)
    tp = from_jax_params(jax.device_get(jp), "cpu")
    x = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
    conv = rng.standard_normal((B, jc.d_conv - 1, jc.d_inner)).astype(np.float32)
    h = rng.standard_normal((B, jc.d_inner)).astype(np.float32)
    tdt = getattr(torch, dtype)
    jy, jnew = JR.rglru_decode_step(jc, jp, jnp.asarray(x, jnp.dtype(dtype)),
                                    {"conv": jnp.asarray(conv, jnp.dtype(dtype)),
                                     "h": jnp.asarray(h)})
    ty, tnew = R.rglru_decode_step(tc, tp, torch.from_numpy(x).to(tdt),
                                   {"conv": torch.from_numpy(conv).to(tdt),
                                    "h": torch.from_numpy(h)})
    assert ty.dtype == tdt and tnew["h"].dtype == torch.float32
    _rel_close(ty, jy, tol, "out")
    _rel_close(tnew["h"], jnew["h"], tol, "h")
    np.testing.assert_array_equal(tnew["conv"].float().numpy(),
                                  np.asarray(jnew["conv"], np.float32))


def test_softplus_is_jax_softplus_beyond_torch_threshold():
    x = np.array([-30.0, -1.0, 0.0, 5.0, 19.0, 21.0, 40.0], np.float32)
    np.testing.assert_allclose(R._softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=0)

