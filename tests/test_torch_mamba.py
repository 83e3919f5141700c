"""repro_torch's Mamba-1 block against the JAX package's on the same numpy
parameters and inputs: the falcon-mamba-7b config, ``init_mamba``'s
layout and dtypes, ``selective_scan`` (output, last state and gradients,
with and without h0, within one block and over two, and the block shape
both packages refuse), ``mamba_mixer`` in fp32 and bf16 (output, state and
gradients) and ``mamba_decode_step`` in fp32 and bf16.  The port runs the
scan's blocks through the ``linear_scan`` op (its plain version on the
CPU); the reference runs an associative scan.  Tolerances: the scan 1e-5
and its gradients 1e-4 (tests/test_kernels_linear_scan.py), the mixer
2e-4 and its gradients 5e-4 of each leaf's largest magnitude
(tests/test_fpdt.py), bf16 3e-2 (tests/test_kernels_flash.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models import mamba as JM
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_params
from repro_torch.models import mamba as M
from repro_torch.models import rglru as R
from repro_torch.tree import tree_leaves

ARCH = "falcon-mamba-7b"
B, S = 2, 24


def _cfgs(dtype="float32"):
    return (dataclasses.replace(j_reduced(j_get_config(ARCH)), param_dtype=dtype),
            dataclasses.replace(reduced(get_config(ARCH)), param_dtype=dtype))


def _params(dtype="float32", seed=0):
    """JAX Mamba parameters with the conv bias moved off zero and D off one,
    and the same as torch tensors."""
    jc, _ = _cfgs(dtype)
    jp = JM.init_mamba(jc, jax.random.PRNGKey(seed), jnp.dtype(dtype))
    rng = np.random.default_rng(seed)
    jp["conv_b"] = jnp.asarray(0.3 * rng.standard_normal(jp["conv_b"].shape), jnp.dtype(dtype))
    jp["D"] = jnp.asarray(1 + 0.3 * rng.standard_normal(jp["D"].shape), jnp.float32)
    return jp, from_jax_params(jax.device_get(jp), "cpu")


def _rel_close(got, want, tol, name=""):
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), \
        f"{name}: {err:.3e} vs max {np.abs(want).max():.3e}"


def test_config_matches_the_jax_registry():
    jc, tc = j_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert dataclasses.asdict(j_reduced(jc)) == dataclasses.asdict(reduced(tc))
    assert tc.num_params() == jc.num_params()
    cut = get_config(ARCH, num_layers=16)
    assert cut.num_params() == j_get_config(ARCH, num_layers=16).num_params()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_layout_and_dtypes_match_jax(dtype):
    """b_dt, A_log and D stay fp32 in a bf16 model, as in JAX; A_log is
    log(1..d_state) on every channel and softplus(b_dt) lies in the init's
    dt band [0.001, 0.1]."""
    jc, tc = _cfgs(dtype)
    jp = JM.init_mamba(jc, jax.random.PRNGKey(0), jnp.dtype(dtype))
    tp = M.init_mamba(tc, torch.Generator().manual_seed(0), getattr(torch, dtype), "cpu")
    assert sorted(tp) == sorted(jp)
    for name in jp:
        assert tuple(tp[name].shape) == jp[name].shape, name
        assert str(tp[name].dtype) == f"torch.{jp[name].dtype}", name
    np.testing.assert_array_equal(tp["A_log"].numpy(), np.asarray(jp["A_log"]))
    dt = M._softplus(tp["b_dt"])
    assert bool(((dt > 0.001 * 0.999) & (dt < 0.1 * 1.001)).all())


def _scan_inputs(s, with_h0, seed=1):
    """xc, dt (post-softplus, in the init's band), A_log, B, C and h0, fp32."""
    rng = np.random.default_rng(seed)
    di, ds = 8, 4
    xc = rng.standard_normal((B, s, di)).astype(np.float32)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.5), (B, s, di))).astype(np.float32)
    a_log = np.log(np.tile(np.arange(1, ds + 1, dtype=np.float32), (di, 1)))
    bm, cm = (rng.standard_normal((B, s, ds)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((B, di, ds)).astype(np.float32) if with_h0 else None
    return xc, dt, a_log, bm, cm, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [24, 512])
def test_selective_scan_matches_jax(s, with_h0):
    """Output and last state at 1e-5, gradients of every input at 1e-4; s =
    512 is two 256-token blocks with the state carried between them."""
    inputs = _scan_inputs(s, with_h0)
    rng = np.random.default_rng(2)
    wy = rng.standard_normal(inputs[0].shape).astype(np.float32)
    wh = rng.standard_normal((B, 8, 4)).astype(np.float32)
    n = 6 if with_h0 else 5

    def jloss(*args):
        y, h = JM.selective_scan(*args[:5], args[5] if with_h0 else None)
        return (y * wy).sum() + (h * wh).sum()

    jargs = [jnp.asarray(x) for x in inputs[:n]]
    jy, jh = JM.selective_scan(*jargs[:5], jargs[5] if with_h0 else None)
    jgrads = jax.grad(jloss, argnums=tuple(range(n)))(*jargs)
    targs = [torch.from_numpy(x).requires_grad_(True) for x in inputs[:n]]
    ty, th = M.selective_scan(*targs[:5], targs[5] if with_h0 else None)
    assert ty.dtype == th.dtype == torch.float32
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    tgrads = torch.autograd.grad((ty * torch.from_numpy(wy)).sum()
                                 + (th * torch.from_numpy(wh)).sum(), targs)
    for name, t, j in zip(("xc", "dt", "A_log", "B", "C", "h0"), tgrads, jgrads):
        _rel_close(t, j, 1e-4, name)


def test_selective_scan_refuses_a_block_that_does_not_divide_s():
    """min(256, s) must divide s: JAX asserts it, the port raises ValueError."""
    inputs = _scan_inputs(300, False)
    with pytest.raises(AssertionError):
        JM.selective_scan(*map(jnp.asarray, inputs[:5]))
    with pytest.raises(ValueError, match="must divide"):
        M.selective_scan(*map(torch.from_numpy, inputs[:5]))


def _state(jc, rng):
    return {"conv": rng.standard_normal((B, jc.d_conv - 1, jc.d_inner)).astype(np.float32),
            "ssm": rng.standard_normal((B, jc.d_inner, jc.ssm_state)).astype(np.float32)}


@pytest.mark.parametrize("with_state", [False, True])
def test_mixer_output_and_grads_match_jax(with_state):
    jc, tc = _cfgs()
    jp, tp = _params()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    w = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    state = _state(jc, rng) if with_state else None
    jstate = None if state is None else {k: jnp.asarray(v) for k, v in state.items()}
    tstate = None if state is None else {k: torch.from_numpy(v) for k, v in state.items()}

    def jloss(p, x):
        y, _ = JM.mamba_mixer(jc, p, x, jstate)
        return (y * w).sum()

    jy, jnew = JM.mamba_mixer(jc, jp, jnp.asarray(x), jstate)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_(True)
    tparams = dict(zip(sorted(tp), leaves))
    ty, tnew = M.mamba_mixer(tc, tparams, tx, tstate)
    _rel_close(ty, jy, 2e-4, "out")
    _rel_close(tnew["ssm"], jnew["ssm"], 2e-4, "ssm")
    np.testing.assert_allclose(tnew["conv"].detach().numpy(), np.asarray(jnew["conv"]), 0, 0)
    grads = torch.autograd.grad((ty * torch.from_numpy(w)).sum(), [*leaves, tx])
    for name, g in zip(sorted(tp), grads):
        assert g.dtype == tparams[name].dtype
        _rel_close(g, jgp[name], 5e-4, name)
    _rel_close(grads[-1], jgx, 5e-4, "x")


def test_bf16_mixer_close_to_jax():
    jc, tc = _cfgs("bfloat16")
    jp, tp = _params("bfloat16")
    x = np.random.default_rng(4).standard_normal((B, S, jc.d_model)).astype(np.float32)
    jy, jnew = JM.mamba_mixer(jc, jp, jnp.asarray(x, jnp.bfloat16))
    ty, tnew = M.mamba_mixer(tc, tp, torch.from_numpy(x).to(torch.bfloat16))
    assert ty.dtype == torch.bfloat16 and tnew["ssm"].dtype == torch.float32
    _rel_close(ty, jy, 3e-2, "out")
    _rel_close(tnew["ssm"], jnew["ssm"], 3e-2, "ssm")


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 3e-2)])
def test_decode_step_matches_jax(dtype, tol):
    """One token against a carried state: the output and both new states."""
    jc, tc = _cfgs(dtype)
    jp, tp = _params(dtype)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
    state = _state(jc, rng)
    jstate = {"conv": jnp.asarray(state["conv"], jnp.dtype(dtype)),
              "ssm": jnp.asarray(state["ssm"])}
    tstate = {"conv": torch.from_numpy(state["conv"]).to(getattr(torch, dtype)),
              "ssm": torch.from_numpy(state["ssm"])}
    jy, jnew = JM.mamba_decode_step(jc, jp, jnp.asarray(x, jnp.dtype(dtype)), jstate)
    ty, tnew = M.mamba_decode_step(tc, tp, torch.from_numpy(x).to(getattr(torch, dtype)),
                                   tstate)
    assert ty.dtype == getattr(torch, dtype) and tnew["ssm"].dtype == torch.float32
    _rel_close(ty, jy, tol, "out")
    _rel_close(tnew["ssm"], jnew["ssm"], tol, "ssm")
    np.testing.assert_array_equal(tnew["conv"].float().numpy(),
                                  np.asarray(jnew["conv"], np.float32))


def test_decode_steps_continue_the_mixer():
    """The mixer over s tokens then one decode step equals the mixer over
    s + 1 tokens at the last position: the state hand-off is exact up to
    fp32 rounding."""
    _, tc = _cfgs()
    _, tp = _params()
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, S + 1, tc.d_model)).astype(np.float32))
    with torch.no_grad():
        full, _ = M.mamba_mixer(tc, tp, x)
        _, st = M.mamba_mixer(tc, tp, x[:, :S])
        step, _ = M.mamba_decode_step(tc, tp, x[:, S:], st)
    _rel_close(step[:, 0], full[:, S].numpy(), 2e-5, "last token")


def test_softplus_lives_in_mamba_and_rglru_keeps_it():
    assert R._softplus is M._softplus

