"""The sequence-parallel recurrent mixers against the JAX package.

In this process JAX computes, on numpy inputs from a seed (fp32, b 2, s
64, the reduced recurrentgemma-9b and falcon-mamba-7b configs):
``rglru_mixer`` (Pallas scan in interpret mode) and ``mamba_mixer`` with
``n_shards=1``, with and without a given state: the output, the new state
and the gradients of the input, every parameter and the state under a
random cotangent; ``dist_linear_scan`` and ``selective_scan_dist`` at
``n_shards`` = u*sp, with each shard's summary from its own scan from
zero state; ``causal_conv1d`` over the whole sequence.

One spawn of 4 gloo ranks on the CPU (``tests/_torch_dist.py``, torch
only) runs the port on meshes 1 x 4 and 2 x 2 at u in {1, 4}, each rank on
its rows and its tokens of the chunk-interleaved layout (span i of rank m
is span i*sp + m of u*sp): the mixers' outputs, new states, dx, and dW and
the state's gradients summed over the world within 2e-4 (outputs) and 5e-4
(gradients) of each reference's largest magnitude (tests/test_fpdt.py's
FPDT limits); pass 1's summaries of the rank's spans and the two passes
within 1e-5 (tests/test_kernels_linear_scan.py's forward limit); the conv
with its halo from the previous rank, at every token and at the span
starts apart, and dx through the gather's adjoint, within 1e-5; each
mixer's collectives at u = 4 as reckoned (the halo's and the summaries'
gather forward, their reduce-scatter backward); and the ValueError of a
span shorter than the conv's halo."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import (REC_B, REC_MESHES, REC_MIXERS, REC_S, REC_US, rec_cfg, run_ranks)
from repro import configs as jconfigs
from repro.models import mamba as JM
from repro.models import rglru as JR

TOL_OUT, TOL_GRAD, TOL_SCAN = 2e-4, 5e-4, 1e-5
MESHES = [f"{d}x{m}" for d, m in REC_MESHES]
SPANS = sorted({u * m for _, m in REC_MESHES for u in REC_US})  # n = u*sp


def _mixer_refs(mixer, seed):
    """The JAX mixer's readings with and without a state."""
    cfg = rec_cfg(jconfigs, mixer)
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    if mixer == "rglru":
        p = JR.init_rglru(cfg, key, jnp.float32)
        moved, hkey = ("b_a", "b_i", "conv_b"), "h"
        state_shapes = {"conv": (REC_B, cfg.d_conv - 1, cfg.d_inner), "h": (REC_B, cfg.d_inner)}

        def fn(p, x, state):
            return JR.rglru_mixer(cfg, p, x, state, scan_impl="pallas")
    else:
        p = JM.init_mamba(cfg, key, jnp.float32)
        p["D"] = jnp.asarray(1 + 0.3 * rng.standard_normal(p["D"].shape), jnp.float32)
        moved, hkey = ("conv_b",), "ssm"
        state_shapes = {"conv": (REC_B, cfg.d_conv - 1, cfg.d_inner),
                        "ssm": (REC_B, cfg.d_inner, cfg.ssm_state)}

        def fn(p, x, state):
            return JM.mamba_mixer(cfg, p, x, state)
    for name in moved:  # off their zero init, so their gradients are tested
        p[name] = jnp.asarray(0.3 * rng.standard_normal(p[name].shape), jnp.float32)
    x = rng.standard_normal((REC_B, REC_S, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((REC_B, REC_S, cfg.d_model)).astype(np.float32)
    state = {k: (0.5 * rng.standard_normal(s)).astype(np.float32)
             for k, s in state_shapes.items()}
    out = {f"{mixer}/x": x, f"{mixer}/dy": dy, **{f"{mixer}/{k}": v for k, v in state.items()},
           **{f"{mixer}/p/{n}": np.asarray(v) for n, v in p.items()}}
    for st in ("none", "state"):
        given = {k: jnp.asarray(v) for k, v in state.items()} if st == "state" else None
        (y, new), vjp = jax.vjp(jax.jit(fn), p, jnp.asarray(x), given)
        dp, dx, ds = vjp((jnp.asarray(dy), jax.tree.map(jnp.zeros_like, new)))
        key = f"{mixer}/{st}"
        out.update({f"{key}/y": np.asarray(y), f"{key}/dx": np.asarray(dx),
                    **{f"{key}/new_{k}": np.asarray(new[k]) for k in ("conv", hkey)},
                    **{f"{key}/d{n}": np.asarray(g) for n, g in dp.items()}})
        if st == "state":
            out.update({f"{key}/dstate_{k}": np.asarray(g) for k, g in ds.items()})
    return out


def _scan_refs(seed):
    """dist_linear_scan and selective_scan_dist at each n, and each shard's
    own scan from zero state (its summary)."""
    rng = np.random.default_rng(seed)
    ch, di, ds = 8, 8, 4
    a = rng.uniform(0.5, 0.99, (REC_B, REC_S, ch)).astype(np.float32)
    b = rng.standard_normal((REC_B, REC_S, ch)).astype(np.float32)
    h0 = rng.standard_normal((REC_B, ch)).astype(np.float32)
    xc = rng.standard_normal((REC_B, REC_S, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((REC_B, REC_S, di)) - 2)).astype(np.float32)
    A_log = np.log(np.tile(np.arange(1, ds + 1, dtype=np.float32), (di, 1)))
    Bm = rng.standard_normal((REC_B, REC_S, ds)).astype(np.float32)
    Cm = rng.standard_normal((REC_B, REC_S, ds)).astype(np.float32)
    mh0 = rng.standard_normal((REC_B, di, ds)).astype(np.float32)
    out = {"rscan/a": a, "rscan/b": b, "rscan/h0": h0, "mscan/xc": xc, "mscan/dt": dt,
           "mscan/A_log": A_log, "mscan/B": Bm, "mscan/C": Cm, "mscan/h0": mh0}
    # jitted: eager JAX dispatches the associative scans op by op
    linear = jax.jit(JR.dist_linear_scan, static_argnums=2)
    selective = jax.jit(JM.selective_scan_dist, static_argnames="n_shards")
    for n in SPANS:
        L = REC_S // n
        out[f"rscan/n{n}/h"] = np.asarray(linear(jnp.asarray(a), jnp.asarray(b), n,
                                                 jnp.asarray(h0)))
        y, h_last = selective(*map(jnp.asarray, (xc, dt, A_log, Bm, Cm, mh0)), n_shards=n)
        out[f"mscan/n{n}/y"], out[f"mscan/n{n}/h_last"] = np.asarray(y), np.asarray(h_last)

        def shards(t):  # [b, s, f] -> [b*n, L, f]: each shard its own row
            return jnp.asarray(t.reshape(REC_B * n, L, t.shape[-1]))

        out[f"rscan/n{n}/h_loc"] = np.asarray(linear(shards(a), shards(b), 1))[:, -1].reshape(
            REC_B, n, ch)
        out[f"rscan/n{n}/log_A"] = np.log(a.astype(np.float64)).reshape(
            REC_B, n, L, ch).sum(2).astype(np.float32)
        _, h_loc = JM.selective_scan(shards(xc), shards(dt), jnp.asarray(A_log), shards(Bm),
                                     shards(Cm))
        out[f"mscan/n{n}/h_loc"] = np.asarray(h_loc).reshape(REC_B, n, di, ds)
        out[f"mscan/n{n}/sum_dt"] = dt.astype(np.float64).reshape(
            REC_B, n, L, di).sum(2).astype(np.float32)
    return out


def _conv_refs(seed):
    rng = np.random.default_rng(seed)
    ch, k = 8, 4
    x = rng.standard_normal((REC_B, REC_S, ch)).astype(np.float32)
    w = rng.standard_normal((k, ch)).astype(np.float32)
    b = rng.standard_normal((ch,)).astype(np.float32)
    state = rng.standard_normal((REC_B, k - 1, ch)).astype(np.float32)
    dy = rng.standard_normal((REC_B, REC_S, ch)).astype(np.float32)
    (y, new), vjp = jax.vjp(lambda x: JM.causal_conv1d(x, jnp.asarray(w), jnp.asarray(b),
                                                       jnp.asarray(state)), jnp.asarray(x))
    (dx,) = vjp((jnp.asarray(dy), jnp.zeros_like(new)))
    return {"conv/x": x, "conv/w": w, "conv/b": b, "conv/state": state, "conv/dy": dy,
            "conv/y": np.asarray(y), "conv/new_state": np.asarray(new), "conv/dx": np.asarray(dx)}


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("recurrent")
    ref = {**_mixer_refs("rglru", 0), **_mixer_refs("mamba", 1), **_scan_refs(2),
           **_conv_refs(3)}
    np.savez(tmp / "recurrent.npz", **ref)
    return run_ranks("recurrent", 4, tmp)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("u", REC_US)
@pytest.mark.parametrize("mixer", REC_MIXERS)
@pytest.mark.parametrize("state", ["none", "state"])
def test_mixer_matches_jax_single_device(readings, mesh, u, mixer, state):
    for rank, got in enumerate(readings):
        errs = got[f"{mesh} u{u} {mixer}/{state}"]["errs"]
        for part, err in errs.items():
            out = part == "y" or part.startswith("new_")
            assert err <= (TOL_OUT if out else TOL_GRAD), (rank, part, errs)
        if state == "state":
            assert {"dstate_conv", "new_conv"} <= set(errs), errs


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("u", REC_US)
@pytest.mark.parametrize("scan", REC_MIXERS)
def test_pass1_summaries_match_jax_shards(readings, mesh, u, scan):
    for rank, got in enumerate(readings):
        errs = got[f"{mesh} u{u} {scan} summaries"]
        assert max(errs.values()) <= TOL_SCAN, (rank, errs)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("u", REC_US)
@pytest.mark.parametrize("scan", REC_MIXERS)
def test_two_pass_scan_matches_jax_dist_scan(readings, mesh, u, scan):
    """Against dist_linear_scan / selective_scan_dist with n_shards = u*sp."""
    for rank, got in enumerate(readings):
        errs = got[f"{mesh} u{u} {scan} two-pass"]
        assert max(errs.values()) <= TOL_SCAN, (rank, errs)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("u", REC_US)
def test_conv_halo_crosses_ranks(readings, mesh, u):
    for rank, got in enumerate(readings):
        errs = got[f"{mesh} u{u} conv"]
        assert max(errs.values()) <= TOL_SCAN, (rank, errs)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mixer", REC_MIXERS)
def test_mixer_collectives_as_reckoned(readings, mesh, mixer):
    """At u = 4: a gather of the [rows, u, k-1, di] conv tails and one of
    the fp32 summaries ([rows, u, 2 di] for RG-LRU, [rows, u, di + di ds]
    for Mamba), and in the backward a reduce-scatter of each, sp times the
    bytes; nothing else."""
    u, sp = 4, int(mesh.split("x")[1])
    cfg = rec_cfg(jconfigs, mixer)
    di = cfg.d_inner
    width = 2 * di if mixer == "rglru" else di * (1 + cfg.ssm_state)
    for got in readings:
        case = got[f"{mesh} u{u} {mixer}/none"]
        sent = case["rows"] * u * ((cfg.d_conv - 1) * di + width) * 4
        assert case["counts"] == {"gather_spans": [2, sent],
                                  "reduce_scatter_spans": [2, sp * sent]}, case["counts"]


def test_span_shorter_than_the_conv_halo_raises(readings):
    for got in readings:
        assert "shorter than the conv's halo" in got["short span"], got["short span"]
