"""FPDT's distributed kinds against the JAX package's single-device
attention.

In this process the JAX ``fpdt_attention`` runs at ``kind="local"`` (mesh
None, offload off, Pallas in interpret mode, as the port's other tests run
it) on numpy inputs from a seed: the output and the gradients of x and the
q/k/v projections under a random cotangent.  Then one spawn of 4 gloo ranks
on the CPU (``tests/_torch_dist.py``, torch only) builds meshes 1 x 4 and
2 x 2 (model groups of 4 and of 2 ranks) and runs the port's
``fpdt_attention`` on each rank's rows and tokens, with offload requested,
at u in {1, 4}: ``ulysses`` with heads 4/2 (KV gathered on the 4-rank
group, through the all-to-all on the 2-rank one), ``ulysses`` 8/4 (KV
through the all-to-all), ``ulysses`` 12/3 (KV gathered; on 4 ranks a rank's
q heads read two kv heads unevenly, whose gradients ``kv_back`` sums) and
``cp`` 6/6 (the cases of ``tests/distributed/check_fpdt_mesh.py`` and two
more).  Each rank's slice of
the output and of dx, and dW summed over the world, must be within 2e-4
(output) and 5e-4 (gradients) of the reference.  Where KV is gathered
(cp 6/6 and ulysses 12/3 on both meshes, u = 4) the same call with offload
off must give the same bits on every rank, and the ``gather_seq`` counts
must be those reckoned from ``core/fpdt.py``: with offload the store keeps
the rank's own slice, so each chunk is gathered once fresh, again for
every live off-diagonal pair that fetches it, and once in the backward;
without, once."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import (FPDT_CASES, FPDT_MESHES, FPDT_OFFLOAD_CASES, FPDT_US, fpdt_key,
                         run_ranks)
from repro.configs import get_config, reduced
from repro.core import fpdt as JF
from repro.core.parallel import ParallelContext as JPar
from repro.models import layers as JL

B, S = 2, 64
TOL_OUT, TOL_GRAD = 2e-4, 5e-4


def _reference(hq, hkv, u, seed):
    cfg = dataclasses.replace(reduced(get_config("llama3.2-1b")), param_dtype="float32",
                              num_heads=hq, num_kv_heads=hkv, fpdt_chunks=u,
                              fpdt_offload=False)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    do = rng.standard_normal((B, S, cfg.q_dim)).astype(np.float32)
    p = {n: w for n, w in JL.init_attn(cfg, jax.random.PRNGKey(seed), jnp.float32).items()
         if n in ("wq", "wk", "wv")}
    par = JPar(mesh=None, attn_impl="pallas", offload_to_host=False)

    def f(x, p):
        o = JF.fpdt_attention(cfg, par, p, x, kind="local")
        return (o * do).sum(), o

    (_, o), (dx, dp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), p)
    key = fpdt_key(hq, hkv, u)
    out = {f"{key}/x": x, f"{key}/do": do, f"{key}/o": np.asarray(o), f"{key}/dx": np.asarray(dx)}
    for n in ("wq", "wk", "wv"):
        out[f"{key}/{n}"] = np.asarray(p[n])
        out[f"{key}/d{n}"] = np.asarray(dp[n])
    return out


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fpdt")
    ref = {}
    for n, (_, hq, hkv) in enumerate(FPDT_CASES):
        for u in FPDT_US:
            ref.update(_reference(hq, hkv, u, seed=n))
    np.savez(tmp / "fpdt.npz", **ref)
    ranks = run_ranks("fpdt", 4, tmp)
    return ranks


@pytest.mark.parametrize("shape", FPDT_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind,hq,hkv", FPDT_CASES, ids=lambda v: str(v))
@pytest.mark.parametrize("u", FPDT_US)
def test_distributed_fpdt_matches_jax_local(readings, shape, kind, hq, hkv, u):
    case = f"{shape[0]}x{shape[1]} {kind} {fpdt_key(hq, hkv, u)}"
    for rank, got in enumerate(readings):
        errs = got[case]
        assert errs["o"] <= TOL_OUT, (rank, case, errs)
        for part in ("dx", "dwq", "dwk", "dwv"):
            assert errs[part] <= TOL_GRAD, (rank, case, part, errs)


def _gathers(hkv, u, sp, dp):
    """(calls, bytes) of gather_seq in one forward and backward of a layer
    whose KV is gathered, with offload on and off: a rank hands in its own
    [rows, hkv, S/u/sp, dh] fp32 k or v each time."""
    cfg = reduced(get_config("llama3.2-1b"))
    size = (B // dp) * hkv * (S // u // sp) * cfg.head_dim * 4
    fetched = u * (u - 1) // 2  # live off-diagonal pairs: no window, no sparsity
    on = 2 * u + 2 * fetched + 2 * u  # fresh, each fetch in the forward, the backward's
    off = 2 * u
    return {"on": [on, on * size], "off": [off, off * size]}


@pytest.mark.parametrize("shape", FPDT_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind,hq,hkv", FPDT_OFFLOAD_CASES, ids=lambda v: str(v))
def test_gathered_kv_offload_keeps_own_slice_same_bits(readings, shape, kind, hq, hkv):
    case = f"offload {shape[0]}x{shape[1]} {kind} {fpdt_key(hq, hkv, 4)}"
    for rank, got in enumerate(readings):
        assert got[case]["same_bits"], (rank, case)


@pytest.mark.parametrize("shape", FPDT_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind,hq,hkv", FPDT_OFFLOAD_CASES, ids=lambda v: str(v))
def test_gathered_kv_offload_gather_counts(readings, shape, kind, hq, hkv):
    case = f"offload {shape[0]}x{shape[1]} {kind} {fpdt_key(hq, hkv, 4)}"
    want = _gathers(hkv, 4, shape[1], shape[0])
    for rank, got in enumerate(readings):
        assert got[case]["gather_seq"] == want, (rank, case, got[case]["gather_seq"], want)
