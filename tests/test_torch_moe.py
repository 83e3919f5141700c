"""The port's MoE FFN (``models/moe.py``) against the JAX package's.

The same numpy inputs (from a seed) and the same converted parameters go
through ``repro.models.moe`` and ``repro_torch.models.moe``.  Each case
first asserts that the routing is the reference's, as integers: the top-k
expert indices and the keep masks (queue position below capacity) equal
those of the JAX routing, which ``_jax_routing`` computes with the JAX
package's own lines; a mismatch names the token and the gap between its
k-th and (k+1)-th gates.  Then ``moe_ffn``'s y and aux, at one group and
at two groups of GROUP_TOKENS, for reduced granite-moe-1b-a400m (4
experts, top-2), granite's own routing width (32 experts, top-8) and
reduced llama4-maverick (top-1: the weight is exactly 1); a capacity drop
at ``moe_capacity_factor=1.0`` that drops the same tokens; ``moe_ffn_chunked``
over 4 chunks; the decode shape (b tokens, one group, capacity 4); the
gradients of x and of every leaf in fp32 and bf16.  Tolerances: fp32
forward 1e-5, gradients 1e-5 (x) and 1e-4 (leaves), bf16 3e-2
(tests/test_kernels_flash.py's), each relative to the reference's largest
magnitude.

The mesh plan is held in one process: every rank's counts
(``local_counts``) stacked as the all-gather stacks them, each rank's
``moe_planned`` output equals one rank's ``moe_ffn`` calls, chunk by
chunk, at its tokens, and the ranks' aux shares sum to their mean aux, on layouts where groups and
chunks span model ranks, data ranks, both, or none."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models import moe as JMOE
from repro_torch.configs import get_config, reduced
from repro_torch.convert import from_jax_params
from repro_torch.data.pipeline import token_positions
from repro_torch.models import moe as MOE

GRANITE, LLAMA4 = "granite-moe-1b-a400m", "llama4-maverick-400b-a17b"
# name -> (arch, overrides of the reduced config)
ROUTINGS = {"granite-reduced": (GRANITE, {}),
            "granite-routing": (GRANITE, dict(num_experts=32, experts_per_token=8)),
            "llama4-reduced": (LLAMA4, {})}


def _cfgs(name, dtype="float32", **kw):
    arch, over = ROUTINGS[name]
    kw = dict(param_dtype=dtype, **over, **kw)
    return (dataclasses.replace(j_reduced(j_get_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


def _params(jc, seed=0):
    jp = JMOE.init_moe(jc, jax.random.PRNGKey(seed), jnp.dtype(jc.param_dtype))
    return jp, from_jax_params(jax.device_get(jp), "cpu")


def _x(shape, dtype="float32", seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _jax_routing(cfg, p, x):
    """The JAX moe_ffn's routing (src/repro/models/moe.py, its own lines):
    (topi [T, k], keep [T, k], gates [T, e]) as numpy."""
    return jax.tree.map(np.asarray, jax.jit(lambda p, x: _jax_routing_fn(cfg, p, x))(p, x))


def _jax_routing_fn(cfg, p, x):
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    tg = min(JMOE.GROUP_TOKENS, b * s)
    g = (b * s) // tg
    cap = JMOE.capacity(tg, cfg)
    xt = x.reshape(g, tg, d)
    gates = jax.nn.softmax((xt.astype(jnp.float32) @ p["router"]).astype(jnp.float32), axis=-1)
    _, topi = jax.lax.top_k(gates, k)
    flat = jax.nn.one_hot(topi, e, dtype=jnp.int32).reshape(g, tg * k, e)
    pos = ((jnp.cumsum(flat, axis=1) - 1) * flat).sum(-1).reshape(g, tg, k)
    return topi.reshape(-1, k), (pos < cap).reshape(-1, k), gates.reshape(-1, e)


def _port_routing(cfg, p, x):
    topi, keep = MOE.routing(cfg, p, x, 1)
    k = cfg.experts_per_token
    return topi.reshape(-1, k).numpy(), keep.reshape(-1, k).numpy()


def _assert_same_routing(jc, jp, jx, tc, tp, tx):
    jtopi, jkeep, gates = _jax_routing(jc, jp, jx)
    ttopi, tkeep = _port_routing(tc, tp, tx)
    bad = np.nonzero((jtopi != ttopi).any(-1))[0]
    if len(bad):
        t = int(bad[0])
        srt = np.sort(gates[t])[::-1]
        k = jc.experts_per_token
        gap = srt[k - 1] - srt[k] if k < len(srt) else np.inf
        raise AssertionError(f"token {t} routes to {ttopi[t]} in the port, {jtopi[t]} in JAX; "
                             f"its k-th and (k+1)-th gates differ by {gap:.3e}")
    np.testing.assert_array_equal(tkeep, jkeep)
    return jkeep


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("shape", [(2, 64), (2, 512)])
@pytest.mark.parametrize("name", sorted(ROUTINGS))
def test_moe_ffn_matches_jax(name, shape):
    """One group of 128 tokens (folding both rows) and two of 512."""
    jc, tc = _cfgs(name)
    jp, tp = _params(jc)
    jx, tx = _x((*shape, jc.d_model))
    _assert_same_routing(jc, jp, jx, tc, tp, tx)
    jy, jaux = jax.jit(lambda p, x: JMOE.moe_ffn(jc, p, x))(jp, jx)
    ty, taux = MOE.moe_ffn(tc, tp, tx)
    _close(ty.numpy(), jy, 1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    if jc.experts_per_token == 1:  # top-1: the renormalised weight is exactly 1
        _, topv, _ = MOE.route(tc, tp, tx.reshape(-1, tc.d_model))
        assert torch.equal(topv, torch.ones_like(topv))


def test_capacity_drop_matches_jax():
    """At capacity factor 1.0 the busiest experts overflow: the same
    (token, choice) pairs are dropped, and their outputs go missing alike."""
    jc, tc = _cfgs("granite-reduced", moe_capacity_factor=1.0)
    jp, tp = _params(jc, seed=3)
    jx, tx = _x((2, 64, jc.d_model), seed=4)
    keep = _assert_same_routing(jc, jp, jx, tc, tp, tx)
    assert not keep.all(), "no pair was dropped: the case does not test capacity"
    assert keep.any()
    jy, jaux = jax.jit(lambda p, x: JMOE.moe_ffn(jc, p, x))(jp, jx)
    ty, taux = MOE.moe_ffn(tc, tp, tx)
    _close(ty.numpy(), jy, 1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("name", ["granite-reduced", "granite-routing"])
def test_moe_ffn_chunked_matches_jax(name):
    jc, tc = _cfgs(name)
    jp, tp = _params(jc)
    jx, tx = _x((2, 64, jc.d_model))
    topi, keep = MOE.routing(tc, tp, tx, 4)
    for c in range(4):  # each chunk's routing, alone and in the chunked call's
        sl = slice(16 * c, 16 * (c + 1))
        _assert_same_routing(jc, jp, jx[:, sl], tc, tp, tx[:, sl])
        jtopi, jkeep, _ = _jax_routing(jc, jp, jx[:, sl])
        np.testing.assert_array_equal(topi[:, sl].reshape(jtopi.shape).numpy(), jtopi)
        np.testing.assert_array_equal(keep[:, sl].reshape(jkeep.shape).numpy(), jkeep)
    jy, jaux = jax.jit(lambda p, x: JMOE.moe_ffn_chunked(jc, p, x, 4))(jp, jx)
    ty, taux = MOE.moe_ffn_chunked(tc, tp, tx, 4)
    _close(ty.numpy(), jy, 1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("seq,n", [(64, 4), (18, 2)])
def test_chunked_on_one_rank_is_moe_ffn_per_chunk(seq, n):
    """One rank's chunked call goes through the chunk plan; it gives the
    bits of one ``moe_ffn`` a chunk, with the chunks' mean aux, also where
    fpdt_chunks does not divide the length (18 at u = 4)."""
    _, tc = _cfgs("granite-reduced", fpdt_chunks=4)
    tp = MOE.init_moe(tc, torch.Generator().manual_seed(0), torch.float32, "cpu")
    _, tx = _x((2, seq, tc.d_model))
    y, aux = MOE.moe_ffn_chunked(tc, tp, tx, n)
    parts = [MOE.moe_ffn(tc, tp, xc) for xc in tx.chunk(n, dim=1)]
    assert torch.equal(y, torch.cat([p[0] for p in parts], dim=1))
    assert torch.equal(aux, torch.stack([p[1] for p in parts]).mean())


def test_decode_shape_matches_jax():
    """Decode's [b, 1, d]: the b tokens are one group, capacity 4 (granite's
    top-8 of 32 at b 4), so nothing is dropped."""
    jc, tc = _cfgs("granite-routing")
    jp, tp = _params(jc)
    jx, tx = _x((4, 1, jc.d_model))
    assert MOE.capacity(4, tc) == 4
    keep = _assert_same_routing(jc, jp, jx, tc, tp, tx)
    assert keep.all()
    jy, jaux = jax.jit(lambda p, x: JMOE.moe_ffn(jc, p, x))(jp, jx)
    ty, taux = MOE.moe_ffn(tc, tp, tx)
    _close(ty.numpy(), jy, 1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["granite-reduced", "granite-routing"])
def test_gradients_match_jax(name, dtype):
    """d/dx and d/dW of sum(y * dy) + 0.7 aux, with drops (capacity factor
    1.0): fp32 at 1e-5 (x) and 1e-4 (leaves), bf16 at 3e-2."""
    jc, tc = _cfgs(name, dtype, moe_capacity_factor=1.0)
    jp, tp = _params(jc, seed=5)
    jx, tx = _x((2, 64, jc.d_model), dtype, seed=6)
    dy = np.random.default_rng(7).standard_normal((2, 64, jc.d_model)).astype(np.float32)
    _assert_same_routing(jc, jp, jx, tc, tp, tx)

    def jf(p, x):
        y, aux = JMOE.moe_ffn(jc, p, x)
        return jnp.sum(y.astype(jnp.float32) * dy) + 0.7 * aux

    jgp, jgx = jax.jit(jax.grad(jf, argnums=(0, 1)))(jp, jx)
    tx = tx.clone().requires_grad_(True)
    tpg = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    y, aux = MOE.moe_ffn(tc, tpg, tx)
    ((y.float() * torch.from_numpy(dy)).sum() + 0.7 * aux).backward()
    tol_x, tol_w = (1e-5, 1e-4) if dtype == "float32" else (3e-2, 3e-2)
    _close(tx.grad.float().numpy(), np.asarray(jgx, np.float32), tol_x)
    assert sorted(tpg) == sorted(jgp)
    for k in tpg:
        assert tpg[k].grad.dtype == tp[k].dtype
        _close(tpg[k].grad.float().numpy(), np.asarray(jgp[k], np.float32), tol_w)


def test_router_stays_fp32_in_bf16():
    _, tc = _cfgs("granite-reduced", "bfloat16")
    p = MOE.init_moe(tc, torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    assert p["router"].dtype == torch.float32
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (64, 4), "wu": (4, 64, 32), "wg": (4, 64, 32), "wd": (4, 32, 64)}


# --------------------------------------------------------------------------
# the mesh plan, every rank in this process
# --------------------------------------------------------------------------

# (dp, sp, B, S, u, n, what spans ranks)
LAYOUTS = [
    (1, 4, 2, 64, 2, 2, "groups and chunks over model ranks"),
    (2, 2, 2, 64, 2, 2, "groups and chunks over data and model ranks"),
    (2, 1, 2, 64, 1, 4, "groups and chunks over data ranks"),
    (1, 4, 2, 64, 2, 8, "nothing: every chunk is one rank's span"),
    (1, 2, 1, 2048, 2, 1, "four groups of 512, each over both ranks or one"),
    (1, 2, 2, 1024, 4, 2, "groups within a chunk, some over both ranks"),
]


@pytest.mark.parametrize("layout", LAYOUTS, ids=[x[-1] for x in LAYOUTS])
def test_mesh_plan_equals_one_rank(layout):
    dp, sp, B, S, u, n, _ = layout
    _, tc = _cfgs("granite-routing")
    tc = dataclasses.replace(tc, fpdt_chunks=u)
    gen = torch.Generator().manual_seed(0)
    p = MOE.init_moe(tc, gen, torch.float32, "cpu")
    x = torch.randn((B, S, tc.d_model), generator=gen)
    parts = [MOE.moe_ffn(tc, p, xc) for xc in x.chunk(n, dim=1)]  # the one-rank reference
    want_y = torch.cat([y for y, _ in parts], dim=1)
    want_aux = torch.stack([a for _, a in parts]).mean()
    world, b = dp * sp, B // dp
    plans = [MOE.mesh_plan(tc, S, B, sp, dp, n, r) for r in range(world)]

    def mine(r):
        pos = token_positions(S, sp, r % sp, u)
        return x[(r // sp) * b:(r // sp + 1) * b][:, pos], pos

    gathers = bool(plans[0].rows)
    sends = [MOE.local_counts(tc, p, mine(r)[0], plans[r]) if gathers else None
             for r in range(world)]
    got = torch.stack(sends) if gathers else None
    aux_sum = 0.0
    for r in range(world):
        xr, pos = mine(r)
        y, aux = MOE.moe_planned(tc, p, xr, plans[r], gather=lambda t, r=r: (
            torch.equal(t, sends[r]) or pytest.fail("a rank's counts changed"), got)[1])
        lo = (r // sp) * b
        torch.testing.assert_close(y, want_y[lo:lo + b][:, pos], rtol=0, atol=1e-5)
        aux_sum += float(aux)
    np.testing.assert_allclose(aux_sum, float(want_aux), rtol=1e-5)
    spans = {(p_.gather_pieces, p_.gather_me) for p_ in plans}
    assert len(spans) == 1
    if layout[-1].startswith("nothing"):
        assert spans == {(False, False)}
    else:
        assert spans != {(False, False)}
