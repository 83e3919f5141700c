"""repro_torch.core.online_softmax against the JAX package's module: merge,
finalize and lse on the same numpy inputs, including the masked-row identity."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import online_softmax as J
from repro_torch.core import online_softmax as P

TOL = 1e-5


def _state(rng, shape, masked_rows=()):
    *lead, sq, d = shape
    m = rng.standard_normal((*lead, sq)).astype(np.float32)
    l = rng.uniform(0.5, 3.0, (*lead, sq)).astype(np.float32)
    acc = rng.standard_normal((*lead, sq, d)).astype(np.float32)
    for r in masked_rows:  # a row that has seen no live key: the identity
        m[..., r] = J.NEG_INF
        l[..., r] = 0.0
        acc[..., r, :] = 0.0
    return m, l, acc


def _both(m, l, acc):
    return (J.SoftmaxState(jnp.asarray(acc), jnp.asarray(m), jnp.asarray(l)),
            P.SoftmaxState(torch.from_numpy(acc), torch.from_numpy(m), torch.from_numpy(l)))


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL)


def test_constants_and_zero_state():
    assert P.NEG_INF == J.NEG_INF == -1e30
    z = P.zero_state((2, 3, 5, 4))
    assert z.acc.shape == (2, 3, 5, 4) and z.m.shape == z.l.shape == (2, 3, 5)
    assert z.acc.dtype == z.m.dtype == z.l.dtype == torch.float32
    assert bool((z.m == P.NEG_INF).all()) and not z.l.any() and not z.acc.any()
    zl = P.zero_state_like(torch.zeros(2, 3, 5, 4, dtype=torch.bfloat16))
    assert zl.acc.dtype == torch.float32 and zl.acc.shape == (2, 3, 5, 4)


@pytest.mark.parametrize("shape,masked", [((2, 3, 8, 4), ()), ((1, 2, 6, 16), (0, 3))])
def test_merge_finalize_lse_match_jax(rng, shape, masked):
    ja, ta = _both(*_state(rng, shape, masked))
    jb, tb = _both(*_state(rng, shape))
    jm, tm = J.merge(ja, jb), P.merge(ta, tb)
    for t, j in zip(tm, jm):
        _close(t, j)
    _close(P.finalize(tm), J.finalize(jm))
    _close(P.lse(tm), J.lse(jm))
    _close(P.finalize(ta), J.finalize(ja))
    _close(P.lse(ta), J.lse(ja))


def test_masked_rows_are_the_identity(rng):
    shape = (2, 2, 6, 8)
    _, ta = _both(*_state(rng, shape))
    ident = P.zero_state(shape)
    for left, right in ((ident, ta), (ta, ident)):
        out = P.merge(left, right)
        for t, want in zip(out, ta):
            torch.testing.assert_close(t, want, rtol=0, atol=0)
    # a fully masked row finalizes to 0 and its lse to m, never nan
    _, tm = _both(*_state(rng, shape, masked_rows=(1,)))
    fin = P.finalize(tm)
    assert not fin[..., 1, :].any() and torch.isfinite(fin).all()
    assert torch.isfinite(P.lse(tm)).all()
