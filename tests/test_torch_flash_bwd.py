"""repro_torch chunk_bwd_dq / chunk_bwd_dkv (the plain versions, which CPU
tensors take) against the JAX package's with the Pallas kernels in interpret
mode, and the flash_attention Function's gradients against the JAX
``custom_vjp``'s.  Tolerance 1e-4, the kernel-gradient tolerance of
tests/test_kernels_flash.py.  Then the q-head split of the bf16
flash_bwd_dkv: how many splits, which heads each covers, and that their
partials sum to the unsplit result."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as JO
from repro_torch.core.online_softmax import SoftmaxState, lse
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops as O

TOL = 1e-4

CASES = [
    # b, hq, hkv, sq, sk, d, block, causal, window, q_offset, k_offset
    (1, 1, 1, 16, 16, 8, 8, True, 0, 0, 0),
    (2, 4, 2, 32, 32, 16, 16, True, 0, 0, 0),
    (1, 4, 1, 64, 64, 32, 16, True, 0, 0, 0),     # MQA
    (1, 3, 3, 48, 48, 16, 16, True, 0, 0, 0),     # odd head count
    (2, 2, 2, 40, 24, 16, 8, True, 0, 0, 0),      # sq != sk
    (1, 4, 2, 32, 48, 16, 16, True, 0, 48, 0),    # off-diagonal pair: q after the keys
    (1, 2, 1, 36, 20, 16, 16, True, 0, 16, 0),    # ragged lengths, offsets
    (1, 4, 2, 32, 48, 16, 16, True, 16, 40, 0),   # window: early tiles dead
    (1, 2, 2, 16, 16, 16, 8, True, 0, 0, 32),     # keys in the future: every row masked
    (2, 4, 2, 40, 24, 16, 8, False, 0, 0, 0),     # non-causal
    (1, 4, 1, 48, 48, 256, 16, True, 40, 0, 0),   # head_dim 256, MQA, window: diagonal
    (1, 4, 1, 48, 48, 256, 16, True, 40, 48, 0),  # ... and the next chunk pair
]


def _case_inputs(case, seed):
    """q/k/v/do with L and delta of the pair from its own forward, as numpy."""
    b, hq, hkv, sq, sk, d, blk, causal, window, qo, ko = case
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    do = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=qo, k_offset=ko)
    st = SoftmaxState(*O.chunk_fwd(*map(torch.from_numpy, (q, k, v)), **kw))
    o = (st.acc / torch.where(st.l == 0, torch.ones_like(st.l), st.l)[..., None]).numpy()
    delta = (do * o).sum(-1)
    return (q, k, v, do, lse(st).numpy(), delta), kw, blk


@pytest.mark.parametrize("case", CASES)
def test_chunk_bwd_matches_pallas(case):
    arrs, kw, blk = _case_inputs(case, seed=sum(case[:6]))
    j = [jnp.asarray(a) for a in arrs]
    t = [torch.from_numpy(a) for a in arrs]
    want_dq = JO.chunk_bwd_dq(*j, impl="pallas", block_q=blk, block_k=blk, **kw)
    want_dk, want_dv = JO.chunk_bwd_dkv(*j, impl="pallas", block_q=blk, block_k=blk, **kw)
    got_dq = O.chunk_bwd_dq(*t, **kw)
    got_dk, got_dv = O.chunk_bwd_dkv(*t, **kw)
    for got, want in ((got_dq, want_dq), (got_dk, want_dk), (got_dv, want_dv)):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    if kw["k_offset"] >= kw["q_offset"] + case[3]:  # every row masked
        assert not got_dq.any() and not got_dk.any() and not got_dv.any()


@pytest.mark.parametrize("b,hq,hkv,s,d,blk,window", [
    (1, 1, 1, 16, 8, 8, 0),
    (2, 4, 2, 32, 16, 16, 0),
    (1, 4, 1, 64, 32, 16, 0),
    (1, 4, 2, 48, 16, 16, 20),
])
def test_flash_attention_grads_match_jax(b, hq, hkv, s, d, blk, window):
    rng = np.random.default_rng(b * 100 + hq + s)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    w = rng.standard_normal((b, hq, s, d)).astype(np.float32)

    def jloss(q, k, v):
        o = JO.flash_attention(q, k, v, window=window, block_q=blk, block_k=blk, impl="pallas")
        return (o * w).sum()

    jout = JO.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
                              block_q=blk, block_k=blk, impl="pallas")
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tout = O.flash_attention(tq, tk, tv, window=window)
    tgrads = torch.autograd.grad((tout * torch.from_numpy(w)).sum(), (tq, tk, tv))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    for got, want in zip(tgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


# The bf16 flash_bwd_dkv splits a kv group's q heads across blocks and sums
# the splits' partial dk, dv in split order (kernel.py dkv_splits, a function
# of the shapes alone).  The kernel runs only on the card; its partition and
# its sum are checked here on the plain version.


def _split_heads(hk: int, g: int, n_split: int, split: int) -> range:
    """The q heads that split ``split`` of kv head ``hk``'s group of ``g``
    covers: flash_bwd.cu's h_begin .. h_begin + g / n_split."""
    per = g // n_split
    return range(hk * g + split * per, hk * g + (split + 1) * per)


@pytest.mark.parametrize("b,hq,hkv,sk,want", [
    (1, 32, 8, 2048, 1),   # llama3.2-1b's training pair: 32 x 8 blocks fill the card
    (1, 16, 1, 2048, 8),   # recurrentgemma-9b's: 32 blocks, split to 256
    (4, 32, 8, 512, 1),
    (1, 4, 1, 8192, 2),
    (1, 16, 1, 100, 16),   # a small MQA pair: every head its own block
])
def test_dkv_splits(b, hq, hkv, sk, want):
    n = K.dkv_splits(b, hq, hkv, sk)
    assert n == want and (hq // hkv) % n == 0


@pytest.mark.parametrize("hq,hkv,n_split,sq", [(16, 1, 8, 2048), (32, 8, 1, 2048),
                                               (8, 2, 2, 100), (16, 1, 16, 70)])
def test_split_heads_cover_each_group_once(hq, hkv, n_split, sq):
    """Every (q head, q tile) of a kv group falls in exactly one split."""
    g, n_qt = hq // hkv, -(-sq // K.DKV_TILE_KEYS)
    for hk in range(hkv):
        seen = [(h, qt) for s in range(n_split) for h in _split_heads(hk, g, n_split, s)
                for qt in range(n_qt)]
        assert sorted(seen) == [(h, qt) for h in range(hk * g, (hk + 1) * g)
                                for qt in range(n_qt)]


@pytest.mark.parametrize("case", [CASES[2], CASES[7], CASES[10], CASES[11],
                                  (1, 8, 2, 40, 56, 16, 16, True, 0, 24, 0)])
def test_split_sum_equals_the_unsplit_dkv(case):
    """dk, dv summed over each split's heads in split order equal the
    unsplit plain result within 1e-6."""
    arrs, kw, _ = _case_inputs(case, seed=sum(case[:6]) + 7)
    q, k, v, do, L, delta = map(torch.from_numpy, arrs)
    hq, hkv = q.shape[1], k.shape[1]
    g = hq // hkv
    want = O.chunk_bwd_dkv(q, k, v, do, L, delta, **kw)
    for n_split in (n for n in range(2, g + 1) if g % n == 0):
        dk = dv = None
        for s in range(n_split):
            idx = [h for hk in range(hkv) for h in _split_heads(hk, g, n_split, s)]
            part = O.chunk_bwd_dkv(q[:, idx], k, v, do[:, idx], L[:, idx], delta[:, idx], **kw)
            dk = part[0] if dk is None else dk + part[0]
            dv = part[1] if dv is None else dv + part[1]
        np.testing.assert_allclose(dk.numpy(), want[0].numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(dv.numpy(), want[1].numpy(), rtol=1e-6, atol=1e-6)
