"""repro_torch softmax_xent_chunked against the JAX package's on the same
numpy inputs, with IGNORE labels present: the loss sum, the token count,
and the gradients of the hidden states and the head (recomputed per chunk
in the backward), whole and chunked; and auto_chunks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.core import chunked_loss as JC
from repro_torch.configs import get_config, reduced
from repro_torch.core import chunked_loss as C

TOL = 1e-5  # fp32: the same sums in another order


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    b, s, d, v = 2, 32, 16, 40
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    head = (rng.standard_normal((d, v)) * 0.3).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    labels[rng.random((b, s)) < 0.25] = C.IGNORE
    return x, head, labels


@pytest.mark.parametrize("n_chunks,z_weight", [(1, 0.0), (4, 0.0), (8, 1e-3), (5, 0.0)])
def test_matches_jax(data, n_chunks, z_weight):
    x, head, labels = data
    assert C.IGNORE == JC.IGNORE

    def jf(x, head):
        return JC.softmax_xent_chunked(x, head, jnp.asarray(labels), n_chunks, z_weight)

    jsum, jcount = jf(jnp.asarray(x), jnp.asarray(head))
    jgx, jgh = jax.grad(lambda x, h: jf(x, h)[0], argnums=(0, 1))(jnp.asarray(x),
                                                                  jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_(True)
    th = torch.from_numpy(head).requires_grad_(True)
    tsum, tcount = C.softmax_xent_chunked(tx, th, torch.from_numpy(labels), n_chunks, z_weight)
    tgx, tgh = torch.autograd.grad(tsum, (tx, th))
    assert float(tcount) == float(jcount) == float((labels != C.IGNORE).sum())
    np.testing.assert_allclose(tsum.item(), float(jsum), rtol=TOL)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tgh.numpy(), np.asarray(jgh), rtol=TOL, atol=TOL)


def test_chunks_recompute_in_backward(data):
    """Under grad each chunk is checkpointed: no [b, s, V] logits are kept
    for the backward, only the inputs of each chunk."""
    x, head, labels = data
    tx = torch.from_numpy(x).requires_grad_(True)
    th = torch.from_numpy(head).requires_grad_(True)
    kept = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: kept.append(t.shape) or t,
                                                  lambda t: t):
        loss, _ = C.softmax_xent_chunked(tx, th, torch.from_numpy(labels), 4)
    assert not any(len(shape) == 3 and shape[-1] == head.shape[1] for shape in kept)
    loss.backward()
    assert torch.isfinite(tx.grad).all() and torch.isfinite(th.grad).all()


@pytest.mark.parametrize("seq", [64, 100, 8192])
def test_auto_chunks_matches_jax(seq):
    for full in (False, True):
        jc, tc = j_get_config("llama3.2-1b"), get_config("llama3.2-1b")
        if not full:
            jc, tc = j_reduced(jc), reduced(tc)
        assert C.auto_chunks(tc, seq) == JC.auto_chunks(jc, seq)
    assert C.auto_chunks(get_config("llama3.2-1b"), 8192) == 64
