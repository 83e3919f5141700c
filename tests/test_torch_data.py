"""The port's data pipeline gives exactly the JAX package's batches for the
same seed and step, and its iterator's state is the step counter."""
import numpy as np
import pytest

from repro.configs import ShapeConfig as JShape, get_config as j_get_config
from repro.data import pipeline as JP
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data import pipeline as P


@pytest.mark.parametrize("seed", [0, 1234, 99])
@pytest.mark.parametrize("batch,seq", [(2, 64), (1, 8192)])
def test_batches_match_jax(seed, batch, seq):
    tfn = P.make_batch_fn(get_config("llama3.2-1b"), ShapeConfig("t", seq, batch, "train"),
                          P.DataConfig(seed=seed))
    jfn = JP.make_batch_fn(j_get_config("llama3.2-1b"), JShape("t", seq, batch, "train"),
                           JP.DataConfig(seed=seed))
    for step in (0, 1, 7):
        got, want = tfn(step), jfn(step)
        assert got.keys() == want.keys() == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["labels"][:, :-1], got["tokens"][:, 1:])


def test_mmap_source_matches_jax(tmp_path):
    path = tmp_path / "toks.bin"
    np.arange(5000, dtype=np.int32).tofile(path)
    t = P.TokenSource(P.DataConfig(mmap_path=str(path)), 2, 16)
    j = JP.TokenSource(JP.DataConfig(mmap_path=str(path)), 2, 16)
    for step in (0, 3, 400):
        np.testing.assert_array_equal(t.batch(step), j.batch(step))


def test_iterator_state_is_the_step():
    fn = P.make_batch_fn(get_config("llama3.2-1b"), ShapeConfig("t", 16, 1, "train"))
    it = P.CheckpointableIterator(fn)
    first = [next(it) for _ in range(3)]
    assert it.state() == 3
    it.restore(1)
    np.testing.assert_array_equal(next(it)["tokens"], first[1]["tokens"])
    assert it.state() == 2
