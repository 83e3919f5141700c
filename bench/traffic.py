"""The one generator of training batches: every traffic mix is a data file
(``bench/traffic/<name>.json``) of its parameters, read here.

A mix gives ``batch`` rows of ``seq`` tokens each step, drawn from the
run's seed: token ids from a Zipf law of exponent ``zipf_a`` folded into
[2, vocab) (text's heavy head), with a document start (id 0) at each
position with probability ``doc_start_p`` and at every row's first
position, so the rows are packed documents.  The labels are the next
tokens.  Every seed gives the same sizes; only the ids differ, and every
step's rows differ from every other step's.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

KEYS = ("batch", "seq", "zipf_a", "doc_start_p")


def batch_fn(mix: dict, vocab: int, seed: int) -> Callable[[int], Dict[str, np.ndarray]]:
    """step -> {"tokens", "labels"}: [batch, seq] int32 numpy arrays."""
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise KeyError(f"traffic mix lacks {missing}")
    b, s = int(mix["batch"]), int(mix["seq"])
    a, p = float(mix["zipf_a"]), float(mix["doc_start_p"])

    def batch(step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([int(seed), int(step), 17]))
        toks = rng.zipf(a, size=(b, s + 1)).astype(np.int64)
        toks = (toks - 1) % (vocab - 2) + 2
        starts = rng.random((b, s + 1)) < p
        starts[:, 0] = True
        toks[starts] = 0
        toks = toks.astype(np.int32)
        return {"tokens": np.ascontiguousarray(toks[:, :s]),
                "labels": np.ascontiguousarray(toks[:, 1:])}

    return batch
