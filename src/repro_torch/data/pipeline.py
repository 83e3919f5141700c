"""Deterministic, checkpointable data pipeline (numpy only).

The port's own copy of the JAX package's ``data/pipeline.py`` for the token
frontend: ``batch(step)`` is a pure function of (seed, step, layout), so
the same seed and step give exactly the JAX package's batches, and the
iterator's state is the step counter.  The audio and vision frontends come
with their model slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs import ModelConfig, ShapeConfig


@dataclasses.dataclass
class DataConfig:
    seed: int = 1234
    vocab_size: int = 32000
    mmap_path: Optional[str] = None
    zipf_a: float = 1.2


class TokenSource:
    """batch(step) -> [B, S+1] int32 tokens, pure in (seed, step)."""

    def __init__(self, dc: DataConfig, global_batch: int, seq_len: int):
        self.dc = dc
        self.B = global_batch
        self.S = seq_len
        self._mm = None
        if dc.mmap_path:
            self._mm = np.memmap(dc.mmap_path, dtype=np.int32, mode="r")

    def batch(self, step: int) -> np.ndarray:
        if self._mm is not None:
            n = self.B * (self.S + 1)
            start = (step * n) % max(1, len(self._mm) - n)
            return np.asarray(self._mm[start : start + n]).reshape(self.B, self.S + 1)
        rng = np.random.default_rng(np.random.SeedSequence([self.dc.seed, step]))
        toks = rng.zipf(self.dc.zipf_a, size=(self.B, self.S + 1)).astype(np.int64)
        toks = (toks - 1) % (self.dc.vocab_size - 2) + 2  # reserve 0=BOS, 1=EOS
        # document structure: independent geometric doc lengths -> BOS markers
        doc_starts = rng.random((self.B, self.S + 1)) < (1.0 / 512)
        doc_starts[:, 0] = True
        toks[doc_starts] = 0
        return toks.astype(np.int32)


def make_batch_fn(cfg: ModelConfig, shape: ShapeConfig, dc: Optional[DataConfig] = None):
    """Returns batch(step) -> {"tokens" [B, S], "labels" [B, S]} int32 numpy."""
    if cfg.frontend != "none":
        raise NotImplementedError(f"the {cfg.frontend} frontend is not yet ported")
    dc = dc or DataConfig(vocab_size=cfg.vocab_size)
    dc.vocab_size = cfg.vocab_size
    B, S = shape.global_batch, shape.seq_len

    def batch(step: int) -> Dict[str, np.ndarray]:
        toks = TokenSource(dc, B, S).batch(step)
        return {"tokens": toks[:, :S], "labels": toks[:, 1 : S + 1]}

    return batch


class CheckpointableIterator:
    """Step-indexed iterator; ``state`` is just the step counter."""

    def __init__(self, batch_fn, start_step: int = 0):
        self.batch_fn = batch_fn
        self.step = start_step

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        b = self.batch_fn(self.step)
        self.step += 1
        return b

    def state(self) -> int:
        return self.step

    def restore(self, state: int) -> None:
        self.step = int(state)
