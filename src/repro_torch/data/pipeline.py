"""Deterministic, checkpointable data pipeline (numpy only).

The port's own copy of the JAX package's ``data/pipeline.py``, its three
frontends included (tokens, audio frames, vision patches): ``batch(step)``
is a pure function of (seed, step, layout), so the same seed and step give
exactly the JAX package's batches, and the iterator's state is the step
counter.  Under a mesh each rank takes its part of the global batch
(``shard_batch``).
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
    """Returns batch(step) -> dict of numpy arrays: {"tokens" [B, S] int32,
    "labels" [B, S] int32}; for the audio frontend {"frame_embeds" [B, S,
    d] float32, "labels"}; for the vision frontend {"patch_embeds" [B, P,
    d] float32, "tokens" and "labels" [B, S - P]} (P = ``num_patches``).
    The frontends' embeddings are the JAX package's stubs: standard normal
    * 0.02 from ``SeedSequence([seed, step, 7])``."""
    dc = dc or DataConfig(vocab_size=cfg.vocab_size)
    dc.vocab_size = cfg.vocab_size
    B, S = shape.global_batch, shape.seq_len

    def stub(step: int, n: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([dc.seed, step, 7]))
        return rng.standard_normal((B, n, cfg.d_model), dtype=np.float32) * 0.02

    if cfg.frontend == "audio_frames":
        def batch(step: int) -> Dict[str, np.ndarray]:
            toks = TokenSource(dc, B, S).batch(step)
            return {"frame_embeds": stub(step, S), "labels": toks[:, 1 : S + 1]}
        return batch

    if cfg.frontend == "vision_patches":
        St = S - cfg.num_patches

        def batch(step: int) -> Dict[str, np.ndarray]:
            toks = TokenSource(dc, B, St).batch(step)
            return {"patch_embeds": stub(step, cfg.num_patches), "tokens": toks[:, :St],
                    "labels": toks[:, 1 : St + 1]}
        return batch

    def batch(step: int) -> Dict[str, np.ndarray]:
        toks = TokenSource(dc, B, S).batch(step)
        return {"tokens": toks[:, :S], "labels": toks[:, 1 : S + 1]}

    return batch


def token_positions(seq_len: int, sp: int, sp_rank: int, u: int) -> np.ndarray:
    """Global positions of model rank ``sp_rank``'s tokens under the
    chunk-interleaved layout (``core/parallel.py``): its C/sp tokens of each
    of the u chunks of C = seq_len / u, in chunk order."""
    if u < 1 or seq_len % u or (seq_len // u) % sp:
        raise ValueError(f"seq_len {seq_len}: u={u} chunks of a length divisible by sp={sp} "
                         "are needed")
    chunk = seq_len // u
    c = chunk // sp
    return (np.arange(u)[:, None] * chunk + sp_rank * c + np.arange(c)[None, :]).reshape(-1)


def shard_batch(batch: Dict[str, np.ndarray], par, u: int) -> Dict[str, np.ndarray]:
    """This rank's part of a global batch: its data rank's rows and its
    model rank's positions (``token_positions``) of the [B, S] sequence.
    Under the vision frontend the sequence is the P patches and then the
    tokens, so the rank's patch positions (< P) index ``patch_embeds`` and
    its others, less P, ``tokens`` and ``labels``; the positions increase,
    so its patches come first in its slice (a rank may hold none, or only
    patches).  Every rank builds the global batch from the same seed and
    takes its part.  Without a mesh the batch is returned as it is."""
    if par is None or par.mesh is None:
        return batch
    rows = next(iter(batch.values())).shape[0]
    if rows % par.dp:
        raise ValueError(f"global batch {rows} does not split over dp={par.dp}")
    r = rows // par.dp
    lo = par.dp_rank * r
    n_patch = batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0
    seq = n_patch + next(v for k, v in batch.items() if k != "patch_embeds").shape[1]
    pos = token_positions(seq, par.sp, par.sp_rank, u)
    take = {"patch_embeds": pos[pos < n_patch]}
    return {k: np.ascontiguousarray(v[lo:lo + r][:, take.get(k, pos[pos >= n_patch] - n_patch)])
            for k, v in batch.items()}


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
