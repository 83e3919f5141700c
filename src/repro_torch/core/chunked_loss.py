"""Vocab projection + cross-entropy, chunked along the sequence (paper §5.4).

The last linear projection to vocab logits (fp32) is the paper's final
memory spike: [b, s, V] fp32 with V >> d (4.2 GB at one 8192-token
llama3.2-1b row, twice that with its gradient).  Chunking the sequence into
~ceil(V/d)*2 chunks bounds the live logits to one chunk, and when grad is
enabled each chunk is checkpointed (non-reentrant) so its logits are
recomputed in the backward and never kept.

Under a mesh each rank computes its own tokens' (sum, count) with the
same code (``models/transformer.py::loss_fn`` adds the world's counts).
The JAX package's batch mode exists for its vocabulary-sharded logits; the
port keeps the vocabulary whole, so the sequence chunks serve every mesh.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig

IGNORE = -100


def auto_chunks(cfg: ModelConfig, seq_len: int, sp: int = 1) -> int:
    """Paper's rule vocab/hidden*2, rounded down so seq_len % n == 0 AND each
    chunk's sequence stays divisible by the model axis."""
    target = max(1, (2 * cfg.vocab_size) // cfg.d_model)
    best = 1
    for n in range(1, min(target, seq_len) + 1):
        if seq_len % n == 0 and (seq_len // n) % max(1, sp) == 0:
            best = n
    return best


def _chunk_nll(xc: torch.Tensor, yc: torch.Tensor, head: torch.Tensor, z_weight: float):
    """(sum of the chunk's nll, count of its labelled tokens), fp32.  The
    logsumexp runs over the padded vocab, as the JAX package's does."""
    logits = (xc @ head).float()  # [b, cs, padded V]
    lz = torch.logsumexp(logits, dim=-1)
    ok = yc != IGNORE
    tgt = torch.gather(logits, -1, yc.clamp_min(0).long()[..., None])[..., 0]
    zero = torch.zeros((), dtype=torch.float32, device=xc.device)
    nll = torch.where(ok, lz - tgt, zero)
    if z_weight:
        nll = nll + torch.where(ok, z_weight * lz ** 2, zero)
    return nll.sum(), ok.sum().float()


def softmax_xent_chunked(
    x: torch.Tensor,  # [b, s, d] final hidden (normed)
    head: torch.Tensor,  # [d, V]
    labels: torch.Tensor,  # [b, s] integer, IGNORE masked
    n_chunks: int,
    z_weight: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (sum_loss fp32 scalar, token_count fp32 scalar) over the rows
    and tokens of ``x``."""
    b, s, d = x.shape
    if s % n_chunks != 0:
        n_chunks = 1
    cs = s // n_chunks
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    grad = torch.is_grad_enabled()
    for c in range(n_chunks):
        xc, yc = x[:, c * cs:(c + 1) * cs], labels[:, c * cs:(c + 1) * cs]
        if grad:
            ls, cnt = checkpoint(_chunk_nll, xc, yc, head, z_weight, use_reentrant=False,
                                 preserve_rng_state=False)
        else:
            ls, cnt = _chunk_nll(xc, yc, head, z_weight)
        loss_sum = loss_sum + ls
        count = count + cnt
    return loss_sum, count
