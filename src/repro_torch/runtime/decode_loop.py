"""Multi-token decode and continuous batching over ``models/serve.py``.

* ``decode_tokens`` — the JAX package runs the generation as one
  ``lax.scan`` so the decode body is traced once; eager PyTorch runs the
  same carry through a Python loop, which never reads a device value on
  the host, so the card runs ahead of the launching thread.
* ``ServeEngine`` — continuous batching by the **fused mixed-step
  scheduler** (``mixed_segment``): every step, each cache slot either
  consumes one prefill chunk or decodes one token, by a per-slot state
  machine (``FREE / PREFILL / DECODE``) carried on the device, so a
  refilling slot's prompt streams in chunk by chunk under the other
  slots' decode steps, and prompts longer than the bucket take more
  chunks.  A step takes ``chunk_step`` when some slot prefills and
  ``decode_step`` otherwise, as the JAX ``lax.cond(jnp.any(is_pf))``
  does; the host knows which without reading the device, because a slot
  prefills from its admission until ``pfill >= plen`` and ``pfill``
  advances by the chunk a step.
* ``BlockingServeEngine`` — the stop-the-world baseline: a batched
  prefill (FPDT), ``decode_tokens`` segments, and a synchronous refill
  prefill of one row written in by ``insert_slot``.
* ``Request`` — a prompt and its QoS contract (priority, arrival, ITL
  deadline, prefill budget), which every engine's ``generate`` takes
  beside raw token lists; only ``runtime/paged.SLOPagedServeEngine``
  reads the QoS fields.  ``runtime/paged.PagedServeEngine`` swaps the
  dense cache for the paged pool through ``ServeEngine``'s hooks, its page
  ``table`` riding ``mixed_segment`` into both step bodies.

The JAX engines count their XLA compilations (``per_engine``,
``compiled_programs()``); eager PyTorch compiles nothing, so those are
not ported.  What takes their place is the one host read a segment: the
staged prompts (``pend``, ``plen``) go to the device at admission, the
state's few integers at dispatch, and the harvest at the segment's end
is its only device-to-host copy (``chip_smoke.py`` runs a segment under
``torch.cuda.set_sync_debug_mode("error")``).  Sampling draws from a
``torch.Generator`` in place of the PRNG key; greedy decoding is what is
held to the JAX bits.  Every entry point takes ``n_host_chunks``
(host-streamed decode KV, ``models/serve.py``): the per-row position
spans it needs come from what the host knows.

On a serve mesh (``ServeEngine(par=...)``, ``launch/mesh.py::serve_mesh``;
the JAX ``segment_shardings`` written out) every rank runs the same host
scheduler over all slots; the cache is the rank's shard
(``SV.cache_shardings``), and with the rows split over data a rank steps
its own rows [r0, r1) of the state.  Every rank takes the same step kind
(the schedule is over all slots), so the collectives line up; the harvest
all-gathers each slot's tok, pos, mode, rem, pfill and outputs over data
(one call), so every rank's scheduler decides the same.  Greedy sampling
gathers nothing; under a temperature every rank samples the batch's
logits, gathered over data, from one generator state and keeps its rows,
so the tokens are the one-rank engine's.  Every layout serves on a mesh:
the recurrent states are rows like the KV (over data) and channels over
model, and host-streamed KV parks what ``SV.host_shardings`` gives the
rank: its shard, its data share of each slab where its rows are whole over
data, or the whole leaf where the JAX package parks it whole.
``BlockingServeEngine`` and ``decode_tokens`` stay on one rank.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.core import parallel as PAR
from repro_torch.core.parallel import ParallelContext
from repro_torch.models import serve as SV
from repro_torch.runtime import telemetry as TM
from repro_torch.tree import tree_leaves

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """``temperature <= 0`` selects greedy argmax (the default); otherwise
    categorical sampling at the given temperature, optionally restricted to
    the ``top_k`` highest-probability tokens (0 = full vocabulary)."""

    temperature: float = 0.0
    top_k: int = 0


GREEDY = SamplingConfig()


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 sc: SamplingConfig = GREEDY) -> torch.Tensor:
    """logits [b, V] fp32 -> sampled token ids [b] int32.  Greedy ignores
    ``generator``; sampling draws from it (a generator on logits' device)."""
    if sc.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if sc.top_k:
        kth = torch.topk(logits, sc.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -torch.inf), logits)
    probs = torch.softmax(logits / sc.temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


@dataclasses.dataclass(frozen=True)
class Request:
    """One queued generation request and its QoS contract (the JAX
    package's).  Every engine's ``generate`` takes these or raw token
    sequences (``as_request``); the fields past ``tokens`` matter only to
    ``runtime/paged.py::SLOPagedServeEngine``:

      priority       — admission class, LOWER is more urgent (0: the
                       interactive tier); a waiting request may preempt a
                       strictly less urgent one;
      arrival        — the dispatch step at which the scheduler first sees
                       the request (0: already queued);
      itl_slo        — inter-token-latency deadline in dispatch steps, the
                       tie-break within a priority (``inf``: none);
      prefill_chunks — prefill chunks a burst may take before the
                       scheduler pauses the prefill for a segment (0: the
                       engine's ``prefill_budget``);
      tier           — a label carried into the per-request records;
      session        — routing affinity for a replica router; engines
                       ignore it."""

    tokens: Tuple[int, ...]
    priority: int = 1
    arrival: int = 0
    itl_slo: float = math.inf
    prefill_chunks: int = 0
    tier: str = ""
    session: Optional[str] = None


def as_request(r: Union[Request, Sequence[int]]) -> Request:
    """A raw prompt (token sequence) as a default ``Request``; a ``Request``
    as it is."""
    if isinstance(r, Request):
        return r
    return Request(tokens=tuple(int(t) for t in r))


def _one_rank(par: Optional[ParallelContext], what: str) -> None:
    if PAR.distributed(par):
        raise ValueError(f"{what} runs on one rank; over a mesh, serve through ServeEngine "
                         "or PagedServeEngine")


def _host_positions(pos, b: int) -> Optional[List[int]]:
    """Each row's position as host ints when ``pos`` is on the host (an int,
    a sequence, a numpy array, a CPU tensor); None for a tensor on a card,
    which would take a device read."""
    if isinstance(pos, torch.Tensor):
        if pos.device.type != "cpu":
            return None
        pos = pos.numpy()
    return [int(p) for p in np.broadcast_to(np.asarray(pos, np.int64), (b,))]


def _is_stop(nxt: torch.Tensor, stop: torch.Tensor) -> torch.Tensor:
    """[b] bool: is each sampled id one of ``stop`` (a device tensor)?"""
    return (nxt[:, None] == stop[None, :]).any(dim=1)


@torch.no_grad()
def decode_tokens(cfg: ModelConfig, par: Optional[ParallelContext], params: Params,
                  cache: Params, tok: torch.Tensor, pos, *, num_steps: int,
                  n_host_chunks: int = 0,
                  sampling: SamplingConfig = GREEDY, stop_tokens: Sequence[int] = (),
                  pad_id: int = 0, generator: Optional[torch.Generator] = None,
                  done: Optional[torch.Tensor] = None,
                  remaining: Optional[torch.Tensor] = None,
                  collect_logits: bool = False):
    """Generate up to ``num_steps`` tokens per sequence.

    Carry contract (the JAX package's, with a ``torch.Generator`` in place
    of the PRNG key):
      cache      — decode cache (``models/serve.py`` layout), updated in place;
      tok [b,1]  — the token each sequence feeds NEXT.  The caller samples
                   the first token from the prefill logits, so the full
                   generation is ``[tok0, *emitted]``;
      pos [b]    — the position ``tok`` occupies; frozen once a row is done;
      generator  — sampling randomness (unused under greedy);
      done [b]   — finished rows emit ``pad_id``, stop advancing ``pos``,
                   and stop consuming budget;
      remaining [b] — per-row emission budget; a row finishes after
                   emitting ``remaining`` tokens or a ``stop_tokens`` hit
                   (the stop token itself is emitted).

    Step t feeds ``tok`` at ``pos``, samples from the resulting logits, and
    emits the SAMPLED token.  An audio model, which feeds frame embeddings,
    is refused (ValueError), as in the JAX package.  ``n_host_chunks``
    streams the full-attention KV from the host (``SV.decode_step``); a
    ``pos`` given on the host (an int, a sequence, a CPU tensor) bounds
    each row's position at step t by ``pos + t``, so slabs past every row
    are skipped; a ``pos`` on the card gives no bound (every slab runs).

    Returns ``(tokens [b, num_steps] int32, aux)`` with
    ``aux = {cache, tok, pos, generator, done, remaining[, logits]}`` — the
    carry, so calls chain; ``collect_logits`` adds the per-step
    pre-sampling logits ``[num_steps, b, vocab]``.
    """
    if cfg.frontend == "audio_frames":
        raise ValueError("decode_tokens feeds token ids; the audio_frames "
                         "frontend consumes frame embeddings — drive "
                         "decode_step directly for frame synthesis")
    _one_rank(par, "decode_tokens")
    b = tok.shape[0]
    device = tok.device
    pos0 = _host_positions(pos, b)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device).expand(b).clone()
    done = torch.zeros(b, dtype=torch.bool, device=device) if done is None else done
    if remaining is None:
        remaining = torch.full((b,), num_steps + 1, dtype=torch.int32, device=device)
    remaining = torch.as_tensor(remaining, dtype=torch.int32, device=device)
    done = done | (remaining <= 0)
    stop = torch.as_tensor(tuple(stop_tokens), dtype=torch.int32, device=device)
    tok = tok.to(torch.int32)
    toks, all_logits = [], []
    for t in range(num_steps):
        bounds = None if pos0 is None else [(p, p + t) for p in pos0]
        logits, cache = SV.decode_step(cfg, par, params, cache, {"tokens": tok}, pos,
                                       n_host_chunks=n_host_chunks, bounds=bounds)
        lv = logits[:, : cfg.vocab_size]
        nxt = sample_token(lv, generator, sampling)
        remaining = remaining - (~done).to(torch.int32)
        emit = torch.where(done, torch.full_like(nxt, pad_id), nxt)
        pos = torch.where(done, pos, pos + 1)
        done = done | _is_stop(nxt, stop) | (remaining <= 0)
        tok = emit[:, None]
        toks.append(emit)
        if collect_logits:
            all_logits.append(lv)
    tokens = (torch.stack(toks, dim=1) if toks
              else torch.zeros((b, 0), dtype=torch.int32, device=device))
    aux = {"cache": cache, "tok": tok, "pos": pos, "generator": generator,
           "done": done, "remaining": remaining}
    if collect_logits:
        aux["logits"] = torch.stack(all_logits) if all_logits else None
    return tokens, aux


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------


def _batch_axis(path) -> int:
    """Batch-dim axis of a cache leaf at ``path`` (its keys from the root):
    stacked cycle leaves are [C, b, ...], tail leaves [b, ...]."""
    return 0 if path[0] == "tail" else 1


def _leaves(cache: Params):
    """(batch axis, leaf name, leaf) of every cache leaf."""
    for key, blocks in cache.items():
        for bc in (blocks if key == "tail" else [blocks]):
            for name, leaf in bc.items():
                yield _batch_axis((key, name)), name, leaf


def insert_slot(cache: Params, one: Params, i: int) -> Params:
    """Write a single-sequence (b=1) cache ``one`` into batch slot ``i`` of
    ``cache``, in place: the slot-reuse primitive of continuous batching.
    A leaf held in pinned host memory (``SV.offload_kv``) takes its row
    through the copy stream (``HostOffload.copy_to_host``)."""
    for (ax, _, dst), (_, _, src) in zip(_leaves(cache), _leaves(one)):
        if dst.device == src.device:
            dst.narrow(ax, i, 1).copy_(src)
            continue
        policy = SV.PL.host_offload(src.device)
        rows = [(dst[i], src[0])] if ax == 0 else [(dst[c, i], src[c, 0])
                                                    for c in range(dst.shape[0])]
        for d, s_ in rows:
            policy.copy_to_host(d, s_.to(d.dtype))
    return cache


def reset_slot(cache: Params, i: int) -> Params:
    """Invalidate batch slot ``i`` before chunked prefill streams a new
    prompt into it, in place: ``kpos`` rows go to -1 (no stale attention
    entry can leak into the new sequence) and recurrent state rows (conv,
    ssm, h) to 0.  k/v payloads stay: they are unreachable once ``kpos``
    is -1."""
    for ax, name, leaf in _leaves(cache):
        if name in ("kpos", "conv", "ssm", "h"):
            leaf.narrow(ax, i, 1).fill_(-1 if name == "kpos" else 0)
    return cache


# per-slot scheduler states
FREE, PREFILL, DECODE = 0, 1, 2


def segment_schedule(mode, pos, pfill, plen, *, num_steps: int, prefill_chunk: int):
    """What the host knows of a segment before it runs, from the state it
    dispatches (numpy [b] each): per step, whether some slot prefills (the
    step takes ``chunk_step``, else ``decode_step``) and each slot's span
    [lo, hi] of positions it may write (host-streamed KV's ``bounds``;
    lo > hi: none).  A PREFILL slot's chunk is exact; a decoding slot's
    position grows by at most one a step (it may stop); a slot FREE at
    dispatch writes nothing in a chunk step and its frozen position in a
    decode step."""
    cp = int(prefill_chunk)
    pf = np.asarray(pfill, np.int64).copy()
    plen = np.asarray(plen, np.int64)
    prefilling = np.asarray(mode) == PREFILL
    free = np.asarray(mode) == FREE
    lo = np.asarray(pos, np.int64).copy()
    hi = lo.copy()
    steps = []
    for _ in range(num_steps):
        now = prefilling & (pf < plen)
        any_pf = bool(now.any())
        spans = []
        for i in range(len(pf)):
            if now[i]:
                spans.append((int(pf[i]), int(min(pf[i] + cp, plen[i]) - 1)))
            elif free[i] and any_pf:
                spans.append((1, 0))
            else:
                spans.append((int(lo[i]), int(hi[i])))
        steps.append((any_pf, spans))
        for i in range(len(pf)):
            if now[i]:
                pf[i] = min(pf[i] + cp, plen[i])
                if pf[i] >= plen[i]:  # decodes from plen on
                    lo[i] = hi[i] = plen[i]
            elif not free[i]:
                hi[i] += 1
    return steps


def _sample(logits: torch.Tensor, generator, sc: SamplingConfig,
            shard: Optional[SV.Shard]) -> torch.Tensor:
    """``sample_token`` of this rank's rows; with the rows split over data
    and a temperature, from every row's logits (gathered) and the one
    generator state every rank holds, so every row draws what it draws on
    one rank."""
    if sc.temperature > 0 and shard is not None and shard.rows_split:
        full = PAR.gather_rows(logits.contiguous(), shard.par.dp_group)
        return sample_token(full, generator, sc)[shard.r0:shard.r1]
    return sample_token(logits, generator, sc)


@torch.no_grad()
def mixed_segment(cfg: ModelConfig, par: Optional[ParallelContext], params: Params,
                  cache: Params, mode: torch.Tensor, tok: torch.Tensor, pos: torch.Tensor,
                  generator: Optional[torch.Generator], rem: torch.Tensor, pfill: torch.Tensor,
                  pend: torch.Tensor, plen: torch.Tensor, *, schedule, prefill_chunk: int,
                  n_host_chunks: int = 0, sampling: SamplingConfig = GREEDY,
                  stop: Optional[torch.Tensor] = None, pad_id: int = 0,
                  table: Optional[torch.Tensor] = None, shard: Optional[SV.Shard] = None,
                  host_table=None):
    """Run ``len(schedule)`` fused mixed steps (the JAX package's one
    ``lax.scan``; here a loop that reads nothing on the host).

    Per step, each slot does what its state on the device says:
      PREFILL — consume the next ``prefill_chunk``-token chunk of its
                pending prompt (``chunk_step`` at offset ``pfill``; the
                final partial chunk is position-masked and recurrent state
                is gathered at the true length).  When the prompt is
                exhausted the slot samples its first token from the chunk
                logits, emits it and turns DECODE (or FREE on a stop token
                or an empty budget);
      DECODE  — decode one token (emit, advance ``pos``, burn budget; a
                stop token or an exhausted budget -> FREE);
      FREE    — nothing (live=0 in the chunk step: nothing is written).

    A step runs ``chunk_step`` (decode slots ride it as live=1 windows)
    when some slot prefills and ``decode_step`` when none does, as chosen
    by ``schedule`` (``segment_schedule``: the host's view of the same
    state, which also gives host-streamed KV its spans).  State tensors
    (mode, tok [b, 1], pos, rem, pfill int32; the staged prompts pend [b,
    P] and plen; the paged pool's page ``table`` [b, max_pages], which
    both step bodies read and write K/V through) live on the cache's
    device; ``host_table`` is the host's copy of it (numpy), which a parked
    pool's steps plan from.  On a mesh (``shard``) the state is the rank's
    rows, ``table`` and ``schedule``'s spans every row's.  Returns ``(emit
    [b, steps], valid [b, steps], aux)`` with ``aux`` the final state
    {cache, mode, tok, pos, rem, pfill}."""
    b = tok.shape[0]
    cp = int(prefill_chunk)
    P_ = pend.shape[1]
    V = cfg.vocab_size
    device = tok.device
    cols = torch.arange(cp, device=device)[None, :]
    if stop is None:
        stop = torch.zeros((0,), dtype=torch.int32, device=device)
    emits, valids = [], []
    for any_pf, spans in schedule:
        is_pf = mode == PREFILL
        if any_pf:
            off = torch.where(is_pf, pfill, pos)
            live = torch.where(is_pf, torch.clamp(plen - pfill, 0, cp),
                               (mode == DECODE).to(torch.int32))
            idx = torch.clamp(off[:, None].long() + cols, 0, P_ - 1)
            toks = torch.where(is_pf[:, None], torch.gather(pend, 1, idx), tok)
            logits, cache = SV.chunk_step(cfg, par, params, cache, toks, off, live,
                                          n_host_chunks=n_host_chunks, bounds=spans,
                                          table=table, shard=shard, host_table=host_table)
        else:
            logits, cache = SV.decode_step(cfg, par, params, cache, {"tokens": tok}, pos,
                                           n_host_chunks=n_host_chunks, bounds=spans,
                                           table=table, shard=shard, host_table=host_table)
        nxt = _sample(logits[:, :V], generator, sampling, shard)
        pfill = torch.where(is_pf, torch.minimum(pfill + cp, plen), pfill)
        fin_pf = is_pf & (pfill >= plen)  # prompt exhausted this step
        is_dec = mode == DECODE
        emitting = is_dec | fin_pf
        valid = emitting & (rem > 0)
        emit = torch.where(valid, nxt, pad_id)
        rem = rem - valid.to(torch.int32)
        now_free = emitting & ((valid & _is_stop(nxt, stop)) | (rem <= 0))
        mode = torch.where(now_free, FREE, torch.where(fin_pf, DECODE, mode))
        pos = torch.where(fin_pf, plen, torch.where(is_dec & ~now_free, pos + 1, pos))
        tok = torch.where(emitting, nxt, tok[:, 0])[:, None]
        emits.append(emit)
        valids.append(valid)
    empty = torch.zeros((b, 0), dtype=torch.int32, device=device)
    aux = {"cache": cache, "mode": mode, "tok": tok, "pos": pos, "rem": rem, "pfill": pfill}
    return (torch.stack(emits, dim=1) if emits else empty,
            torch.stack(valids, dim=1) if valids else empty.bool(), aux)


def harvest(aux, emits: torch.Tensor, valids: torch.Tensor,
            shard: Optional[SV.Shard] = None):
    """A segment's one device-to-host copy: its final state and outputs as
    numpy (mode, tok [b, 1], pos, rem, pfill, emit [b, steps], valid [b,
    steps]).  With the rows split over data (``shard``) every rank's rows
    are all-gathered first (one call), so the arrays hold every slot."""
    rows = torch.cat([aux["mode"][:, None], aux["tok"], aux["pos"][:, None],
                      aux["rem"][:, None], aux["pfill"][:, None], emits.to(torch.int32),
                      valids.to(torch.int32)], dim=1).to(torch.int32)
    if shard is not None and shard.rows_split:
        rows = PAR.gather_rows(rows, shard.par.dp_group, "gather_harvest")
    flat = rows.cpu().numpy()
    n = emits.shape[1]
    mode, tok0, pos, rem, pfill = (flat[:, k].copy() for k in range(5))
    return mode, tok0[:, None], pos, rem, pfill, flat[:, 5:5 + n].copy(), \
        flat[:, 5 + n:].astype(bool)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    """Continuous batching over ``slots`` concurrent cache rows, scheduled
    by the fused mixed step (``mixed_segment``).

    Queued prompts are staged into a per-slot pending buffer on the device
    and streamed into the cache chunk by chunk (``prefill_chunk`` tokens a
    step) while the other slots keep decoding: refill never stops the
    world, and any layout joins variable-length continuous batching (the
    recurrent blocks ride the state-at-length gather).  Prompts of any
    length > 0 are accepted: the pending buffer and the cache capacity
    derive from ``max(bucket, longest prompt)``.

    The slot-lifecycle points are overridable hooks (``_begin`` /
    ``_admit`` / ``_dispatch`` / ``_post_dispatch`` / ``_release`` /
    ``_end``) with the JAX engine's contracts, for a paged engine to swap
    the dense per-slot cache for a shared pool.  ``_segment`` is the
    segment function the dispatch calls (``mixed_segment`` bound to this
    engine's model and settings).

    With ``par`` a serve mesh (``launch/mesh.py::serve_mesh``) the engine
    is one rank of a sharded replica (``shard``): every rank of the mesh
    calls ``generate`` with the same prompts and returns the same outputs,
    for every layout and with ``n_host_chunks`` too.
    """

    def __init__(self, cfg: ModelConfig, params: Params, *, slots: int,
                 bucket: int, max_new_tokens: int, prefill_chunk: int = 0,
                 n_host_chunks: int = 0, sampling: SamplingConfig = GREEDY,
                 stop_tokens: Sequence[int] = (), pad_id: int = 0,
                 segment: int = 8, par: Optional[ParallelContext] = None):
        self.cfg, self.params, self.par = cfg, params, par
        self.slots, self.bucket = slots, bucket
        self.max_new = max_new_tokens
        self.sampling, self.pad_id = sampling, pad_id
        self.segment = segment
        self.n_host_chunks = n_host_chunks
        self.slab_chunks = n_host_chunks  # the slabs S rounds to (``_slabs``)
        self.cp = int(prefill_chunk) if prefill_chunk else min(bucket, 64)
        self.device = tree_leaves(params)[0].device
        self.telemetry = TM.Telemetry(component="engine")
        self.last_stats: Dict[str, Any] = self.telemetry.stats_view()
        self.shard = SV.Shard(par, slots) if PAR.distributed(par) else None
        cp = self.cp
        stop = torch.as_tensor(tuple(stop_tokens), dtype=torch.int32, device=self.device)

        # closes over the settings, not the engine: no reference cycle keeps
        # an engine (and its weights) alive after its last user drops it
        def seg(cache, mode, tok, pos, gen, rem, pfill, pend, plen, schedule, table=None,
                shard=None, host_table=None):
            return mixed_segment(cfg, par, params, cache, mode, tok, pos, gen, rem, pfill,
                                 pend, plen, schedule=schedule, prefill_chunk=cp,
                                 n_host_chunks=n_host_chunks, sampling=sampling,
                                 stop=stop, pad_id=pad_id, table=table, shard=shard,
                                 host_table=host_table)

        self._segment = seg

    # -- helpers ---------------------------------------------------------
    def _validate(self, prompts: Sequence[Sequence[int]]) -> None:
        for i, p in enumerate(prompts):
            if len(p) == 0:
                raise ValueError(f"prompt {i} is empty; prompts must have "
                                 f"length > 0 (any length — prompts longer "
                                 f"than bucket={self.bucket} just take more "
                                 f"prefill chunks)")

    def _capacity(self, prompts: Sequence[Sequence[int]]) -> Tuple[int, int]:
        """(P, S): pending-buffer length and cache capacity for a workload —
        the bucket floor or the longest prompt, rounded up to whole prefill
        chunks (and S to whole host-KV slabs when streaming, as the JAX
        engine rounds it)."""
        longest = max((len(p) for p in prompts), default=1)
        P = -(-max(self.bucket, longest) // self.cp) * self.cp
        return P, self._slabs(P + self.max_new)

    def _slabs(self, S: int) -> int:
        """``S`` rounded up to whole host-KV slabs (``slab_chunks``)."""
        n = self.slab_chunks
        return -(-S // n) * n if n else S

    def _local_slot(self, s: int) -> Optional[int]:
        """Slot ``s``'s row in this rank's cache (None: another data rank's)."""
        if self.shard is None:
            return s
        r0, r1 = self.shard.r0, self.shard.r1
        return s - r0 if r0 <= s < r1 else None

    # -- slot-lifecycle hooks --------------------------------------------
    def _begin(self, B: int, P: int, S: int):
        """Start a workload: return the cache the segments will carry (its
        full-attention KV in pinned host memory under ``n_host_chunks``;
        on a mesh this rank's shard)."""
        if self.shard is not None:  # the parked leaves parked from the start
            return SV.init_cache(self.cfg, B, S, self.device, par=self.par,
                                 n_host_chunks=self.n_host_chunks)
        cache = SV.init_cache(self.cfg, B, S, self.device)
        if self.n_host_chunks:
            SV.offload_kv(self.cfg, cache, self.device)
        return cache

    def _admit(self, cache, s: int, idx: int, prompt, active: bool,
               budget: Optional[int] = None):
        """Claim slot ``s`` for request ``idx``: invalidate the slot's rows
        and return ``(cache, resume)``, ``resume`` the prompt tokens already
        cached (prefill starts there; dense: 0).  May return ``None`` to
        defer the request while other slots are ``active``.  ``budget`` is
        the decode-token reservation (``None``: ``max_new_tokens``)."""
        self.last_stats["resets"] += 1
        i = self._local_slot(s)
        return (cache if i is None else reset_slot(cache, i)), 0

    def _dispatch(self, cache, mode, tok, pos, gen, rem, pfill, pend, plen, table=None,
                  host_table=None):
        """One segment: the state's integers (numpy, the host's) go to the
        device, the segment runs on it (``_segment``).  ``pend`` is the
        device's staged prompts, ``plen`` their lengths as (device, host);
        ``table`` the paged pool's page table on the device, ``host_table``
        the host's copy."""
        plen_dev, plen_host = plen
        # every slot's step kinds and spans (a step reads its rank's rows)
        schedule = segment_schedule(mode, pos, pfill, plen_host, num_steps=self.segment,
                                    prefill_chunk=self.cp)
        r0, r1 = (self.shard.r0, self.shard.r1) if self.shard is not None else (0, len(mode))

        def up(x):
            return torch.as_tensor(np.asarray(x)[r0:r1], dtype=torch.int32, device=self.device)

        return self._segment(cache, up(mode), up(tok), up(pos), gen, up(rem), up(pfill),
                             pend[r0:r1], plen_dev[r0:r1], schedule, table, self.shard,
                             host_table)

    def _stage(self, pend: torch.Tensor, plen: torch.Tensor, s: int, prompt) -> None:
        """Stage slot ``s``'s prompt on the device at admission: its pending
        row (pad-filled) and length."""
        row = np.full(pend.shape[1], self.pad_id, np.int32)
        row[:len(prompt)] = list(prompt)
        pend[s] = torch.from_numpy(row).to(self.device)
        plen[s] = len(prompt)

    def _post_dispatch(self, mode, pfill, plen, pend, owner) -> None:
        """Host-side bookkeeping after each segment."""

    def _release(self, s: int) -> None:
        """Slot ``s`` went FREE and its owner was harvested."""

    def _end(self, cache) -> None:
        """Workload drained (every slot released)."""

    @staticmethod
    def _mark():
        """The host-streamed KV counters now (``_host_kv_stats``'s mark)."""
        return SV.host_kv["fetched"], SV.host_pages["fetched"]

    def _host_kv_stats(self, stats, cache, mark) -> None:
        """Under ``n_host_chunks``: the KV bytes parked on the host and the
        slabs merged and pages fetched since ``mark`` (``_mark()``
        then), into ``stats``."""
        if self.n_host_chunks:
            stats.update(host_kv_bytes=SV.parked_bytes(self.cfg, cache),
                         host_kv_slabs=SV.host_kv["fetched"] - mark[0],
                         host_kv_pages=SV.host_pages["fetched"] - mark[1])

    # -- the scheduler ---------------------------------------------------
    def generate(self, prompts: Sequence[Union[Request, Sequence[int]]],
                 generator: Optional[torch.Generator] = None) -> List[List[int]]:
        """Run every prompt (a token sequence or a ``Request``, whose QoS
        fields this engine ignores) to completion (stop token or
        ``max_new_tokens``), re-using slots as sequences finish.  Returns
        one generated-token list per prompt (stop token included when one
        fired), in order.

        Per-dispatch timing and occupancy land in ``self.last_stats``:
        ``steps`` is a list of ``{ms, prefilling, emitted}`` records (one a
        segment), with ``dispatches`` and ``resets`` counters."""
        prompts = [list(as_request(p).tokens) for p in prompts]
        self._validate(prompts)
        queue = collections.deque(enumerate(prompts))
        out: List[List[int]] = [[] for _ in prompts]
        B = self.slots
        P, S = self._capacity(prompts)
        stats = self.telemetry.stats_view(
            {"steps": self.telemetry.steps_ring(), "dispatches": 0,
             "resets": 0, "capacity": S, "pending_len": P})
        self.last_stats = stats
        cache = self._begin(B, P, S)
        mark = self._mark()
        mode = np.full(B, FREE, np.int32)
        tok = np.zeros((B, 1), np.int32)
        pos = np.zeros(B, np.int32)
        rem = np.zeros(B, np.int32)
        pfill = np.zeros(B, np.int32)
        plen = np.ones(B, np.int32)
        pend_dev = torch.full((B, P), self.pad_id, dtype=torch.int32, device=self.device)
        plen_dev = torch.ones(B, dtype=torch.int32, device=self.device)
        owner: List[Optional[int]] = [None] * B

        while True:
            for s in range(B):
                if owner[s] is not None or not queue:
                    continue
                idx, prompt = queue[0]
                active = any(o is not None for o in owner)
                admitted = self._admit(cache, s, idx, prompt, active)
                if admitted is None:  # deferred: retry later
                    break
                cache, resume = admitted
                queue.popleft()
                owner[s] = idx
                n = len(prompt)
                self.telemetry.event(
                    "request.admit", request=idx, slot=s,
                    step=stats["dispatches"], prompt_len=n,
                    prefix_hit=int(resume))
                self._stage(pend_dev, plen_dev, s, prompt)
                plen[s], pfill[s], mode[s] = n, resume, PREFILL
                rem[s], pos[s], tok[s] = self.max_new, 0, self.pad_id
            if all(o is None for o in owner):
                break
            n_prefilling = int((mode == PREFILL).sum())
            with TM.timed_dispatch(self.telemetry, stats,
                                   prefilling=n_prefilling) as td:
                emits, valids, aux = self._dispatch(
                    cache, mode, tok, pos, generator, rem, pfill, pend_dev, (plen_dev, plen))
                cache = aux["cache"]
                mode, tok, pos, rem, pfill, em, va = harvest(aux, emits, valids, self.shard)
                td.emitted = int(va.sum())
            self._post_dispatch(mode, pfill, plen, pend_dev, owner)
            for s in range(B):
                if owner[s] is None:
                    continue
                got = [int(t) for t, v in zip(em[s], va[s]) if v]
                out[owner[s]].extend(got)
                if got:
                    self.telemetry.event(
                        "request.emit", request=owner[s], slot=s,
                        step=stats["dispatches"], n=len(got))
                if mode[s] == FREE:
                    self._release(s)
                    self.telemetry.event(
                        "request.complete", request=owner[s], slot=s,
                        step=stats["dispatches"], n=len(out[owner[s]]))
                    owner[s] = None
        self._host_kv_stats(stats, cache, mark)
        self._end(cache)
        return out


class BlockingServeEngine:
    """The stop-the-world continuous-batching baseline the fused scheduler
    is measured against.

    Prompts are right-padded into a fixed ``bucket`` length and prefilled
    position-masked (``prefill_step(..., lengths=...)``: FPDT, so the
    hand-written ``flash_fwd`` on the card), decode runs in
    ``decode_tokens`` segments of ``segment`` steps, and between segments
    finished rows are harvested and their slots re-prefilled with queued
    prompts (``insert_slot``): every refill stops the other slots for a
    full-bucket prefill.  Variable prompt lengths need a pure
    global-attention layout (see ``prefill_step``); a recurrent arch can
    use this engine only when every prompt fills the bucket exactly.
    ``ServeEngine`` lifts both limits.
    """

    def __init__(self, cfg: ModelConfig, params: Params, *, slots: int,
                 bucket: int, max_new_tokens: int,
                 n_host_chunks: int = 0, sampling: SamplingConfig = GREEDY,
                 stop_tokens: Sequence[int] = (), pad_id: int = 0,
                 segment: int = 8, par: Optional[ParallelContext] = None):
        self.cfg, self.params, self.par = cfg, params, par
        self.slots, self.bucket = slots, bucket
        self.max_new = max_new_tokens
        self.max_len = bucket + max_new_tokens
        self.sampling, self.pad_id = sampling, pad_id
        self.segment = segment
        self.n_host_chunks = n_host_chunks
        self._stop = tuple(stop_tokens)
        self._stop_set = frozenset(int(t) for t in self._stop)
        _one_rank(par, "BlockingServeEngine")
        self.device = tree_leaves(params)[0].device
        self.telemetry = TM.Telemetry(component="blocking-engine", program_limit=2)
        self.last_stats: Dict[str, Any] = self.telemetry.stats_view()
        if n_host_chunks and self.max_len % n_host_chunks:
            # models/serve.py would attend on the device for a count that
            # does not divide: the operator would serve another program
            raise ValueError(
                f"n_host_chunks={n_host_chunks} does not divide the cache "
                f"length bucket+max_new_tokens={self.max_len}; host-KV "
                f"streaming requires equal slabs")

    def _prefill(self, toks: torch.Tensor, lengths: Optional[torch.Tensor]):
        return SV.prefill_step(self.cfg, self.par, self.params, {"tokens": toks},
                               max_len=self.max_len, lengths=lengths)

    def _pad(self, rows: List[List[int]]) -> Tuple[torch.Tensor, torch.Tensor]:
        lengths = [len(r) for r in rows]
        for i, n in enumerate(lengths):
            if not 0 < n <= self.bucket:
                raise ValueError(
                    f"prompt {i} has length {n}; the blocking engine "
                    f"requires lengths in (0, bucket={self.bucket}] — use "
                    f"ServeEngine for longer prompts (chunked prefill)")
        toks = torch.as_tensor(
            [list(r) + [self.pad_id] * (self.bucket - len(r)) for r in rows],
            dtype=torch.int32, device=self.device)
        return toks, torch.as_tensor(lengths, dtype=torch.int32, device=self.device)

    def generate(self, prompts: Sequence[Union[Request, Sequence[int]]],
                 generator: Optional[torch.Generator] = None) -> List[List[int]]:
        """Run every prompt (a token sequence or a ``Request``) to completion
        (stop token or ``max_new_tokens``), re-using slots as sequences
        finish.  Returns one generated-token list per prompt (stop token
        included when one fired), in order."""
        prompts = [list(as_request(p).tokens) for p in prompts]
        queue = collections.deque(enumerate(prompts))
        out: List[List[int]] = [[] for _ in prompts]
        B, V = self.slots, self.cfg.vocab_size
        stats = self.telemetry.stats_view(
            {"steps": self.telemetry.steps_ring(), "dispatches": 0,
             "refills": 0})
        self.last_stats = stats

        # initial fill: the first B prompts in one batched prefill; a short
        # queue fills the trailing slots with a dummy row that starts done
        first = [queue.popleft() for _ in range(min(B, len(queue)))]
        rows = [list(p) for _, p in first] + [[self.pad_id] * self.bucket] * (B - len(first))
        toks, lengths = self._pad(rows)
        # no pads: unmasked prefill (lengths=None), the path a recurrent
        # layout can take, since prefill_step refuses lengths=...
        no_pads = all(len(r) == self.bucket for r in rows)
        logits, cache = self._prefill(toks, None if no_pads else lengths)
        if self.n_host_chunks:
            SV.offload_kv(self.cfg, cache, self.device)
        stats["dispatches"] += 1
        tok = sample_token(logits[:, :V], generator, self.sampling).cpu().numpy()
        owner: List[Optional[int]] = [i for i, _ in first] + [None] * (B - len(first))
        for s, o in enumerate(owner):
            if o is not None:
                out[o].append(int(tok[s]))
        pos = np.array([len(r) for r in rows], np.int32)
        # a prefill-sampled first token may itself be a stop token (or the
        # whole budget): such rows start done and are refilled at the next
        # harvest, never entering a segment as live
        done = np.array([o is None or int(tok[s]) in self._stop_set or self.max_new <= 1
                         for s, o in enumerate(owner)])
        rem = np.full(B, self.max_new - 1, np.int32)

        def up(x, dtype=torch.int32):
            return torch.as_tensor(x, dtype=dtype, device=self.device)

        while not all(o is None for o in owner):
            # the span times the whole stop-the-world segment: decode,
            # harvest and any synchronous refill prefills
            with TM.timed_dispatch(self.telemetry, stats) as td:
                n_refills = 0
                toks_seg, aux = decode_tokens(
                    self.cfg, self.par, self.params, cache, up(tok[:, None]), pos,
                    num_steps=self.segment, n_host_chunks=self.n_host_chunks,
                    sampling=self.sampling, stop_tokens=self._stop, pad_id=self.pad_id,
                    generator=generator, done=up(done, torch.bool), remaining=up(rem))
                cache = aux["cache"]
                flat = torch.cat([aux["tok"][:, 0], aux["pos"], aux["remaining"],
                                  aux["done"].to(torch.int32), toks_seg.flatten()]
                                 ).cpu().numpy()
                new_rem = flat[2 * B:3 * B]
                emitted = rem - new_rem
                tok, pos, rem = flat[:B].copy(), flat[B:2 * B].copy(), new_rem.copy()
                done = flat[3 * B:4 * B].astype(bool)
                seg_host = flat[4 * B:].reshape(B, -1)
                for s in range(B):
                    if owner[s] is None:
                        continue
                    out[owner[s]].extend(int(t) for t in seg_host[s, : emitted[s]])
                    if not done[s]:
                        continue
                    if not queue:  # finished, nothing queued: park the slot
                        owner[s] = None
                        continue
                    # slot reuse: a one-row position-masked prefill written
                    # in: every other slot waits for it
                    idx, prompt = queue.popleft()
                    toks1, len1 = self._pad([list(prompt)])
                    logits1, cache1 = self._prefill(
                        toks1, None if len(prompt) == self.bucket else len1)
                    t0 = int(sample_token(logits1[:, :V], generator, self.sampling)[0])
                    insert_slot(cache, cache1, s)
                    n_refills += 1
                    stats["dispatches"] += 2
                    owner[s] = idx
                    out[idx].append(t0)
                    tok[s], pos[s] = t0, len(prompt)
                    done[s] = t0 in self._stop_set or self.max_new <= 1
                    rem[s] = self.max_new - 1
                _sync(self.device)
                stats["refills"] += n_refills
                td.prefilling = n_refills
                td.emitted = int(emitted.sum())
        return out
