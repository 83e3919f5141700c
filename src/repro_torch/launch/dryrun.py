"""The dry-run as a meta-device sweep: a rank's reckoned bytes, FLOPs and
collectives for every (arch x shape x mesh) cell.

The twin of the JAX package's ``launch/dryrun.py``.  JAX lowers and
compiles each cell over 512 fake devices and records what XLA reports of
the program.  PyTorch compiles no program, so this module reckons a rank's
share of the same cell from its shapes, with every tensor on the ``meta``
device (``launch/specs.py``) and no card touched:

* the meshes are JAX's production meshes: ``single`` is dp 16 x sp 16
  (``data`` x ``model``), ``multi`` dp 32 (``pod`` x ``data``) x sp 16;
* the config is ``launch/steps.py::tuned_config``'s, and a dense arch's
  ``long_500k`` decode cell streams its KV from the host in
  ``n_host_chunks`` slabs (8, or ``--chunks``), as JAX's cell does;
* the record keeps JAX's keys that come from the config (arch, shape,
  mesh, kind, chunks, offload, n_host_chunks, seq_len, global_batch,
  params, active_params) and writes one JSON per cell under JAX's file
  name.  In place of ``memory_analysis`` and ``cost_analysis`` it holds a
  ``"reckoned"`` object (reckoned from shapes, never measured):
    - ``param_bytes``: a training rank's ZeRO-3 shards
      (``launch/shardings.py::param_plans``); a serve rank holds the whole
      weight tree, as the port's and JAX's serve engines do;
    - ``opt_state_bytes`` (train): the rank's AdamW moments and step
      (``state_bytes``);
    - ``input_bytes``: the rank's share of the batch (rows over data,
      positions over model where they divide: JAX's ``batch_shardings``);
    - ``cache_bytes`` / ``host_cache_bytes`` (prefill, decode): the rank's
      KV cache and recurrent state on the device, and what it parks in
      pinned host memory (``models/serve.py::rank_cache_bytes``);
    - ``peak_bytes`` (train): the training peak (``reckoned_peak_gib``);
    - ``model_flops`` and ``model_flops_per_rank`` (train): a step's model
      FLOPs (``model_flops``) and a rank's even share of them;
    - ``collectives`` (train): each collective's ``{count, bytes}`` a rank
      hands in a step, under the port's names (``train_collectives``);
  and ``reckon_s``, the seconds the reckoning took.

Not ported: ``hlo.py``'s op count, ``parse_collectives``, the lower and
compile seconds and ``cost_analysis``'s ``bytes_accessed``: they read an
XLA program that does not exist here.  Unlike JAX's module this one sets
nothing in the environment at import.

The reckoners (``model_flops``, ``reckoned_peak_gib``,
``train_collectives`` and the ones it sums) are the ones ``chip_smoke.py``
holds the card's readings to: its training phases' peaks and its gloo
ranks' collective counts.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k --mesh both
  python -m repro_torch.launch.dryrun --all --out /tmp/dry
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, ModelConfig, ShapeConfig, get_config,
                                 shape_applicable)
from repro_torch.core import fpdt as F
from repro_torch.core import parallel as P
from repro_torch.launch import shardings as SH
from repro_torch.launch import specs as SP
from repro_torch.launch import steps as ST
from repro_torch.models import mamba as MB
from repro_torch.models import moe as MOE
from repro_torch.models import serve as SV
from repro_torch.models import transformer as T
from repro_torch.optim import compression as C
from repro_torch.tree import tree_leaves, tree_leaves_with_path

# (dp, sp) of JAX's production meshes: (16, 16) and (2 pods x 16, 16)
MESHES = {"single": (16, 16), "multi": (32, 16)}

# adamw.apply's fp32 temporaries an element of the slice it updates
# (``UPDATE_SLICE``): g, m1, v1, m-hat, v-hat, the step and the operands
# of each, 36 bytes at their most (tools/adamw_temporaries.py counts them;
# tests/test_torch_adamw.py holds this constant to that count)
ADAMW_BYTES, ADAMW_SLICE = 36, 1 << 26


# ---------------------------------------------------------------------------
# the reckoners
# ---------------------------------------------------------------------------


def live_pairs(sq, sk, q_offset, k_offset, window=0):
    """Causal (q, k) pairs these offsets leave live; with window > 0 only
    keys with qpos - kpos < window."""
    live = 0
    for r in range(sq):
        qpos = q_offset + r
        hi = min(sk - 1, qpos - k_offset)  # last key index the row sees
        lo = max(0, qpos - window + 1 - k_offset) if window > 0 else 0
        live += max(0, hi - lo + 1)
    return live


def model_flops(cfg: ModelConfig, b: int, s: int) -> int:
    """Model FLOPs of one training step: 6 N per token for the weights that
    a token touches (N = ``cfg.num_active_params()``: for an MoE model the
    router and the experts_per_token experts a token is routed to, not all
    of them, the model FLOPs convention; the dense models' N is all of
    ``num_params``), plus, in each attention layer, 12 d per live (q, k)
    pair and q-head (4 d forward, 8 d backward) under that layer's causal
    mask and window (none for attn, ``cfg.window`` for local_attn).  RG-LRU
    layers have no pairs: their weights are in N."""
    pairs = {}
    attn = 0
    for kind in cfg.layer_kinds():
        if kind in ("attn", "local_attn"):
            window = cfg.window if kind == "local_attn" else 0
            if window not in pairs:
                pairs[window] = live_pairs(s, s, 0, 0, window)
            attn += 12 * cfg.head_dim * cfg.num_heads * pairs[window] * b
    return 6 * cfg.num_active_params() * b * s + attn


def adamw_slice(shape) -> int:
    """Elements of the largest slice ``adamw.apply`` updates at once of a
    leaf of ``shape`` (its leading-axis slices of about ADAMW_SLICE)."""
    n = math.prod(shape)
    if not shape or n <= ADAMW_SLICE:
        return n
    row = n // shape[0]
    return max(1, ADAMW_SLICE // row) * row


def reckoned_peak_gib(cfg: ModelConfig, sp: int, seq: int, dp: int = 1, batch: int = 1) -> float:
    """A rank's peak device memory in a training step over ``batch`` rows
    of ``seq`` tokens on a dp x sp mesh, reckoned from the shapes before
    the run: the training state (the rank's shards of the weights, their
    gradients and the AdamW moments, ``launch/shardings.py``; on one rank
    bf16 weights and gradients and fp32 moments, 12 bytes a parameter) and
    the larger of two phases.  AdamW: ADAMW_BYTES a element of the largest
    slice it updates at once.  The backward: every cycle's saved input
    (remat full) and the largest of the tail layers' activations, one
    cycle's recompute (under a mesh with its gathered weights and their
    whole gradients, the expert stacks under expert parallelism the rank's
    e/sp experts) and the loss's (the head's gradient and a chunk's next
    one, under a mesh with the gathered table); with per token and layer
    the tensors a block keeps for its backward (counted from the code:
    RG-LRU 4d + 48 di + 6 d_ff bytes, attention 4d + 6 hq dh + 6 d_ff,
    with the MoE FFN 4d + 6 hq dh + 2d, Mamba 2d + 30 di), for an ssm
    layer the selective scan's block in its backward (a, b, the states and
    their gradients: six fp32 [rows, 256, di, ds], rows = u under sp > 1)
    and for an MoE layer one chunk's backward (its routing's four int64
    [T, k, e], the [e, g, cap] slots at 4d + 8 d_ff bytes, the k gathered
    outputs, twice for their gradients).  Not measured: an estimate to
    print beside a reading (and, for ``chip_smoke.py``'s ZeRO-3 case, the
    band it is held to)."""
    tokens = batch * seq // (sp * dp)
    d, di, ff = cfg.d_model, cfg.d_inner, cfg.d_ff
    attn = 4 * d + 6 * cfg.num_heads * cfg.head_dim
    per_token = {"rglru": 4 * d + 48 * di + 6 * ff, "local_attn": attn + 6 * ff,
                 "ssm": 2 * d + 30 * di, "attn": attn + (2 * d if cfg.num_experts else 6 * ff)}
    rows = cfg.fpdt_chunks if sp > 1 else 1
    block = 6 * rows * MB.BLOCK_S * di * cfg.ssm_state * 4
    if cfg.num_experts:  # one chunk of the MoE FFN in its backward
        e, k, n = cfg.num_experts, cfg.experts_per_token, max(1, cfg.mlp_chunks)
        t = tokens // n
        tg = min(MOE.GROUP_TOKENS, t)
        slots = e * (t // tg) * MOE.capacity(tg, cfg)
        block = 2 * (4 * t * k * e * 8 + slots * (4 * d + 8 * ff) + t * k * d * 2)

    def layers(kinds):
        return sum(tokens * per_token[k] + (block if k == "ssm" or cfg.num_experts else 0)
                   for k in kinds)

    pat, n_cycles, tail = T.layout_of(cfg)
    plans = SH.param_plans(cfg, dp, sp)
    leaves = tree_leaves(plans)
    state = SH.state_bytes(plans, getattr(torch, cfg.opt_state_dtype)) + sum(
        p.local_bytes() for p in leaves)
    adamw = ADAMW_BYTES * max(adamw_slice(p.local_shape()) for p in leaves)
    meshed = dp * sp > 1
    table = cfg.padded_vocab * d * getattr(torch, cfg.param_dtype).itemsize
    ep = sp > 1 and cfg.num_experts and cfg.num_experts % sp == 0

    def used(names, p):  # a cycle stack's bytes as the model gathers it
        whole = math.prod(p.shape) * p.dtype.itemsize
        return whole // sp if ep and SH.is_expert_leaf(names) else whole

    cycle = (2 * sum(used(n, p) for n, p in tree_leaves_with_path(plans["cycles"]))
             // n_cycles if meshed else 0)
    backward = n_cycles * tokens * d * 2 + max(layers(pat) + cycle, layers(tail),
                                               (3 if meshed else 2) * table)
    return (state + max(adamw, backward)) / 2**30


def live_off_diagonal(cfg: ModelConfig, seq: int, window: int) -> int:
    """The live (i, j < i) chunk pairs of an FPDT layer over ``seq`` tokens."""
    u = cfg.fpdt_chunks
    return sum(F.pair_live(i, j, cq=seq // u, window=window, sparsity=cfg.attn_sparsity)
               for i in range(u) for j in range(i))


def fpdt_collectives(cfg: ModelConfig, kind: str, sp: int, b: int, seq: int, passes: int,
                     x_bytes: int, window: int = 0):
    """(calls, bytes) of each collective that one FPDT attention layer hands
    in on a rank over ``passes`` forwards and one backward, as
    ``core/fpdt.py`` issues them: per chunk, ulysses sends q (and k, v where
    hkv % sp == 0) through seq_to_heads and o back, and in the backward do
    out and dq (dk, dv) back as each chunk finishes, in x's dtype; gathered
    KV (ulysses with hkv % sp != 0, and cp) goes through gather_seq in x's
    dtype and its dk, dv come back through reduce_scatter_seq in fp32 over
    the chunk's tokens and every kv head.  A forward that offloads (the
    last, the recompute under remat, when ``cfg.fpdt_offload`` and u > 1)
    keeps the rank's own slice of gathered KV on the host, so it gathers
    each k and v again for every live off-diagonal pair that fetches it,
    and the backward gathers each chunk's once after its fetch."""
    u = cfg.fpdt_chunks
    c = seq // u // sp
    q = b * cfg.num_heads * c * cfg.head_dim * x_bytes  # a rank's q, o, do or dq of a chunk
    kv = b * cfg.num_kv_heads * c * cfg.head_dim * x_bytes  # its k, v, dk or dv
    kv32 = b * cfg.num_kv_heads * c * sp * cfg.head_dim * 4  # a chunk's dk or dv, fp32
    calls, nbytes = dict.fromkeys(P.COLLECTIVES, 0), dict.fromkeys(P.COLLECTIVES, 0)

    def add(name, n, size):
        calls[name] += n
        nbytes[name] += n * size

    if kind == "ulysses":
        add("seq_to_heads", passes * u + u, q)  # q in each forward, do in the backward
        add("heads_to_seq", passes * u + u, q)  # o, dq
    if kind == "ulysses" and cfg.num_kv_heads % sp == 0:
        add("seq_to_heads", 2 * passes * u, kv)
        add("heads_to_seq", 2 * u, kv)
    else:
        fetches = (live_off_diagonal(cfg, seq, window) + u
                   if cfg.fpdt_offload and u > 1 else 0)
        add("gather_seq", 2 * passes * u + 2 * fetches, kv)
        add("reduce_scatter_seq", 2 * u, kv32)
    return calls, nbytes


def mixer_collectives(cfg: ModelConfig, kind: str, sp: int, b: int, passes: int, x_bytes: int):
    """(calls, bytes) of gather_spans and reduce_scatter_spans that one
    recurrent layer (rglru or ssm) hands in on a rank over ``passes``
    forwards and one backward under sp > 1 (``models/mamba.py``): each
    forward gathers the [b, u, d_conv - 1, di] conv tails in x's dtype and
    the fp32 span summaries ([b, u, 2 di] for RG-LRU, [b, u, di (1 + ds)]
    for Mamba); the backward reduce-scatters both, sp times the bytes."""
    u, di = cfg.fpdt_chunks, cfg.d_inner
    width = 2 * di if kind == "rglru" else di * (1 + cfg.ssm_state)
    sent = b * u * ((cfg.d_conv - 1) * di * x_bytes + width * 4)
    return ({"gather_spans": 2 * passes, "reduce_scatter_spans": 2},
            {"gather_spans": passes * sent, "reduce_scatter_spans": sp * sent})


def zero_collectives(cfg: ModelConfig, dp: int, sp: int, compress: bool = False):
    """(calls, bytes) of gather_params, reduce_scatter_grads and the
    gradients' all_reduce_sum in one training step's value_and_grad and
    reduce_grads on a rank of a dp x sp mesh under remat full (with
    ``compress``, and the int8 compression's all_reduce_max), as
    ``launch/shardings.py`` places the leaves: a gather sends the rank's
    shard over data, then what it has over model; its adjoint sends the
    whole gradient over model, then what is left over data.  A cycle's leaf
    is gathered twice a cycle (the checkpoint's pass and its recompute: its
    cycle's view, or the whole stack where its cycles axis is split) and
    reduce-scattered once; the tied table twice (lookup and head), every
    other leaf once.  An MoE expert stack (wu, wg, wd) whose e splits over
    model (expert parallelism, sp > 1) is gathered and reduce-scattered
    over data only: the rank runs its e/sp experts.  Each leaf replicated
    on an axis with ranks is summed once (over the world where it is split
    on neither).  Compression reduces the block maxima of every leaf whose
    shards' runs of the whole flat leaf (``SH.run_length``) are not whole
    2048-element blocks with MAX, one call for each of the data, model and
    both groups such leaves are split over, 4 bytes a block of those
    leaves."""
    _, n_cycles, _ = T.layout_of(cfg)
    names = ("gather_params", "reduce_scatter_grads", "all_reduce_sum", "all_reduce_max")
    calls, nbytes = dict.fromkeys(names, 0), dict.fromkeys(names, 0)
    groups = set()
    ep = sp > 1 and cfg.num_experts and cfg.num_experts % sp == 0
    for path, plan in SH.by_path(SH.param_plans(cfg, dp, sp)).items():
        full, local = math.prod(plan.shape) * plan.dtype.itemsize, plan.local_bytes()
        expert = ep and SH.is_expert_leaf(path.split("/"))
        uses, passes = 1, 1
        if path.startswith("cycles/"):
            uses, passes = n_cycles, 2
            if not plan.splits_cycles:
                full, local = full // n_cycles, local // n_cycles
        elif path == "embed" and cfg.tie_embeddings:
            uses = 2
        if plan.data_split:
            calls["gather_params"] += passes * uses
            nbytes["gather_params"] += passes * uses * local
            calls["reduce_scatter_grads"] += uses
            nbytes["reduce_scatter_grads"] += uses * (full // sp if plan.model_split else full)
        if plan.model_split and not expert:
            calls["gather_params"] += passes * uses
            nbytes["gather_params"] += passes * uses * local * (dp if plan.data_split else 1)
            calls["reduce_scatter_grads"] += uses
            nbytes["reduce_scatter_grads"] += uses * full
        if (dp > 1 and not plan.data_split) or (sp > 1 and not plan.model_split):
            calls["all_reduce_sum"] += 1
            nbytes["all_reduce_sum"] += plan.local_bytes()
        if (compress and (plan.data_split or plan.model_split)
                and SH.run_length(plan) % C.BLOCK):
            groups.add((plan.data_split, plan.model_split))
            nbytes["all_reduce_max"] += 4 * -(-math.prod(plan.shape) // C.BLOCK)
    calls["all_reduce_max"] = len(groups)
    return calls, nbytes


def slot_collectives(cfg: ModelConfig, dp: int, sp: int, b: int, seq: int, passes: int,
                     last: bool):
    """{name: (calls, bytes)} of dispatch_slots and combine_slots that one
    MoE layer hands in on a rank of data rank 0 under expert parallelism
    (e % sp == 0, sp > 1; none else), ``b`` rows of ``seq`` tokens a data
    rank (``models/moe.py``): every rank runs every chunk.  A forward
    dispatches a chunk's slots [e, G, cap, d] in the weights' dtype (G the
    groups of GROUP_TOKENS (or the chunk's B L tokens) that the model
    group's rows of the chunk touch; sent whole) and combines its e/sp
    experts' (a sp-th); the backward goes the other way round.  A chunk
    runs ``passes`` forwards of the layer plus its own checkpoint's
    recompute, and one backward; in a remat-full cycle (``passes`` 2) the
    cycle's recompute (a non-reentrant checkpoint, which stops early) ends
    once it has saved the inputs of the last chunk of the cycle's last
    layer (``last``), so that chunk runs one forward less."""
    out = {"dispatch_slots": (0, 0), "combine_slots": (0, 0)}
    e = cfg.num_experts
    if sp == 1 or e % sp:
        return out
    n = cfg.mlp_chunks if cfg.mlp_chunks > 1 and seq % cfg.mlp_chunks == 0 else 1
    L, B = seq // n, b * dp
    tg = min(MOE.GROUP_TOKENS, B * L)
    groups = (b * L - 1) // tg + 1
    cap = max(4, min(math.ceil(tg * cfg.experts_per_token / e * cfg.moe_capacity_factor), tg))
    full = e * groups * cap * cfg.d_model * (4 if cfg.param_dtype == "float32" else 2)
    fwd = n * (passes + 1) - (passes == 2 and last)
    return {"dispatch_slots": (fwd + n, fwd * full + n * full // sp),
            "combine_slots": (fwd + n, fwd * full // sp + n * full)}


def train_collectives(cfg: ModelConfig, kind: str, dp: int, sp: int, b: int, seq: int,
                      compress: bool = False):
    """(calls, bytes) of each collective a training step hands in on a rank
    of a dp x sp mesh under remat full (``b`` rows of ``seq`` tokens a data
    rank): every attention or recurrent layer of a cycle runs two forwards
    (the checkpoint's pass and its recompute), a tail layer one; an MoE
    layer's forward gathers its counts once where a group or a chunk spans
    ranks (``MOE.mesh_plan``: rows x e int32), and under expert
    parallelism moves its slots (``slot_collectives``); loss_fn sums (loss,
    count) over the world once (8 bytes; 12 with an MoE model's aux); the
    ZeRO-3 gathers, reduce-scatters and gradient sums
    (``zero_collectives``); the global norm sums 8 bytes over data and 4
    over model where the axis has ranks; the loop sums its two stop flags
    once (8 bytes).  A data-only mesh attends locally (``T.attn_kind``): no
    FPDT collective.  ``compress``: and the compression's block maxima
    (``zero_collectives``)."""
    pat, n_cycles, tail = T.layout_of(cfg)
    calls, nbytes = dict.fromkeys(P.COLLECTIVES, 0), dict.fromkeys(P.COLLECTIVES, 0)
    x_bytes = 2 if cfg.param_dtype == "bfloat16" else 4
    moe_rows = 0
    if cfg.num_experts:
        n = cfg.mlp_chunks if cfg.mlp_chunks > 1 and seq % cfg.mlp_chunks == 0 else 1
        moe_rows = MOE.mesh_plan(cfg, seq, b * dp, sp, dp, n, 0).rows
    layers = [(k, 2, i == len(pat) - 1) for _ in range(n_cycles) for i, k in enumerate(pat)]
    for k, passes, last in layers + [(k, 1, False) for k in tail]:
        if k in ("attn", "local_attn") and moe_rows:
            calls["gather_counts"] += passes
            nbytes["gather_counts"] += passes * moe_rows * cfg.num_experts * 4
        if k in ("attn", "local_attn") and cfg.num_experts:
            for name, (n, size) in slot_collectives(cfg, dp, sp, b, seq, passes, last).items():
                calls[name] += n
                nbytes[name] += size
        if k in ("attn", "local_attn") and kind != "local":
            c, n = fpdt_collectives(cfg, kind, sp, b, seq, passes, x_bytes,
                                    cfg.window if k == "local_attn" else 0)
        elif k in ("attn", "local_attn"):
            continue
        elif sp > 1:
            c, n = mixer_collectives(cfg, k, sp, b, passes, x_bytes)
        else:
            continue
        for name in c:
            calls[name] += c[name]
            nbytes[name] += n[name]
    c, n = zero_collectives(cfg, dp, sp, compress)
    for name in c:
        calls[name] += c[name]
        nbytes[name] += n[name]
    calls["all_reduce_sum"] += 2 + (dp > 1) + (sp > 1)
    nbytes["all_reduce_sum"] += (12 if cfg.num_experts else 8) + 8 + 8 * (dp > 1) + 4 * (sp > 1)
    return calls, nbytes


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------


def _batch_bytes(tree, dp: int, sp: int) -> int:
    """A rank's bytes of an input tree under JAX's ``batch_shardings``: the
    rows over data and the positions over model where they divide (a
    scalar whole)."""
    total = 0
    for t in tree_leaves(tree):
        shape = list(t.shape)
        if shape and shape[0] % dp == 0:
            shape[0] //= dp
        if len(shape) >= 2 and shape[1] % sp == 0 and shape[1] >= sp:
            shape[1] //= sp
        total += math.prod(shape) * t.element_size()
    return total


def host_kv_chunks(cfg: ModelConfig, shape: ShapeConfig, chunks: Optional[int]) -> int:
    """The host-KV slab count of a cell: a dense arch's decode at 500 K
    positions or more streams its KV from the host in ``chunks`` (8 by
    default) slabs, which must divide the cache (JAX's ValueError); every
    other cell keeps its KV on the device (0)."""
    if not (shape.kind == "decode" and shape.seq_len >= 500_000 and cfg.family in ("dense",)):
        return 0
    n = chunks if chunks else 8
    if shape.seq_len % n:
        raise ValueError(f"--chunks {n} does not divide the decode cache length "
                         f"{shape.seq_len}; the host-streamed path requires equal slabs")
    return n


def reckon(cfg: ModelConfig, shape: ShapeConfig, dp: int, sp: int,
           n_host_chunks: int = 0) -> Dict[str, object]:
    """The ``"reckoned"`` object of a cell (module docstring) for a rank of
    a dp x sp mesh."""
    kind, specs = SP.input_specs(cfg, shape)
    # the chunking changes no weight: one plan a mesh serves every shape
    plans = SH.param_plans(dataclasses.replace(cfg, fpdt_chunks=1, fpdt_offload=False,
                                               mlp_chunks=1), dp, sp)
    out: Dict[str, object] = {}
    if kind == "train":
        B, S = shape.global_batch, shape.seq_len
        params = sum(p.local_bytes() for p in tree_leaves(plans))
        out["param_bytes"] = params
        out["opt_state_bytes"] = (SH.state_bytes(plans, getattr(torch, cfg.opt_state_dtype))
                                  - params)
        out["input_bytes"] = _batch_bytes(specs["batch"], dp, sp)
        out["peak_bytes"] = round(reckoned_peak_gib(cfg, sp, S, dp, B) * 2**30)
        flops = model_flops(cfg, B, S)
        out["model_flops"] = flops
        out["model_flops_per_rank"] = flops / (dp * sp)
        calls, nbytes = train_collectives(cfg, T.attn_kind_on(cfg, sp), dp, sp, B // dp, S)
        out["collectives"] = {k: {"count": calls[k], "bytes": nbytes[k]}
                              for k in P.COLLECTIVES if calls[k]}
        return out
    out["param_bytes"] = sum(math.prod(p.shape) * p.dtype.itemsize for p in tree_leaves(plans))
    if kind == "prefill":
        out["input_bytes"] = _batch_bytes(specs["batch"], dp, sp)
        cache = SV.init_cache(cfg, shape.global_batch, shape.seq_len, "meta")
    else:
        out["input_bytes"] = _batch_bytes(specs["inp"], dp, sp) + specs["pos"].element_size()
        cache = specs["cache"]
    out["cache_bytes"], out["host_cache_bytes"] = SV.rank_cache_bytes(cfg, dp, sp, cache,
                                                                      n_host_chunks)
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool, chunks=None, offload=None,
             outdir: str = "experiments/dryrun") -> dict:
    """Reckon one cell, write its record under ``outdir`` and print its
    status line; a planner's refusal is recorded (``ok`` false, the error
    and traceback), as JAX records a failed compile."""
    shape = SHAPES[shape_name]
    mesh = "multi" if multi_pod else "single"
    dp, sp = MESHES[mesh]
    cfg = ST.tuned_config(get_config(arch), shape, chunks=chunks, offload=offload)
    n_host_chunks = host_kv_chunks(cfg, shape, chunks)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh,
        "kind": shape.kind, "chunks": cfg.fpdt_chunks, "offload": cfg.fpdt_offload,
        "n_host_chunks": n_host_chunks,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "params": cfg.num_params(), "active_params": cfg.num_active_params(),
        "dp": dp, "sp": sp,
    }
    t0 = time.perf_counter()
    try:
        rec["reckoned"] = reckon(cfg, shape, dp, sp, n_host_chunks)
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 - report, don't crash the sweep
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["reckon_s"] = round(time.perf_counter() - t0, 3)
    os.makedirs(outdir, exist_ok=True)
    suffix = "" if chunks is None else f"_u{chunks}" + ("off" if offload else "")
    with open(os.path.join(outdir, f"{arch}_{shape_name}_{mesh}{suffix}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    r = rec.get("reckoned", {})
    mem = r.get("peak_bytes", r.get("cache_bytes", 0) + r.get("param_bytes", 0))
    print(f"[{'OK ' if rec['ok'] else 'FAIL'}] {arch:28s} {shape_name:12s} {mesh:6s} "
          f"reckon={rec['reckon_s']}s device={mem / 2**30:.2f}GiB "
          f"host={r.get('host_cache_bytes', 0) / 2**30:.3f}GiB"
          + ("" if rec["ok"] else f"  {rec['error'][:150]}"), flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--chunks", type=int, default=None)
    ap.add_argument("--offload", action="store_true", default=None)
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES if shape_applicable(a, s)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    fails = 0
    for a, s in cells:
        for mp in meshes:
            rec = run_cell(a, s, mp, chunks=args.chunks, offload=args.offload, outdir=args.out)
            fails += 0 if rec["ok"] else 1
    print(f"\n{len(cells) * len(meshes) - fails} ok, {fails} failed")
    raise SystemExit(1 if fails else 0)


if __name__ == "__main__":
    main()
