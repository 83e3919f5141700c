"""Model assembly: parameters stacked over layer cycles, as in the JAX package.

Layers are grouped into repeating *cycles* of the arch's block pattern
(dense: a 1-layer cycle) and each cycle's parameters are stacked along a
leading axis, so ``params["cycles"]["pos0"]["attn"]["wq"]`` is
``[n_cycles, d, q_dim]`` exactly like the JAX pytree; remainder layers live
in ``params["tail"]``.  The training forward (``hidden_forward``,
``loss_fn``) runs the cycles as a Python loop over views of the stacks, so
the gradients of ``params["cycles"]`` come out stacked with the JAX
pytree's shapes; ``remat="full"`` wraps each cycle in a non-reentrant
``torch.utils.checkpoint`` whose first pass offloads nothing, and
``remat="offload"`` runs each cycle as ``_OffloadedCycle``, which keeps the
cycle's input in pinned host memory between the forward and the backward
(the JAX package's ``block_in`` offload policy).  The ported block kinds are
attention (attn, local_attn), RG-LRU (rglru) and Mamba-1 (ssm), with the
token, audio-frame and vision-patch frontends (``embed_input``; an audio
model has no ``embed`` table); an attention block of an MoE config
(``num_experts``) runs the MoE FFN (``models/moe.py``) in place of its
MLP, and its load-balancing aux rides beside h through every cycle, remat
form included, into the loss's ``0.01 * aux``.

Under a mesh every leaf is stored as ``launch/shardings.py`` places it
(ZeRO-3: ``init_params(..., par)`` keeps only the rank's shards) and is
gathered where it is used (the MoE expert stacks, under expert
parallelism, over data only: the rank runs its model rank's experts,
``models/moe.py``): a cycle's weights inside ``_cycle``, so that
the checkpoint's recompute (remat full) and ``_OffloadedCycle``'s backward
gather them again and a cycle's whole weights live only while it runs; a
tail block's and the final norm's at their block; the embedding table at
the lookup and, again, for the loss's head (outside the loss chunks'
checkpoints, so it is gathered once, and a tied table's two uses reduce
into its one shard gradient).  Under ``remat="none"`` autograd keeps what
each layer's products saved, its gathered weights among them, until the
backward.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig
from repro_torch.core import fpdt
from repro_torch.core import parallel as P
from repro_torch.core.chunked_loss import IGNORE, auto_chunks, softmax_xent_chunked
from repro_torch.data.pipeline import token_positions
from repro_torch.core.parallel import ParallelContext
from repro_torch.launch import shardings as SH
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as R
from repro_torch.runtime.placement import host_offload, no_offload
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = Dict[str, Any]

PORTED_KINDS = ("attn", "local_attn", "rglru", "ssm")


def _check_ported(cfg: ModelConfig):
    pat, _, tail = layout_of(cfg)
    bad = sorted({k for k in (*pat, *tail) if k not in PORTED_KINDS})
    if bad:
        raise NotImplementedError(f"{cfg.name}: block kinds {bad} are not yet ported")


def _init_block(cfg: ModelConfig, kind: str, gen: torch.Generator, dtype, device) -> Params:
    """A block of ``kind``: attention (attn and local_attn have the same
    parameters; the MoE FFN in place of the MLP under ``num_experts``) or
    rglru with its MLP, or ssm (a norm and the Mamba mixer, no MLP)."""
    if kind == "ssm":
        return {"norm": L.init_norm(cfg, dtype, device),
                "mixer": M.init_mamba(cfg, gen, dtype, device)}
    if kind == "rglru":
        mixer = {"mixer": R.init_rglru(cfg, gen, dtype, device)}
    else:
        mixer = {"attn": L.init_attn(cfg, gen, dtype, device)}
    ffn = ({"moe": MOE.init_moe(cfg, gen, dtype, device)} if cfg.num_experts and kind != "rglru"
           else {"mlp": L.init_mlp(cfg, gen, dtype, device)})
    return {
        "norm1": L.init_norm(cfg, dtype, device),
        **mixer,
        "norm2": L.init_norm(cfg, dtype, device),
        **ffn,
    }


def pattern_of(cfg: ModelConfig) -> Tuple[str, ...]:
    if cfg.block_pattern:
        return cfg.block_pattern
    return ("ssm",) if cfg.family == "ssm" else ("attn",)


def layout_of(cfg: ModelConfig):
    """(pattern, n_cycles, tail_kinds)."""
    pat = pattern_of(cfg)
    n_cycles = cfg.num_layers // len(pat)
    tail = tuple(pat[: cfg.num_layers % len(pat)])
    return pat, n_cycles, tail


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def cycle(tree, c: int):
    """The parameters (or cache) of layer cycle ``c``: views into the stacks."""
    return tree_map(lambda x: x[c], tree)


def unstack(tree, n: int):
    """The ``n`` per-cycle trees of a stacked tree, as views: one ``unbind``
    per leaf, whose backward stacks the cycles' gradients once.  A list is
    taken to hold the per-cycle trees already (``train_loop.value_and_grad``
    passes one leaf a cycle) and is returned as it is."""
    if isinstance(tree, list):
        if len(tree) != n:
            raise ValueError(f"{len(tree)} cycle trees, expected {n}")
        return tree
    parts = [x.unbind(0) for x in tree_leaves(tree)]
    return [tree_unflatten(tree, [p[c] for p in parts]) for c in range(n)]


def cycle_views(cfg: ModelConfig, par: Optional[ParallelContext], stacks, n: int):
    """The ``n`` per-cycle trees of the stacked (sharded) cycle parameters:
    each leaf a view of its cycle's slice, as ``unstack`` gives them, but
    under a mesh a stack split along its cycles axis
    (``shardings.LeafPlan.splits_cycles``) whole in every cycle's tree
    (``_cycle`` gathers it and takes its cycle).  A list is taken to hold
    the per-cycle trees already and is returned as it is."""
    plans = SH.plans_of(cfg, par)
    if isinstance(stacks, list) or plans is None:
        return unstack(stacks, n)
    whole = [p.splits_cycles for p in tree_leaves(plans["cycles"])]
    parts = [None if w else x.unbind(0) for w, x in zip(whole, tree_leaves(stacks))]
    return [tree_unflatten(stacks, [x if w else part[c] for w, x, part in
                                    zip(whole, tree_leaves(stacks), parts)])
            for c in range(n)]


def init_params(cfg: ModelConfig, gen: torch.Generator, device="cuda",
                par: Optional[ParallelContext] = None) -> Params:
    """Random parameters from ``gen`` (a generator on ``device``), in the
    JAX package's pytree layout and initialisation scales.  Under a mesh
    (``par``) each leaf is drawn whole, as on one rank, and only this
    rank's shard of it is kept (``launch/shardings.py``): the rank holds
    its shards and at most one whole cycle besides."""
    _check_ported(cfg)
    dtype = getattr(torch, cfg.param_dtype)
    pat, n_cycles, tail = layout_of(cfg)
    plans = SH.plans_of(cfg, par) or {}
    params: Params = {}
    if cfg.frontend != "audio_frames":  # the audio frontend embeds frames, not tokens
        embed = (0.02 * torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                                    device=device)).to(dtype)
        params["embed"] = SH.shard_tree(plans.get("embed"), embed, par)
    params["cycles"] = SH.shard_cycles_axis(plans.get("cycles"), _stack([
        SH.shard_tree(plans.get("cycles"), {f"pos{i}": _init_block(cfg, kind, gen, dtype, device)
                                            for i, kind in enumerate(pat)}, par, cycle=True)
        for _ in range(n_cycles)
    ]), par)
    if tail:
        params["tail"] = [SH.shard_tree(plans["tail"][i] if plans else None,
                                        _init_block(cfg, kind, gen, dtype, device), par)
                          for i, kind in enumerate(tail)]
    params["final_norm"] = SH.shard_tree(plans.get("final_norm"), L.init_norm(cfg, dtype, device),
                                         par)
    if not cfg.tie_embeddings:
        params["head"] = SH.shard_tree(plans.get("head"), L._dense_init(
            gen, (cfg.d_model, cfg.padded_vocab), dtype, device), par)
    return params


def head_matrix(cfg: ModelConfig, params: Params,
                par: Optional[ParallelContext] = None) -> torch.Tensor:
    """The [d, V] head (under a mesh gathered from this rank's shard)."""
    plans = SH.plans_of(cfg, par) or {}
    if cfg.tie_embeddings:
        return SH.gather(plans.get("embed"), params["embed"], par).T
    return SH.gather(plans.get("head"), params["head"], par)


def embed_input(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
                par: Optional[ParallelContext] = None):
    """The input hidden sequence (the modality frontends are stubs, as in
    the JAX package): token embeddings of ``batch["tokens"] [b, s]`` (under
    a mesh from the table gathered from this rank's shard); for the audio
    frontend ``batch["frame_embeds"] [b, s, d]`` plus the sinusoidal table
    cast to the frames' dtype, at each token's global position (under a
    mesh the rank's chunk-interleaved positions,
    ``data/pipeline.py::token_positions``); for the vision frontend
    ``batch["patch_embeds"] [b, P, d]`` cast to the table's dtype before
    the token embeddings (under a mesh the rank's patches and tokens, the
    patches first: ``shard_batch``)."""
    if cfg.frontend == "audio_frames":
        h = batch["frame_embeds"]
        pos = torch.arange(h.shape[1], device=h.device)
        if P.distributed(par):
            pos = torch.from_numpy(token_positions(h.shape[1] * par.sp, par.sp, par.sp_rank,
                                                   cfg.fpdt_chunks)).to(h.device)
        return h + L.sinusoidal_pos_emb(pos, cfg.d_model).to(h.dtype)[None]
    plans = SH.plans_of(cfg, par) or {}
    tok = SH.gather(plans.get("embed"), params["embed"], par)[batch["tokens"]]
    if cfg.frontend == "vision_patches":
        return torch.cat([batch["patch_embeds"].to(tok.dtype), tok], dim=1)
    return tok


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------


def has_attention(cfg: ModelConfig) -> bool:
    return any(k in ("attn", "local_attn") for k in cfg.layer_kinds())


def attn_kind(cfg: ModelConfig, par: Optional[ParallelContext]) -> str:
    """FPDT's kind: local without a mesh or on a data-only mesh (sp 1: a
    rank holds its rows' whole sequence, and ulysses or cp over one model
    rank would compute local's function through collectives); else
    ``attn_impl`` where it names ulysses or cp, ulysses where the heads
    split over the model ranks, cp where they do not."""
    if par is None or par.mesh is None or par.sp == 1:
        return "local"
    if cfg.attn_impl in ("ulysses", "cp"):
        return cfg.attn_impl
    return "ulysses" if cfg.num_heads % par.sp == 0 else "cp"


def block_apply(cfg: ModelConfig, par: Optional[ParallelContext], kind: str,
                p: Params, h: torch.Tensor):
    """One block: norm1 -> mixer (FPDT attention or RG-LRU) -> residual ->
    norm2 -> chunked MLP or MoE FFN -> residual; an ssm block is norm ->
    Mamba mixer -> residual.  Returns (h, aux): the MoE block's
    load-balancing loss (this rank's share under a mesh), None for every
    other block.  Under a mesh h holds this rank's tokens
    (``core/parallel.py``); everything but attention, the recurrent mixers'
    scans and convs (two passes over the spans of every rank,
    ``models/mamba.py``) and the MoE queue counts (``models/moe.py``) is
    per token."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"{kind!r} blocks are not yet ported")
    if kind == "ssm":
        y, _ = M.mamba_mixer(cfg, p["mixer"], L.apply_norm(cfg, p["norm"], h), par=par)
        return h + y, None
    hn = L.apply_norm(cfg, p["norm1"], h)
    if kind == "rglru":
        y, _ = R.rglru_mixer(cfg, p["mixer"], hn, par=par)
        h = h + y
    else:
        window = cfg.window if kind == "local_attn" else 0
        o = fpdt.fpdt_attention(cfg, par, p["attn"], hn, kind=attn_kind(cfg, par), window=window)
        h = h + o @ p["attn"]["wo"]
    hn2 = L.apply_norm(cfg, p["norm2"], h)
    if "moe" in p:
        y, aux = MOE.moe_ffn_chunked(cfg, p["moe"], hn2, cfg.mlp_chunks, par)
        return h + y, aux
    return h + L.mlp_chunked(cfg, p["mlp"], hn2, cfg.mlp_chunks), None


def _add_aux(total, aux):
    return aux if total is None else total if aux is None else total + aux


def _cycle(cfg, par, pat, cyc_p, h, c=0):
    """The blocks of layer cycle ``c``: (h, the sum of their aux or None).
    Under a mesh ``cyc_p`` holds the cycle's shards (``cycle_views``),
    gathered here (``shardings.gather_cycle``: the expert stacks over data
    only)."""
    plans = SH.plans_of(cfg, par)
    if plans is not None:
        cyc_p = SH.gather_cycle(plans["cycles"], cyc_p, c, par)
    total = None
    for i, kind in enumerate(pat):
        h, aux = block_apply(cfg, par, kind, cyc_p[f"pos{i}"], h)
        total = _add_aux(total, aux)
    return h, total


def _remat_contexts():
    """A per-cycle checkpoint's first pass keeps none of its saved tensors,
    so it offloads no FPDT chunk; the recompute in the backward does.  The
    two passes then save the chunks on different devices, which is why the
    checkpoint's metadata check is off (``determinism_check="none"``)."""
    return no_offload(), contextlib.nullcontext()


class _OffloadedCycle(torch.autograd.Function):
    """One layer cycle under ``remat="offload"``: the twin of the JAX
    package's ``save_and_offload_only_these_names(["block_in"])``.  The
    forward sends the cycle's input h to pinned host memory
    (``HostOffload.to_host``, on the copy stream, so the copy overlaps the
    cycle) and runs the cycle without grad and without FPDT offload, keeping
    nothing else.  The backward fetches h, recomputes the cycle with grad
    (FPDT offload on, as a checkpoint's recompute has it) and returns the
    gradients of h and of every parameter leaf.  The leaves are the cycle's
    parameters (views of the stacks from ``unstack``, or
    ``train_loop.value_and_grad``'s one leaf a cycle), so their gradients
    reach ``params["cycles"]`` with the JAX pytree's shapes.  The forward
    returns (h, aux) as ``_cycle`` does, and the backward takes both
    cotangents (aux None for a cycle without MoE).  A non-reentrant
    checkpoint would keep h on the device (its frame holds the inputs),
    which is why this is a Function.  On the CPU ``to_host`` is the
    identity, so only the recompute is exercised there."""

    @staticmethod
    def forward(ctx, cfg, par, pat, c, like, h, *leaves):
        ctx.offload = host_offload(h.device)
        h_host = ctx.offload.to_host(h)
        with no_offload():
            out, aux = _cycle(cfg, par, pat, tree_unflatten(like, list(leaves)), h, c)
        ctx.cfg, ctx.par, ctx.pat, ctx.c, ctx.like = cfg, par, pat, c, like
        ctx.save_for_backward(h_host, *leaves)
        return out, aux

    @staticmethod
    def backward(ctx, dout, daux):
        h_host, *leaves = ctx.saved_tensors
        h = ctx.offload.to_device(h_host).wait().detach().requires_grad_(True)
        ws = [w.detach().requires_grad_(True) for w in leaves]
        with torch.enable_grad():
            out, aux = _cycle(ctx.cfg, ctx.par, ctx.pat, tree_unflatten(ctx.like, ws), h, ctx.c)
        outs, douts = ([out], [dout]) if aux is None else ([out, aux], [dout, daux])
        grads = torch.autograd.grad(outs, [h, *ws], douts)
        return (None, None, None, None, None, *grads)


def hidden_forward(cfg: ModelConfig, par: Optional[ParallelContext], params: Params,
                   h: torch.Tensor):
    """Run the full layer stack. h: [b, S, d].  Returns (h, aux): aux the
    sum of the MoE blocks' load-balancing losses (under a mesh this rank's
    share), zero for a model without MoE."""
    if cfg.remat not in ("none", "full", "offload"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    pat, n_cycles, tail = layout_of(cfg)
    plans = SH.plans_of(cfg, par)
    total = None
    for c, cyc_p in enumerate(cycle_views(cfg, par, params["cycles"], n_cycles)):
        if cfg.remat == "none" or not torch.is_grad_enabled():
            h, aux = _cycle(cfg, par, pat, cyc_p, h, c)
        elif cfg.remat == "full":
            h, aux = checkpoint(_cycle, cfg, par, pat, cyc_p, h, c, use_reentrant=False,
                                preserve_rng_state=False, context_fn=_remat_contexts,
                                determinism_check="none")
        else:
            h, aux = _OffloadedCycle.apply(cfg, par, pat, c, cyc_p, h, *tree_leaves(cyc_p))
        total = _add_aux(total, aux)
    for i, kind in enumerate(tail):
        p = SH.gather_tree(plans and plans["tail"][i], params["tail"][i], par, local_experts=True)
        h, aux = block_apply(cfg, par, kind, p, h)
        total = _add_aux(total, aux)
    if total is None:
        total = torch.zeros((), dtype=torch.float32, device=h.device)
    return h, total


def loss_fn(cfg: ModelConfig, par: Optional[ParallelContext], params: Params,
            batch: Dict[str, torch.Tensor]):
    """Mean next-token xent (labels pre-shifted; IGNORE masked) plus, for an
    MoE model, ``0.01 * aux``.  Returns (total, metrics): ``metrics["loss"]``
    is the cross-entropy alone and ``metrics["aux"]`` the load-balancing
    loss, as the JAX package's metrics hold them.

    Under a mesh ``batch`` holds this rank's rows and tokens
    (``data/pipeline.py::shard_batch``): the total returned is this rank's
    loss sum over the world's token count plus 0.01 times its aux share
    (the all-reduce of a detached value gives the count), so the gradients
    summed over the world (``train_loop``) are exactly those of the global
    total; ``metrics["loss"]`` is the global mean and ``metrics["aux"]`` the
    world's aux, both summed in the same all-reduce."""
    _check_ported(cfg)
    plans = SH.plans_of(cfg, par) or {}
    h = embed_input(cfg, params, batch, par).to(getattr(torch, cfg.param_dtype))
    h, aux = hidden_forward(cfg, par, params, h)
    h = L.apply_norm(cfg, SH.gather_tree(plans.get("final_norm"), params["final_norm"], par), h)
    sp = par.sp if par is not None else 1
    n_chunks = cfg.loss_chunks or auto_chunks(cfg, h.shape[1] * sp, sp)
    labels = batch["labels"]
    if cfg.frontend == "vision_patches":  # no loss on patch positions
        pad = torch.full(batch["patch_embeds"].shape[:2], IGNORE, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    loss_sum, count = softmax_xent_chunked(h, head_matrix(cfg, params, par), labels, n_chunks)
    moe = bool(cfg.num_experts)
    if P.distributed(par):
        sums = [loss_sum.detach(), count] + ([aux.detach()] if moe else [])
        world = P.all_reduce_sum(torch.stack(sums))
        count = world[1]
        loss = loss_sum / torch.clamp(count, min=1.0)
        total = loss + 0.01 * aux if moe else loss
        return total, {"loss": world[0] / torch.clamp(count, min=1.0),
                       "aux": world[2] if moe else aux, "tokens": count}
    loss = loss_sum / torch.clamp(count, min=1.0)
    total = loss + 0.01 * aux if moe else loss
    return total, {"loss": loss, "aux": aux, "tokens": count}
