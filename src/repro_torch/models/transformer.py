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
token frontend.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig
from repro_torch.core import fpdt
from repro_torch.core import parallel as P
from repro_torch.core.chunked_loss import auto_chunks, softmax_xent_chunked
from repro_torch.core.parallel import ParallelContext
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
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
    if cfg.num_experts:
        raise NotImplementedError(f"{cfg.name}: MoE blocks are not yet ported")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} frontend is not yet ported")


def _init_block(cfg: ModelConfig, kind: str, gen: torch.Generator, dtype, device) -> Params:
    """A block of ``kind``: attention (attn and local_attn have the same
    parameters) or rglru, each with its MLP, or ssm (a norm and the Mamba
    mixer, no MLP)."""
    if kind == "ssm":
        return {"norm": L.init_norm(cfg, dtype, device),
                "mixer": M.init_mamba(cfg, gen, dtype, device)}
    if kind == "rglru":
        mixer = {"mixer": R.init_rglru(cfg, gen, dtype, device)}
    else:
        mixer = {"attn": L.init_attn(cfg, gen, dtype, device)}
    return {
        "norm1": L.init_norm(cfg, dtype, device),
        **mixer,
        "norm2": L.init_norm(cfg, dtype, device),
        "mlp": L.init_mlp(cfg, gen, dtype, device),
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


def init_params(cfg: ModelConfig, gen: torch.Generator, device="cuda") -> Params:
    """Random parameters from ``gen`` (a generator on ``device``), in the
    JAX package's pytree layout and initialisation scales."""
    _check_ported(cfg)
    dtype = getattr(torch, cfg.param_dtype)
    pat, n_cycles, tail = layout_of(cfg)
    params: Params = {
        "embed": (0.02 * torch.randn((cfg.padded_vocab, cfg.d_model), generator=gen,
                                     device=device)).to(dtype),
    }
    params["cycles"] = _stack([
        {f"pos{i}": _init_block(cfg, kind, gen, dtype, device) for i, kind in enumerate(pat)}
        for _ in range(n_cycles)
    ])
    if tail:
        params["tail"] = [_init_block(cfg, kind, gen, dtype, device) for kind in tail]
    params["final_norm"] = L.init_norm(cfg, dtype, device)
    if not cfg.tie_embeddings:
        params["head"] = L._dense_init(gen, (cfg.d_model, cfg.padded_vocab), dtype, device)
    return params


def head_matrix(cfg: ModelConfig, params: Params) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["head"]


def embed_input(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]):
    """Token embeddings of ``batch["tokens"] [b, s]``."""
    if cfg.frontend != "none":
        raise NotImplementedError(f"the {cfg.frontend} frontend is not yet ported")
    return params["embed"][batch["tokens"]]


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------


def attn_kind(cfg: ModelConfig, par: Optional[ParallelContext]) -> str:
    if par is None or par.mesh is None:
        return "local"
    if cfg.attn_impl in ("ulysses", "cp"):
        return cfg.attn_impl
    return "ulysses" if cfg.num_heads % par.sp == 0 else "cp"


def block_apply(cfg: ModelConfig, par: Optional[ParallelContext], kind: str,
                p: Params, h: torch.Tensor) -> torch.Tensor:
    """One block: norm1 -> mixer (FPDT attention or RG-LRU) -> residual ->
    norm2 -> chunked MLP -> residual; an ssm block is norm -> Mamba mixer ->
    residual.  Under a mesh h holds this rank's tokens (``core/parallel.py``);
    everything but attention is per token."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"{kind!r} blocks are not yet ported")
    n_shards = par.sp if par is not None else 1
    if kind == "ssm":
        y, _ = M.mamba_mixer(cfg, p["mixer"], L.apply_norm(cfg, p["norm"], h),
                             n_shards=n_shards)
        return h + y
    hn = L.apply_norm(cfg, p["norm1"], h)
    if kind == "rglru":
        y, _ = R.rglru_mixer(cfg, p["mixer"], hn, n_shards=n_shards)
        h = h + y
    else:
        window = cfg.window if kind == "local_attn" else 0
        o = fpdt.fpdt_attention(cfg, par, p["attn"], hn, kind=attn_kind(cfg, par), window=window)
        h = h + o @ p["attn"]["wo"]
    hn2 = L.apply_norm(cfg, p["norm2"], h)
    return h + L.mlp_chunked(cfg, p["mlp"], hn2, cfg.mlp_chunks)


def _cycle(cfg, par, pat, cyc_p, h):
    for i, kind in enumerate(pat):
        h = block_apply(cfg, par, kind, cyc_p[f"pos{i}"], h)
    return h


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
    reach ``params["cycles"]`` with the JAX pytree's shapes.  A non-reentrant
    checkpoint would keep h on the device (its frame holds the inputs),
    which is why this is a Function.  On the CPU ``to_host`` is the
    identity, so only the recompute is exercised there."""

    @staticmethod
    def forward(ctx, cfg, par, pat, like, h, *leaves):
        ctx.offload = host_offload(h.device)
        h_host = ctx.offload.to_host(h)
        with no_offload():
            out = _cycle(cfg, par, pat, tree_unflatten(like, list(leaves)), h)
        ctx.cfg, ctx.par, ctx.pat, ctx.like = cfg, par, pat, like
        ctx.save_for_backward(h_host, *leaves)
        return out

    @staticmethod
    def backward(ctx, dout):
        h_host, *leaves = ctx.saved_tensors
        h = ctx.offload.to_device(h_host).wait().detach().requires_grad_(True)
        ws = [w.detach().requires_grad_(True) for w in leaves]
        with torch.enable_grad():
            out = _cycle(ctx.cfg, ctx.par, ctx.pat, tree_unflatten(ctx.like, ws), h)
        grads = torch.autograd.grad(out, [h, *ws], dout)
        return (None, None, None, None, *grads)


def hidden_forward(cfg: ModelConfig, par: Optional[ParallelContext], params: Params,
                   h: torch.Tensor):
    """Run the full layer stack. h: [b, S, d].  Returns (h, aux); aux is the
    MoE load-balancing loss in the JAX package, and no ported block has one."""
    if cfg.remat not in ("none", "full", "offload"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    pat, n_cycles, tail = layout_of(cfg)
    for cyc_p in unstack(params["cycles"], n_cycles):
        if cfg.remat == "none" or not torch.is_grad_enabled():
            h = _cycle(cfg, par, pat, cyc_p, h)
        elif cfg.remat == "full":
            h = checkpoint(_cycle, cfg, par, pat, cyc_p, h, use_reentrant=False,
                           preserve_rng_state=False, context_fn=_remat_contexts,
                           determinism_check="none")
        else:
            h = _OffloadedCycle.apply(cfg, par, pat, cyc_p, h, *tree_leaves(cyc_p))
    for i, kind in enumerate(tail):
        h = block_apply(cfg, par, kind, params["tail"][i], h)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def loss_fn(cfg: ModelConfig, par: Optional[ParallelContext], params: Params,
            batch: Dict[str, torch.Tensor]):
    """Mean next-token xent (labels pre-shifted; IGNORE masked).  Returns
    (loss, metrics).

    Under a mesh ``batch`` holds this rank's rows and tokens
    (``data/pipeline.py::shard_batch``): the loss returned is this rank's
    sum over the world's token count (an all-reduce of a detached value),
    so the gradients summed over the world (``train_loop``) are exactly
    those of the global mean; ``metrics["loss"]`` is the global mean."""
    _check_ported(cfg)
    h = embed_input(cfg, params, batch).to(getattr(torch, cfg.param_dtype))
    h, aux = hidden_forward(cfg, par, params, h)
    h = L.apply_norm(cfg, params["final_norm"], h)
    sp = par.sp if par is not None else 1
    n_chunks = cfg.loss_chunks or auto_chunks(cfg, h.shape[1] * sp, sp)
    loss_sum, count = softmax_xent_chunked(h, head_matrix(cfg, params), batch["labels"],
                                           n_chunks)
    if P.distributed(par):
        world = P.all_reduce_sum(torch.stack([loss_sum.detach(), count]))
        count = world[1]
        loss = loss_sum / torch.clamp(count, min=1.0)
        return loss, {"loss": world[0] / torch.clamp(count, min=1.0), "aux": aux,
                      "tokens": count}
    loss = loss_sum / torch.clamp(count, min=1.0)
    return loss, {"loss": loss, "aux": aux, "tokens": count}
