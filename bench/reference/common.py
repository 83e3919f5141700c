"""What the plain references share: matrix products at a stated precision,
norms, rotary embedding, causal attention in blocks, the linear scan, the
loss in blocks of tokens, and AdamW with its schedule.

Plain PyTorch in fp32 (TF32 off: ``fp32_strict``), written from the
published descriptions and the configuration files, importing nothing of
the program.  ``Prec("fp8")`` is the control: every matrix product's
operands rounded to fp8 with one scale a tensor (e4m3 forward, e5m2 for
the gradients, the usual fp8 training recipe), the rest still fp32.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List

import torch
from torch.utils.checkpoint import checkpoint

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2


@contextlib.contextmanager
def fp32_strict():
    """fp32 products in fp32: TF32 off for matmuls and convolutions."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8(x: torch.Tensor, fmt) -> torch.Tensor:
    """``x`` rounded to fp8 ``fmt`` under one scale that maps its largest
    magnitude to the format's largest value, back in fp32."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, torch.finfo(fmt).max / amax, torch.ones_like(amax))
    return ((x * scale).to(fmt).float() / scale).to(x.dtype)


class Prec:
    """How products are computed: "fp32" (the reference) or "fp8" (the
    control)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}: fp32 or fp8")
        self.name = name

    def fwd(self, x):
        return fp8(x, E4M3) if self.name == "fp8" else x

    def bwd(self, x):
        return fp8(x, E5M2) if self.name == "fp8" else x

    def mm(self, a, b):
        return a @ b if self.name == "fp32" else _Fp8Matmul.apply(a, b)


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8(a, E4M3), fp8(b, E4M3)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8(g, E5M2)
        ga = qg @ qb.transpose(-1, -2)
        gb = (qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])).reshape(qb.shape)
        return ga, gb


def layernorm(x, w, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def rmsnorm(x, w, eps=1e-6):
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """x [b, s, h, d] at positions 0 .. s-1: the two halves of each head
    rotated by position * theta^(-2i/d)."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def gelu_tanh(x):
    return 0.5 * x * (1 + torch.tanh(math.sqrt(2 / math.pi) * (x + 0.044715 * x ** 3)))


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def silu(x):
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# causal attention, in blocks of query rows
# ---------------------------------------------------------------------------


SCORES_PER_BLOCK = 1 << 29  # fp32 scores of one block of query rows (2 GiB)


def _q_block(b, h, s) -> int:
    """Query rows a block, so that one block's scores stay near
    SCORES_PER_BLOCK."""
    rows = max(1, SCORES_PER_BLOCK // max(1, b * h * s))
    return max(16, 1 << (rows.bit_length() - 1))


class CausalAttention(torch.autograd.Function):
    """softmax(q k^T / sqrt(d), causal) v over [b, h, s, d], a block of
    query rows at a time against every key it sees; the backward
    recomputes each block's probabilities from the saved log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, prec: Prec):
        b, h, s, d = q.shape
        scale = 1.0 / math.sqrt(d)
        bq = _q_block(b, h, s)
        o = torch.empty_like(q)
        lse = torch.empty((b, h, s), dtype=q.dtype, device=q.device)
        kq, vq = prec.fwd(k), prec.fwd(v)
        for i0 in range(0, s, bq):
            i1 = min(s, i0 + bq)
            p = prec.fwd(q[:, :, i0:i1] * scale) @ kq[:, :, :i1].transpose(-1, -2)
            _mask_diagonal(p, i0, i1)
            m = p.amax(-1, keepdim=True)
            p.sub_(m).exp_()
            l = p.sum(-1, keepdim=True)
            o[:, :, i0:i1] = (prec.fwd(p) @ vq[:, :, :i1]) / l
            lse[:, :, i0:i1] = (m + torch.log(l))[..., 0]
            del p
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.prec = prec
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        prec = ctx.prec
        b, h, s, d = q.shape
        scale = 1.0 / math.sqrt(d)
        bq = _q_block(b, h, s)
        delta = (do * o).sum(-1, keepdim=True)
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        kq, vq = prec.fwd(k), prec.fwd(v)
        for i0 in range(0, s, bq):
            i1 = min(s, i0 + bq)
            qb, dob = prec.fwd(q[:, :, i0:i1] * scale), prec.bwd(do[:, :, i0:i1])
            p = qb @ kq[:, :, :i1].transpose(-1, -2)
            _mask_diagonal(p, i0, i1)
            p.sub_(lse[:, :, i0:i1, None]).exp_()
            ds = dob @ vq[:, :, :i1].transpose(-1, -2)
            ds.sub_(delta[:, :, i0:i1]).mul_(p)
            dv[:, :, :i1] += prec.fwd(p).transpose(-1, -2) @ dob
            del p
            ds = prec.bwd(ds)
            dq[:, :, i0:i1] = (ds @ kq[:, :, :i1]) * scale
            dk[:, :, :i1] += ds.transpose(-1, -2) @ qb
            del ds
        return dq, dk, dv, None


def _mask_diagonal(scores, i0: int, i1: int) -> None:
    """-inf where key j > query i, in the block of rows [i0, i1) whose keys
    are [0, i1): only the last i1 - i0 columns can hold such keys."""
    rows = torch.arange(i0, i1, device=scores.device)[:, None]
    cols = torch.arange(i0, i1, device=scores.device)[None, :]
    scores[..., i0:i1].masked_fill_(cols > rows, float("-inf"))


# ---------------------------------------------------------------------------
# the linear scan h_t = a_t h_{t-1} + b_t, in blocks of tokens
# ---------------------------------------------------------------------------


class LinearScan(torch.autograd.Function):
    """Every state of h_t = a_t h_{t-1} + b_t (a, b [n, L, ...], h0 [n,
    ...]), one step at a time; the backward runs the adjoint recurrence
    g_t = dh_t + a_{t+1} g_{t+1} from the last step, then da_t = g_t
    h_{t-1}, db_t = g_t, dh0 = a_0 g_0."""

    @staticmethod
    def forward(ctx, a, b, h0):
        hs = torch.empty_like(b)
        h = h0
        for t in range(a.shape[1]):
            h = torch.addcmul(b[:, t], a[:, t], h, out=hs[:, t])
        ctx.save_for_backward(a, hs, h0)
        return hs

    @staticmethod
    def backward(ctx, dh):
        a, hs, h0 = ctx.saved_tensors
        g = torch.empty_like(dh)
        acc = dh[:, -1].clone()
        g[:, -1] = acc
        for t in range(a.shape[1] - 2, -1, -1):
            acc = torch.addcmul(dh[:, t], a[:, t + 1], acc, out=g[:, t])
        prev = torch.cat([h0[:, None], hs[:, :-1]], 1)
        return g * prev, g, a[:, 0] * g[:, 0]


# ---------------------------------------------------------------------------
# loss, in blocks of tokens
# ---------------------------------------------------------------------------


def _nll_sum(h, head, labels, prec: Prec):
    logits = prec.mm(h, head)
    return (torch.logsumexp(logits, -1) - logits.gather(-1, labels[..., None])[..., 0]).sum()


def mean_nll(h, head, labels, prec: Prec, block: int = 4096):
    """Mean next-token cross-entropy of h [n, d] against labels [n] over
    the whole (padded) vocabulary of head [d, V]; each block of tokens'
    logits recomputed in the backward."""
    total = h.new_zeros(())
    for i in range(0, h.shape[0], block):
        total = total + checkpoint(_nll_sum, h[i:i + block], head, labels[i:i + block], prec,
                                   use_reentrant=False)
    return total / h.shape[0]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up over ``warmup_steps``, then a cosine to
    ``min_lr_frac`` of ``lr`` at ``total_steps``."""
    warm = opt["warmup_steps"]
    if step < warm:
        return opt["lr"] * step / max(1, warm)
    prog = min(1.0, max(0.0, (step - warm) / max(1, opt["total_steps"] - warm)))
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * frac


class AdamW:
    """AdamW over a dict of fp32 parameters: the gradients clipped to a
    global norm of ``clip_norm``, bias-corrected moments, decoupled weight
    decay on every parameter.  After each update a parameter is rounded to
    the dtype it is stored in (``dtypes``, the configuration's), as stored
    weights are; the arithmetic is fp32."""

    def __init__(self, opt: dict, params: Dict[str, torch.Tensor], dtypes: Dict[str, torch.dtype]):
        self.opt, self.dtypes, self.step = opt, dtypes, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def update(self, params, grads) -> Dict[str, torch.Tensor]:
        """Updates ``params`` in place; returns the clipped gradients."""
        o = self.opt
        self.step += 1
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = float(min(1.0, o["clip_norm"] / (float(norm) + 1e-9)))
        lr = lr_at(o, self.step)
        c1, c2 = 1 - o["b1"] ** self.step, 1 - o["b2"] ** self.step
        seen = {}
        for k, p in params.items():
            g = grads[k] * scale
            seen[k] = g
            self.m[k].mul_(o["b1"]).add_((1 - o["b1"]) * g)
            self.v[k].mul_(o["b2"]).add_((1 - o["b2"]) * g * g)
            step = (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + o["eps"])
            p.copy_((p - lr * (step + o["weight_decay"] * p)).to(self.dtypes[k]).float())
        return seen


def follow(loss_fn: Callable, params: Dict[str, torch.Tensor], dtypes, opt: dict,
           batches: List[dict]) -> dict:
    """The reference's steps: for each batch the loss and its gradients
    (``loss_fn(params, batch)``), then an AdamW update.  Returns the losses,
    each leaf's first gradient norm as the update took it, and each leaf's
    change over the steps."""
    start = {k: p.detach().clone() for k, p in params.items()}
    adam = AdamW(opt, params, dtypes)
    losses, first = [], None
    for batch in batches:
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        seen = adam.update(params, dict(zip(leaves, grads)))
        if first is None:
            first = {k: float(g.norm()) for k, g in seen.items()}
        del leaves, grads, seen, loss
    change = {k: float((params[k] - start[k]).norm()) for k in params}
    return {"losses": losses, "grad": first, "change": change}
