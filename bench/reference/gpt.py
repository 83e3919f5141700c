"""Plain reference of the paper's GPT (the configuration's ``family``
"dense" with layernorm and gelu): pre-norm blocks of multi-head causal
attention with rotary embedding and a two-matrix gelu MLP, a final
layernorm, an untied output head, mean next-token cross-entropy.

Departure from GPT-3, as the configuration states it: rotary embedding of
q and k (theta ``rope_theta``) in place of learned positions, no biases on
the projections, the tanh form of gelu.  Parameters are a dict of fp32
tensors named as ``bench/weights.py::flat`` names them; each layer is
recomputed in the backward (``checkpoint``), attention in blocks of rows.
"""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

from bench.reference import common as C


def _layer(m: dict, prec: C.Prec, x, ln1w, ln1b, wq, wk, wv, wo, ln2w, ln2b, wu, wd):
    b, s, d = x.shape
    hq, dh = m["num_heads"], m["head_dim"]
    hn = C.layernorm(x, ln1w, ln1b)
    q = C.rope(prec.mm(hn, wq).reshape(b, s, hq, dh), m["rope_theta"])
    k = C.rope(prec.mm(hn, wk).reshape(b, s, hq, dh), m["rope_theta"])
    v = prec.mm(hn, wv).reshape(b, s, hq, dh)
    o = C.CausalAttention.apply(*(t.transpose(1, 2).contiguous() for t in (q, k, v)), prec)
    x = x + prec.mm(o.transpose(1, 2).reshape(b, s, hq * dh), wo)
    hn = C.layernorm(x, ln2w, ln2b)
    return x + prec.mm(C.gelu_tanh(prec.mm(hn, wu)), wd)


NAMES = ("norm1.w", "norm1.b", "attn.wq", "attn.wk", "attn.wv", "attn.wo", "norm2.w",
         "norm2.b", "mlp.wu", "mlp.wd")


def loss(m: dict, params: dict, batch: dict, prec: C.Prec):
    """Mean cross-entropy of ``batch`` {"tokens", "labels"} [b, s]."""
    if m["num_kv_heads"] != m["num_heads"] or m.get("qkv_bias") or m["mlp_act"] != "gelu":
        raise NotImplementedError("the GPT reference is multi-head, bias-free, gelu")
    x = params["embed"][batch["tokens"].long()]
    for c in range(m["num_layers"]):
        ws = [params[f"cycles.{c}.pos0.{n}"] for n in NAMES]
        x = checkpoint(_layer, m, prec, x, *ws, use_reentrant=False)
    h = C.layernorm(x, params["final_norm.w"], params["final_norm.b"])
    return C.mean_nll(h.reshape(-1, h.shape[-1]), params["head"],
                      batch["labels"].reshape(-1).long(), prec)
