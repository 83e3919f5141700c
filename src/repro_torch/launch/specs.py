"""Meta-device stand-ins for every model input (the dry-run's currency).

The twin of the JAX package's ``launch/specs.py``, with tensors on the
``meta`` device in place of ``jax.ShapeDtypeStruct``: the same trees, shapes
and dtypes, and no memory allocated.  ``input_specs(cfg, shape)`` returns
the input tree each step kind consumes:

  train   -> {"batch": {"tokens"/"frame_embeds"/"patch_embeds", "labels"}}
  prefill -> the same minus labels
  decode  -> {"cache", "inp", "pos"}: one new token against a seq_len KV cache
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import ModelConfig, ShapeConfig
from repro_torch.models import serve as SV
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

META = "meta"


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _fwd_batch_specs(cfg: ModelConfig, B: int, S: int, with_labels: bool) -> Dict[str, Any]:
    emb_dt = getattr(torch, cfg.param_dtype)
    out: Dict[str, Any] = {}
    if cfg.frontend == "audio_frames":
        out["frame_embeds"] = _meta((B, S, cfg.d_model), emb_dt)
    elif cfg.frontend == "vision_patches":
        out["patch_embeds"] = _meta((B, cfg.num_patches, cfg.d_model), emb_dt)
        out["tokens"] = _meta((B, S - cfg.num_patches), torch.int32)
    else:
        out["tokens"] = _meta((B, S), torch.int32)
    if with_labels:
        ls = S if cfg.frontend != "vision_patches" else S - cfg.num_patches
        out["labels"] = _meta((B, ls), torch.int32)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Returns (kind, specs), specs the step's input tree on the meta device."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return "train", {"batch": _fwd_batch_specs(cfg, B, S, with_labels=True)}
    if shape.kind == "prefill":
        return "prefill", {"batch": _fwd_batch_specs(cfg, B, S, with_labels=False)}
    cache = SV.init_cache(cfg, B, S, META)
    if cfg.frontend == "audio_frames":
        inp = {"frame_embeds": _meta((B, 1, cfg.d_model), getattr(torch, cfg.param_dtype))}
    else:
        inp = {"tokens": _meta((B, 1), torch.int32)}
    return "decode", {"cache": cache, "inp": inp, "pos": _meta((), torch.int32)}


def params_spec(cfg: ModelConfig):
    """The parameter tree on the meta device."""
    return T.init_params(cfg, torch.Generator(), META)


def opt_spec(cfg: ModelConfig, oc, params_shape):
    """The AdamW state of ``params_shape`` on the meta device."""
    return adamw.init(oc, params_shape)
