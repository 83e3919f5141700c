"""Parameters of the JAX package, as numpy, into the port's tensors.

The JAX package and the port keep the same parameter pytree (nested dicts,
a ``tail`` list, leaves in the same layouts), so conversion is leaf by
leaf.  The caller fetches the JAX parameters to the host itself
(``jax.device_get``) and passes numpy in; this module never imports JAX.
bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which numpy cannot
hand to torch directly, so they cross as their 16-bit patterns.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _leaf(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def from_jax_params(params_numpy: Any, device) -> Any:
    """Map a JAX parameter pytree of numpy arrays (dicts, lists, tuples) to
    the same tree of torch tensors on ``device``, dtypes kept."""
    if isinstance(params_numpy, dict):
        return {k: from_jax_params(v, device) for k, v in params_numpy.items()}
    if isinstance(params_numpy, (list, tuple)):
        return [from_jax_params(v, device) for v in params_numpy]
    return _leaf(np.asarray(params_numpy), device)
