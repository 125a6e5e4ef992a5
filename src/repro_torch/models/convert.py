"""Carry a JAX parameter tree across to the port.

The JAX package's caller flattens its tree to numpy first
(``jax.tree.map(np.asarray, params)``); this module never imports JAX.
Layouts are shared, so the conversion is a leaf-by-leaf copy with the
stacked layer axis intact.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: no torch view
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device="cpu", dtype=None):
    """Nested dict of numpy arrays -> the same dict of tensors on `device`
    (floating leaves cast to `dtype` when given)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    return _leaf(tree, device, dtype)
