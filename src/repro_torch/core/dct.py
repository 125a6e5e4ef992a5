"""Orthonormal 8x8 DCT-II matrix and the 8x8 tiling helpers.

The matrix uses the same float64 formula as the JAX package (C[k, i] =
s_k cos(pi (i + 1/2) k / n), first row scaled by 1/sqrt(2)), cast to f32
where it meets tensors, so both ports quantize against bit-identical
constants.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

BLOCK = 8


@functools.lru_cache(maxsize=None)
def _dct_matrix_np(n: int = BLOCK) -> np.ndarray:
    """Orthonormal DCT-II matrix C with C[k, i] = s_k cos(pi (i + 1/2) k / n)."""
    k = np.arange(n)[:, None].astype(np.float64)
    i = np.arange(n)[None, :].astype(np.float64)
    c = np.cos(np.pi * (i + 0.5) * k / n)
    c *= np.sqrt(2.0 / n)
    c[0] *= 1.0 / np.sqrt(2.0)
    return c


@functools.lru_cache(maxsize=None)
def dct_rows(keep: int, device=None) -> torch.Tensor:
    """(keep, 8) top rows of the f32 DCT matrix: fused DCT + truncate.
    Cached per device, so the plain codec uploads it once."""
    c = _dct_matrix_np(BLOCK).astype(np.float32)[:keep]
    return torch.from_numpy(np.ascontiguousarray(c)).to(device)


def _blockize(x: torch.Tensor, block: int = BLOCK) -> torch.Tensor:
    """(..., H, W) -> (..., H/b, W/b, b, b)."""
    *lead, h, w = x.shape
    x = x.reshape(*lead, h // block, block, w // block, block)
    return x.movedim(-3, -2)


def _unblockize(x: torch.Tensor) -> torch.Tensor:
    """(..., H/b, W/b, b, b) -> (..., H, W)."""
    *lead, nh, nw, b, b2 = x.shape
    return x.movedim(-2, -3).reshape(*lead, nh * b, nw * b2)
