"""Container-free truncated codec over (..., R, C) tensors.

`compress_blocks` folds every leading dim into the row axis (exact for 8x8
tiling: no block straddles a fold boundary) and hands ONE 2-D plane to the
`fused_compress` kernel wrapper, which launches the Hopper kernel for a CUDA
tensor and runs the plain version for a CPU tensor.  `decompress_blocks` is
plain PyTorch on every device in this slice (its kernel, the JAX package's
`decompress_plane_pallas`, is still to be ported).
"""
from __future__ import annotations

import torch

from repro_torch.codec import reference
from repro_torch.kernels.fused_compress import kernel as fc_kernel

BLOCK = 8

# Per-tile storage header: the f32 scale is the only header the truncated
# scheme stores.  Every byte report (plan, pool, kv_pool_stats) derives from
# `tile_bytes`, as in the JAX package.
TILE_HEADER_BYTES = 4


def tile_bytes(keep: int) -> int:
    """Compressed bytes of one 8x8 tile: int8 k x k corner + f32 scale."""
    return keep * keep + TILE_HEADER_BYTES


def compress_blocks(x: torch.Tensor, keep: int):
    """(..., R, C) with R % 8 == C % 8 == 0 -> fused DCT+truncate+int8.

    Returns (coefs (..., R/8, C/8, k, k) int8, scale (..., R/8, C/8) f32).
    """
    *lead, r, c = x.shape
    if r % BLOCK or c % BLOCK:
        raise ValueError(f"plane dims must be multiples of {BLOCK}, got {(r, c)}")
    q, scale = fc_kernel.compress_plane(x.reshape(-1, c).contiguous(), keep)
    nh, nw = r // BLOCK, c // BLOCK
    return (q.reshape(*lead, nh, nw, keep, keep),
            scale.reshape(*lead, nh, nw))


def decompress_blocks(q: torch.Tensor, scale: torch.Tensor,
                      out_dtype=torch.float32) -> torch.Tensor:
    """Inverse of `compress_blocks` -> (..., R, C)."""
    *lead, nh, nw, k, _ = q.shape
    out = reference.decompress_plane(q.reshape(-1, nw, k, k),
                                     scale.reshape(-1, nw), out_dtype=out_dtype)
    return out.reshape(*lead, nh * BLOCK, nw * BLOCK)
