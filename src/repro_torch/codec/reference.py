"""Plain PyTorch truncated codec on 2-D planes (the kernels' oracle).

Plane protocol, as in the JAX package's `reference` backend (R % 8 == 0,
C % 8 == 0; leading dims are folded away by `codec.api`):

  compress_plane(x, keep)           -> (q (R/8, C/8, k, k) int8,
                                        scale (R/8, C/8) f32)
  decompress_plane(q, scale, dtype) -> (R, C)
"""
from __future__ import annotations

import torch

from repro_torch.core import dct as dct_lib


def compress_plane(x: torch.Tensor, keep: int):
    ck = dct_lib.dct_rows(keep, x.device)
    blocks = dct_lib._blockize(x.float())
    z = torch.einsum("ua,...ab,vb->...uv", ck, blocks, ck)  # DCT + truncate
    amax = z.abs().amax(dim=(-1, -2), keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    # torch.round is round-half-to-even, like jnp.round
    q = torch.clamp(torch.round(z / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0, 0]


def decompress_plane(q: torch.Tensor, scale: torch.Tensor,
                     out_dtype=torch.float32) -> torch.Tensor:
    ck = dct_lib.dct_rows(q.shape[-1], q.device)
    z = q.float() * scale[..., None, None]
    t = torch.einsum("ua,...uv,vb->...ab", ck, z, ck)  # zero-pad + IDCT
    return dct_lib._unblockize(t).to(out_dtype)
