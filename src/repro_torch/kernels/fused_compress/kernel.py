"""Wrapper for the fused DCT + truncate + int8 compress kernel.

`compress_plane(x, keep)` takes an (R, C) plane (R, C multiples of 8) and
returns the blocks layout: q (R/8, C/8, k, k) int8 and scale (R/8, C/8) f32.
A CUDA tensor launches `csrc/fused_compress.cu` (f32 and bf16 are read
directly, no cast pass); a CPU tensor runs the plain version in `ref.py`.
`counter` counts kernel launches only.
"""
from __future__ import annotations

import torch

from repro_torch.codec import dispatch
from repro_torch.kernels import build
from repro_torch.kernels.fused_compress import ref

BLOCK = 8
counter = build.LaunchCounter("fused_compress")


def compress_plane(x: torch.Tensor, keep: int):
    if not dispatch.on_kernel(x):
        return ref.compress_plane(x, keep)
    if x.ndim != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_compress takes a 2-D f32/bf16 plane, got "
                         f"{tuple(x.shape)} {x.dtype}")
    r, c = x.shape
    if r % BLOCK or c % BLOCK or r == 0 or c == 0:
        raise ValueError(f"plane dims must be positive multiples of {BLOCK}, got {(r, c)}")
    if not 1 <= keep <= BLOCK:
        raise ValueError(f"keep must be in [1, {BLOCK}], got {keep}")
    if not x.is_contiguous():
        raise ValueError("fused_compress needs a contiguous plane")
    fn = build.library().fn("fc_compress_plane", x.device)
    q = torch.empty((r // BLOCK, c // BLOCK, keep, keep), dtype=torch.int8,
                    device=x.device)
    scale = torch.empty((r // BLOCK, c // BLOCK), dtype=torch.float32,
                        device=x.device)
    err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), r, c, keep,
             q.data_ptr(), scale.data_ptr(), build.stream_of(x.device))
    build.check(err, "fused_compress")
    counter.bump()
    return q, scale
