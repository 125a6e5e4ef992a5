"""Wrapper for the fused decompress + decode-attention kernel over the paged
compressed KV pool.

`attend_paged` takes one layer's pool planes, the (B, Hkv, n_rep, hd) query
groups, per-slot positions, the block table (possibly a decode-bucket
slice) and the raw tail ring, and returns the NORMALIZED attention output
(B, Hkv, n_rep, hd) f32 with the tail merged in.  A CUDA tensor launches
`csrc/fused_attend_paged.cu`; a CPU tensor runs the plain version in
`ref.py`.  `counter` counts kernel launches only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.codec import dispatch
from repro_torch.kernels import build
from repro_torch.kernels.fused_attend import ref

BLOCK = 8
counter = build.LaunchCounter("fused_attend_paged")
_FLOAT = (torch.float32, torch.bfloat16)


def attend_paged(packed_k, scale_k, packed_v, scale_v, q, pos, block_table,
                 tail_k, tail_v) -> torch.Tensor:
    if not dispatch.on_kernel(q):
        return ref.attend_paged(packed_k, scale_k, packed_v, scale_v, q, pos,
                                block_table, tail_k, tail_v)
    n_pages, hkv, nh, keep, _ = packed_k.shape
    b, hkv_q, n_rep, hd = q.shape
    nblocks = block_table.shape[1]
    if hkv_q != hkv or nh * BLOCK != hd:
        raise ValueError(f"q {tuple(q.shape)} does not match the pool "
                         f"{tuple(packed_k.shape)}")
    if packed_k.dtype != torch.int8 or packed_v.dtype != torch.int8 \
            or scale_k.dtype != torch.float32 or scale_v.dtype != torch.float32:
        raise ValueError("pool planes must be int8 corners and f32 scales")
    if q.dtype not in _FLOAT or tail_k.dtype not in _FLOAT \
            or tail_v.dtype != tail_k.dtype:
        raise ValueError(f"q/tails must be f32 or bf16, got {q.dtype}, "
                         f"{tail_k.dtype}, {tail_v.dtype}")
    if tuple(tail_k.shape) != (b, BLOCK, hkv, hd) or tail_v.shape != tail_k.shape:
        raise ValueError(f"tails {tuple(tail_k.shape)} != {(b, BLOCK, hkv, hd)}")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (b,) \
            or block_table.dtype != torch.int32 or block_table.shape[0] != b:
        raise ValueError("pos must be (B,) int32 and the block table (B, n) int32")
    if block_table.stride(1) != 1:
        raise ValueError("block table rows must be contiguous")
    tensors = (packed_k, scale_k, packed_v, scale_v, q, pos, block_table,
               tail_k, tail_v)
    if any(t.device != q.device for t in tensors):
        raise ValueError("attend_paged operands must share one device")
    if not all(t.is_contiguous() for t in tensors if t is not block_table):
        raise ValueError("attend_paged operands must be contiguous")
    fn = build.library().fn("fa_attend_paged", q.device)
    out = torch.empty((b, hkv, n_rep, hd), dtype=torch.float32, device=q.device)
    err = fn(packed_k.data_ptr(), scale_k.data_ptr(), packed_v.data_ptr(),
             scale_v.data_ptr(), q.data_ptr(), int(q.dtype == torch.bfloat16),
             pos.data_ptr(), block_table.data_ptr(), block_table.stride(0),
             nblocks, tail_k.data_ptr(), tail_v.data_ptr(),
             int(tail_k.dtype == torch.bfloat16), out.data_ptr(), b, n_pages,
             hkv, n_rep, hd, keep, float(1.0 / np.sqrt(hd)),
             build.stream_of(q.device))
    build.check(err, "fused_attend_paged")
    counter.bump()
    return out
