"""Plain PyTorch version of the paged fused-attend kernel: gather each
slot's pages through the block table, decompress, masked online softmax over
the flushed history, merge the raw tail, normalize — the same scan
`core.kv_cache.attend_compressed` runs, returned in the kernel's
(B, Hkv, n_rep, hd) f32 layout."""
from __future__ import annotations

import torch

from repro_torch.core import kv_cache as kvc


def attend_paged(packed_k, scale_k, packed_v, scale_v, q, pos, block_table,
                 tail_k, tail_v) -> torch.Tensor:
    b, hkv, n_rep, hd = q.shape
    layer_cache = dict(packed_k=packed_k, scale_k=scale_k, packed_v=packed_v,
                       scale_v=scale_v, tail_k=tail_k, tail_v=tail_v)
    out = kvc.attend_scan(q.reshape(b, 1, hkv * n_rep, hd), layer_cache, pos,
                          packed_k.shape[-1], block_table=block_table)
    return out.reshape(b, hkv, n_rep, hd)
