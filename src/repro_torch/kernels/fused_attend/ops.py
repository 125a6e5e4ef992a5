"""Drop-in decode attention over the paged compressed KV pool: one fused
kernel call per layer, tail merged and output normalized inside it."""
from __future__ import annotations

import torch

from repro_torch.core.kv_cache import as_pos_vec
from repro_torch.kernels.fused_attend import kernel


def attend_with_tail(q: torch.Tensor, layer_cache: dict, pos, *,
                     block_table: torch.Tensor) -> torch.Tensor:
    """Kernel-backed equivalent of `core.kv_cache.attend_compressed` with a
    block table: q (B, 1, H, hd) -> (B, 1, H, hd) in q's dtype.

    The table may be a decode-bucket slice of the full table.
    """
    b, _, h, hd = q.shape
    hkv = layer_cache["packed_k"].shape[1]
    pos = as_pos_vec(pos, b, q.device)
    qg = q[:, 0].reshape(b, hkv, h // hkv, hd)
    out = kernel.attend_paged(layer_cache["packed_k"], layer_cache["scale_k"],
                              layer_cache["packed_v"], layer_cache["scale_v"],
                              qg.contiguous(), pos, block_table,
                              layer_cache["tail_k"], layer_cache["tail_v"])
    return out.reshape(b, 1, h, hd).to(q.dtype)
