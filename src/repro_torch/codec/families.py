"""Codec families: the declared plane tree behind the compressed KV pool.

This slice ports the `dct` family only — int8 k x k corner + f32 scale per
8x8 tile, with identity pack/unpack.  `bitplane` and `asc` raise
NotImplementedError until their slice; any other name is unknown.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.codec import api as codec_api

BLOCK = 8
SCALE_HEADER_BYTES = codec_api.TILE_HEADER_BYTES
DEFAULT_FAMILY = "dct"
TAIL_NAMES = ("tail_k", "tail_v")  # raw per-slot scratchpad, outside families
_LATER = ("bitplane", "asc")


@dataclass(frozen=True)
class PlaneSpec:
    """One declared plane: cache tensors are ``prefix + block_shape``, with
    prefix ``(Lseg, P, Hkv)`` in the paged pool."""

    name: str
    dtype: torch.dtype
    block_shape: tuple[int, ...]


class DctFamily:
    name = "dct"
    # the dct layout is what the fused paged attend kernel reads
    supports_fused_attend = True

    def plane_specs(self, keep: int, head_dim: int) -> tuple[PlaneSpec, ...]:
        nh = head_dim // BLOCK
        return (PlaneSpec("packed", torch.int8, (nh, keep, keep)),
                PlaneSpec("scale", torch.float32, (nh,)))

    def pack(self, q, scale, keep: int) -> dict:
        return {"packed": q, "scale": scale}

    def unpack(self, planes: dict, keep: int):
        return planes["packed"], planes["scale"]

    def analytic_tile_bytes(self, keep: int) -> int:
        return codec_api.tile_bytes(keep)


_DCT = DctFamily()


def get_family(name: str | None) -> DctFamily:
    name = DEFAULT_FAMILY if name is None else name
    if name == _DCT.name:
        return _DCT
    if name in _LATER:
        raise NotImplementedError(f"codec family {name!r}: later slice")
    raise ValueError(f"unknown codec family {name!r}; have {available_families()}")


def available_families() -> list[str]:
    return [_DCT.name]
