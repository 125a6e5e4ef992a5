"""repro_torch.codec — truncated DCT codec, its dct family and plans."""
from repro_torch.codec.api import (BLOCK, TILE_HEADER_BYTES, compress_blocks,
                                   decompress_blocks, tile_bytes)
from repro_torch.codec.plan import CompressionPlan, LayerPolicy, as_plan

__all__ = ["BLOCK", "TILE_HEADER_BYTES", "CompressionPlan", "LayerPolicy",
           "as_plan", "compress_blocks", "decompress_blocks", "tile_bytes"]
