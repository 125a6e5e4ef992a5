"""Plain PyTorch version of the fused_compress kernel: the reference plane
compressor of the truncated codec, in the same blocks layout the kernel
writes (per 8x8 tile z = C8[:k] X C8[:k]^T, scale = max(amax, 1e-8) / 127,
q = clip(round_half_even(z / scale), -127, 127))."""
from repro_torch.codec.reference import compress_plane

__all__ = ["compress_plane"]
