"""repro_torch — the PyTorch + CUDA (Hopper) port of `repro`.

Slice 1 covers the main serving path: compressed-KV paged decoding of a GQA
dense transformer (`yi_6b`, `qwen2_0_5b`).  Plain tensor code is PyTorch;
the two TPU kernels on the path (`fused_compress`, `fused_attend` paged) are
hand-written CUDA C++ for sm_90a under `csrc/`, built with nvcc at first use
and bound with ctypes (`kernels/build.py`).

Entry points run on the card unless the caller passes ``device="cpu"``; on
CPU tensors every kernel wrapper takes its plain PyTorch version, which is
what the CPU parity tests hold against the JAX package.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless told otherwise.

    ``None`` means the card.  Asking for CUDA where there is none raises —
    the port never carries on quietly on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}")
    return dev
