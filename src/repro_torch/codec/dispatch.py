"""Kernel-or-plain dispatch: the path follows the tensor's device.

A CUDA tensor goes to the hand-written Hopper kernel, a CPU tensor to the
kernel's plain PyTorch version.  There is no other selector: no backend
registry, no environment override, no fallback when a kernel fails.
"""
from __future__ import annotations

import torch


def on_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (plain version); any other device raises."""
    kind = x.device.type
    if kind == "cuda":
        return True
    if kind == "cpu":
        return False
    raise RuntimeError(f"no kernel or plain path for device {x.device}")
