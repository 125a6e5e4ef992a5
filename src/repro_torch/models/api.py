"""Model façade: `build(arch_id)` for the dense GQA family."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig, get_config
from repro_torch.models import transformer as T


@dataclass(frozen=True)
class ModelAPI:
    arch_id: str
    cfg: ArchConfig

    def init(self, generator: torch.Generator, dtype=torch.bfloat16,
             device=None) -> dict:
        return T.init_lm(self.cfg, generator, dtype=dtype, device=device)


def build(arch_id: str, cfg: ArchConfig | None = None) -> ModelAPI:
    arch_id = arch_id.replace("-", "_")
    cfg = cfg or get_config(arch_id)
    if cfg.family != "dense" or cfg.attn_type != "gqa":
        raise NotImplementedError(
            f"{arch_id}: family {cfg.family!r} is a later slice (dense GQA only)")
    return ModelAPI(arch_id, cfg)


def build_reduced(arch_id: str) -> ModelAPI:
    """Smoke-test sized API of the same family."""
    return build(arch_id, get_config(arch_id).reduced())
