"""Norms with the Eq. (4) fused emission (C3).

`norm_emit` returns ``(x*, sigma^{-1})``; sigma^{-1} rides into the consuming
linears' epilogues as ``row_scale``.  Only RMSNorm is ported so far.
"""

from __future__ import annotations

import torch

from repro_torch.core import fused_rmsnorm as fr
from repro_torch.core.hsa import HSAEngine
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import Init, Norm


def norm_init(init: Init, dim: int, cfg: ModelConfig) -> Norm:
    if cfg.norm_type != "rmsnorm":
        raise NotImplementedError(f"norm_type {cfg.norm_type!r} is not ported")
    return Norm(init.ones((dim,)))


def norm_emit(p: Norm, x: torch.Tensor, engine: HSAEngine
              ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Return (x*, sigma_inv) fused, or (normalized x, None) unfused."""
    if engine.config.fuse_rmsnorm:
        return fr.fused_rmsnorm_emit(x, p.g)
    return fr.rmsnorm(x, p.g), None


def norm_full(p: Norm, x: torch.Tensor) -> torch.Tensor:
    """Always-normalized variant (final norm before the LM head)."""
    return fr.rmsnorm(x, p.g)
