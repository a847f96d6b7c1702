"""Feed-forward layer: ``wo(act(x wi))``, gated with ``silu(x wg)`` when the
MLP carries ``wg`` (RetNet's is ungated: GeLU)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.hsa import HSAEngine
from repro_torch.models.modules import Init, Linear


class MLP(nn.Module):
    def __init__(self, wi: Linear, wo: Linear, wg: Linear | None = None):
        super().__init__()
        self.wi, self.wo, self.wg = wi, wo, wg

    @classmethod
    def init(cls, init: Init, d: int, f: int, gated: bool = True) -> "MLP":
        wg = Linear.init(init, d, f) if gated else None
        return cls(Linear.init(init, d, f), Linear.init(init, f, d), wg)


def mlp_apply(p: MLP, x_star: torch.Tensor, sig_inv, engine: HSAEngine,
              phase: str) -> torch.Tensor:
    up = engine.linear(p.wi, x_star, phase, row_scale=sig_inv)
    if p.wg is not None:
        gate = engine.linear(p.wg, x_star, phase, row_scale=sig_inv)
        up = F.silu(gate) * up
    else:
        up = F.gelu(up, approximate="tanh")   # jax.nn.gelu's default
    return engine.linear(p.wo, up, phase)
