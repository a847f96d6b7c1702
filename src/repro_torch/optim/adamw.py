"""AdamW with warmup + cosine schedule and global-norm clipping, keyed by
parameter name (the reference's `optim/adamw.py`).

The update runs in f32 and casts back to each parameter's dtype; the moments
are held in ``moment_dtype``.  Unlike the reference's pure function, `update`
writes the new parameters and moments in place, one tensor at a time, so a
full-width step never holds a second copy of the model or its moments.

Weight decay follows the reference's rule on the reference's layout: it
decays a leaf with ``ndim >= 2``, and its per-layer leaves are stacked
``[L, ...]``.  So every per-layer tensor (a block's norm gain or bias
included) is decayed, and a top-level one only when it is a matrix:
`decayed` decides by that rank, not by the port's one-dimension-smaller
per-layer tensors.  The caller says which tensors are stacked with
``leaf_of``, ``{name: the reference leaf it belongs to}`` (the model's
`lm.leaf_groups`): a tensor whose leaf has another name is one layer of a
stacked leaf.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"


def decayed(t: torch.Tensor, stacked: bool) -> bool:
    """Whether the reference decays this tensor: ``ndim >= 2`` in its
    layout, where a ``stacked`` (per-layer) tensor carries the layer axis."""
    return t.ndim + int(stacked) >= 2


def init(params: dict[str, torch.Tensor], cfg: AdamWConfig) -> dict:
    """Zero moments in ``moment_dtype`` beside each parameter, and the step
    (an int32 scalar on the parameters' device)."""
    dt = getattr(torch, cfg.moment_dtype)
    device = next(iter(params.values())).device
    zeros = {n: torch.zeros(p.shape, dtype=dt, device=p.device) for n, p in params.items()}
    return {"m": zeros, "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """The learning rate at ``step`` (f32, on its device): linear warmup,
    then a cosine down to ``min_lr_ratio``."""
    step = step.to(torch.float32)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every tensor's squares, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in tree.values()))


@torch.no_grad()
def update(grads: dict[str, torch.Tensor], state: dict, params: dict[str, torch.Tensor],
           cfg: AdamWConfig, leaf_of: dict[str, str]) -> dict:
    """One AdamW step over every named parameter, in place: ``params`` and
    ``state["m"]``, ``state["v"]`` take their new values, ``state["step"]``
    advances.  Returns ``{"lr", "grad_norm"}`` (f32 scalars on the device).
    The gradients are clipped by their global norm first; ``leaf_of`` maps
    each name to its reference leaf (module docstring)."""
    step = state["step"]
    lr = schedule(step, cfg)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    t = (step + 1).to(torch.float32)
    bc1 = 1 - torch.pow(cfg.b1, t)
    bc2 = 1 - torch.pow(cfg.b2, t)
    mdt = getattr(torch, cfg.moment_dtype)
    for name, p in params.items():
        g = grads[name].to(torch.float32) * scale
        m32 = cfg.b1 * state["m"][name].to(torch.float32) + (1 - cfg.b1) * g
        v32 = cfg.b2 * state["v"][name].to(torch.float32) + (1 - cfg.b2) * g * g
        upd = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        p32 = p.to(torch.float32)
        if decayed(p, leaf_of[name] != name):       # decoupled weight decay
            upd = upd + cfg.weight_decay * p32
        p.copy_((p32 - lr * upd).to(p.dtype))
        state["m"][name].copy_(m32.to(mdt))
        state["v"][name].copy_(v32.to(mdt))
    state["step"] = step + 1
    return {"lr": lr, "grad_norm": gnorm}
