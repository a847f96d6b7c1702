"""INT8 error-feedback gradient compression (the reference's
`optim/compression.py`), over gradients keyed by parameter name.

Each reference leaf is quantized to int8 with one f32 scale after its
carried residual is added: the reference stacks a block tensor over the
layers of its group, so the port's per-layer tensors of one leaf (the
caller's ``leaf_of`` map, the model's `lm.leaf_groups`) share one scale,
their absmax over every layer; the rounding error becomes the next
residual, so the compressed sequence tracks the true gradient sum.  The optimizer consumes
the dequantized gradients, which is what every worker would reconstruct
after an int8 all-reduce; ``wire_bytes`` counts that payload.  The
all-reduce itself (the reference's ``psum_compressed``) is mesh-bound and
waits for ROADMAP A12.
"""

from __future__ import annotations

import torch


def init_residuals(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    return torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))


def _quantize(target: torch.Tensor, scale: torch.Tensor):
    q = torch.clamp(torch.round(target / scale), -127, 127).to(torch.int8)
    return q, target - q.to(torch.float32) * scale


def compress(g: torch.Tensor, residual: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One tensor -> (q int8, scale f32, new residual f32) with
    ``decompress(q, scale) + new_residual == g + residual`` in f32."""
    target = g.to(torch.float32) + residual
    scale = _scale(target.abs().max())
    q, new_residual = _quantize(target, scale)
    return q, scale, new_residual


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_grads(grads: dict[str, torch.Tensor], residuals: dict[str, torch.Tensor],
                     leaf_of: dict[str, str]) -> tuple[dict, dict, int]:
    """-> (dequantized grads, new residuals, wire bytes: one int8 a value
    and one f32 scale a reference leaf).  The tensors of one reference leaf
    (``leaf_of[name]``) share its scale."""
    targets = {n: g.to(torch.float32) + residuals[n] for n, g in grads.items()}
    absmax: dict[str, torch.Tensor] = {}
    for n, t in targets.items():
        k, m = leaf_of[n], t.abs().max()
        absmax[k] = m if k not in absmax else torch.maximum(absmax[k], m)
    deq, new_res = {}, {}
    for n, t in targets.items():
        scale = _scale(absmax[leaf_of[n]])
        q, new_res[n] = _quantize(t, scale)
        deq[n] = decompress(q, scale)
    wire = sum(g.numel() for g in grads.values()) + 4 * len(absmax)
    return deq, new_res, wire
