"""Layer-fused RMSNorm — Section IV-B1, Eq. (4) of the HSA paper.

Layer n emits ``Y* = Y * gamma`` and the per-token ``sigma^{-1}``; layer n+1
applies ``sigma^{-1}`` as the row scale of its matmul epilogue, so the
normalized activation is never written out.  ``sigma^{-1}`` is a per-token
scalar, so it commutes with the contraction and the fusion is exact.
"""

from __future__ import annotations

import torch


def rms_sigma_inv(y: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """sigma^{-1} per token: ``[..., D]`` -> ``[...]`` in f32."""
    y32 = y.to(torch.float32)
    return torch.rsqrt((y32 * y32).mean(dim=-1) + eps)


def rmsnorm(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor | None = None,
            eps: float = 1e-6) -> torch.Tensor:
    """Unfused RMSNorm (Eq. 3)."""
    out = (y.to(torch.float32) * rms_sigma_inv(y, eps)[..., None]
           * gamma.to(torch.float32))
    if beta is not None:
        out = out + beta.to(torch.float32)
    return out.to(y.dtype)


def fused_rmsnorm_emit(y: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer-n side of Eq. (4): ``(Y * gamma, sigma^{-1})``."""
    y_star = (y.to(torch.float32) * gamma.to(torch.float32)).to(y.dtype)
    return y_star, rms_sigma_inv(y, eps)
