"""Parameter containers and seeded init.

`Attention` groups the GQA projections and the optional QK-norm gains, `MLA`
deepseek-v3's latent-attention projections and norms.  `Linear` holds one weight ``W[K, N]`` (the reference layout, ``y = x @ W``,
not ``nn.Linear``'s ``[N, K]``) in whichever formats it carries: the master
``w`` and optional bias ``b``, and after deployment ``w8_vals``/``w8_scale``
(INT8) and ``mx_packed``/``mx_exps`` (MXINT4).  `Norm` holds a gain ``g``.
The model code is plain functions over these modules, so each function reads
like its JAX counterpart.

`Init` draws from an explicit ``torch.Generator`` with the reference's
distributions: normal with std ``1/sqrt(K)`` for linears unless a scale is
given (0.02 for ``embed`` and ``lm_head``), zeros for biases, ones for norm
gains.  torch and jax give different numbers from one seed; parity tests
carry the reference's weights over with `repro_torch.bridge` instead.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

FORMATS = ("b", "w8_vals", "w8_scale", "mx_packed", "mx_exps")


@dataclasses.dataclass
class Init:
    """Seeded parameter sampler on one device."""

    generator: torch.Generator
    device: torch.device
    dtype: torch.dtype

    @classmethod
    def from_seed(cls, seed: int, device, dtype) -> "Init":
        device = torch.device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return cls(gen, device, dtype)

    def normal(self, shape: tuple[int, ...], std: float) -> torch.Tensor:
        v = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32) * std
        return v.to(self.dtype)

    def ones(self, shape: tuple[int, ...]) -> torch.Tensor:
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def zeros(self, shape: tuple[int, ...]) -> torch.Tensor:
        return torch.zeros(shape, device=self.device, dtype=self.dtype)


def _param(t: torch.Tensor | None) -> nn.Parameter | None:
    return None if t is None else nn.Parameter(t, requires_grad=False)


class Linear(nn.Module):
    """A matmul weight ``W[K, N]`` executed through the HSA engine."""

    def __init__(self, w: torch.Tensor | None = None, **formats):
        super().__init__()
        unknown = set(formats) - set(FORMATS)
        if unknown:
            raise TypeError(f"unknown linear formats {sorted(unknown)}")
        self.register_parameter("w", _param(w))
        for name in FORMATS:
            self.register_buffer(name, formats.get(name))

    @classmethod
    def init(cls, init: Init, k: int, n: int, scale: float | None = None,
             bias: bool = False) -> "Linear":
        w = init.normal((k, n), scale if scale is not None else 1.0 / math.sqrt(k))
        return cls(w, b=init.zeros((n,)) if bias else None)


class Norm(nn.Module):
    """RMSNorm gain ``g`` (applied through `layers.norm_emit`/`norm_full`)."""

    def __init__(self, g: torch.Tensor):
        super().__init__()
        self.g = _param(g)


class Attention(nn.Module):
    """GQA projections ``wq, wk, wv, wo`` and, for QK-norm models (qwen3),
    the per-head RMSNorm gains ``qnorm``/``knorm``."""

    def __init__(self, wq: Linear, wk: Linear, wv: Linear, wo: Linear,
                 qnorm: Norm | None = None, knorm: Norm | None = None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        self.qnorm, self.knorm = qnorm, knorm


class MLA(nn.Module):
    """Multi-head latent attention (deepseek-v3): the q down- and
    up-projections ``wq_a``/``wq_b`` around ``q_norm``, the joint latent and
    shared rope-key projection ``wkv_a`` with ``kv_norm`` on the latent, the
    per-head key and value up-projections ``wk_b``/``wv_b`` (whose masters
    decode absorbs) and ``wo``."""

    def __init__(self, wq_a: Linear, q_norm: Norm, wq_b: Linear, wkv_a: Linear,
                 kv_norm: Norm, wk_b: Linear, wv_b: Linear, wo: Linear):
        super().__init__()
        self.wq_a, self.q_norm, self.wq_b = wq_a, q_norm, wq_b
        self.wkv_a, self.kv_norm = wkv_a, kv_norm
        self.wk_b, self.wv_b, self.wo = wk_b, wv_b, wo
