"""Generation/sampling configuration and the per-step token sampler.

Greedy, temperature and top-k, and the quantized KV-cache formats of
`core/kvq.py`.  Top-p and speculative decoding are not ported yet, so these
dataclasses do not offer them: a caller cannot ask for them and have them
silently ignored.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import kvq


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """temperature <= 0 means greedy (argmax); top_k == 0 disables top-k.
    Order: temperature -> top-k -> categorical draw."""

    temperature: float = 0.0
    top_k: int = 0

    def __post_init__(self):
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Loop-level controls for `InferenceEngine.generate`.

    ``cache_format`` ('int8_tok' | 'mxint4_blk') keeps the decode-phase KV
    cache in that encoding: prefill runs f32 and the cache is encoded once at
    the prefill/decode boundary (`lm.quantize_cache`); None keeps f32.  It
    has no effect on RetNet, whose state is not a KV cache."""

    max_new_tokens: int = 16
    sampling: SamplingParams = SamplingParams()
    stop_tokens: tuple[int, ...] = ()
    pad_token_id: int = 0
    cache_format: str | None = None

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.cache_format is not None:
            kvq.check_format(self.cache_format)


def _top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest logits per row, -inf elsewhere."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, -torch.inf, logits)


def sample(logits: torch.Tensor, params: SamplingParams,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """logits [B, V] -> token ids int64 [B], on the logits' device."""
    if params.greedy:
        return torch.argmax(logits, dim=-1)
    logits = logits.to(torch.float32) / params.temperature
    if params.top_k > 0:
        logits = _top_k_mask(logits, params.top_k)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
