"""Generation/sampling configuration and the per-step token sampler.

Greedy, temperature, top-k and top-p (nucleus), the quantized KV-cache
formats of `core/kvq.py`, and speculative decode (`SpeculativeConfig`,
serving/speculative.py).  The dataclasses are frozen and hashable: a
`GenerationConfig` keys the captured decode and verify steps.

`sample` runs inside the captured decode and verify steps: every filter is a
device op (``topk``, ``sort``, ``cumsum``, ``where``) and nothing is read
back to the host, so one graph replays it at every step.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import kvq


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """temperature <= 0 means greedy (argmax); top_k == 0 and top_p >= 1.0
    disable the respective filters.  Order: temperature -> top-k -> top-p ->
    categorical draw."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    """Multi-token speculative decode (serving/speculative.py): each step
    drafts ``k`` tokens, scores the pending token and the drafts in ONE
    chunk-shaped verify dispatch (the MMM dataflow: one weight-stream read
    for the whole block) and commits the accepted prefix plus one freshly
    sampled token.

    ``drafter``: 'ngram' (model-free prompt lookup: the trailing
    ``ngram``-gram is matched against the request's own history and its
    historical continuation proposed) or 'mtp' (deepseek-v3's multi-token-
    prediction head chained ``k`` deep; needs ``cfg.mtp``, and runs in
    `InferenceEngine.generate` only)."""

    k: int = 4                      # drafted tokens per verify step
    drafter: str = "ngram"          # 'ngram' | 'mtp'
    ngram: int = 2                  # lookup n-gram length (ngram drafter)

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.drafter not in ("ngram", "mtp"):
            raise ValueError(f"unknown drafter {self.drafter!r}")
        if self.ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {self.ngram}")


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Loop-level controls for `InferenceEngine.generate`.

    ``cache_format`` ('int8_tok' | 'mxint4_blk') keeps the decode-phase KV
    cache in that encoding: prefill runs f32 and the cache is encoded once at
    the prefill/decode boundary (`lm.quantize_cache`); None keeps f32.  It
    has no effect on RetNet, whose state is not a KV cache.  ``speculative``
    switches `generate` to the draft / verify / commit loop."""

    max_new_tokens: int = 16
    sampling: SamplingParams = SamplingParams()
    stop_tokens: tuple[int, ...] = ()
    pad_token_id: int = 0
    speculative: SpeculativeConfig | None = None
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


def _top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest prefix of the sorted distribution
    whose cumulative probability reaches p (the crossing token included),
    -inf elsewhere.  A token survives if the mass *before* it (the exclusive
    cumsum) is < p; every logit equal to the smallest survivor survives."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p
    thresh = torch.where(keep_sorted, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, -torch.inf, logits)


def sample(logits: torch.Tensor, params: SamplingParams,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """logits [..., V] -> token ids int64 [...], on the logits' device: every
    position of a ``[B, C, V]`` verify block is sampled, the draws taken in
    row-major order from ``generator``."""
    if params.greedy:
        return torch.argmax(logits, dim=-1)
    lead = logits.shape[:-1]
    logits = logits.reshape(-1, logits.shape[-1]).to(torch.float32) / params.temperature
    if params.top_k > 0:
        logits = _top_k_mask(logits, params.top_k)
    if params.top_p < 1.0:
        logits = _top_p_mask(logits, params.top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].reshape(lead)
