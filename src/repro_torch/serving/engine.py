"""`InferenceEngine` — the one public entry point for serving a model.

    lm.init -> deploy.deploy_quantize -> HSAEngine -> prefill
            -> (KV cache encoded to ``gen.cache_format``) -> decode loop

The reference fuses its decode loop into one jitted ``lax.while_loop``; here
it is a plain Python loop with the same semantics: ``out[:, i]`` is sampled
before decode step ``i`` (the first token from the prefill logits), slots
after a sequence's stop token hold ``pad_token_id``, and ``lengths`` counts
emitted tokens including the stop token.  Tokens stay on the device; the
loop reads the card only to end early when every sequence has stopped, and
only when stop tokens were given.  Prefill and decode are timed on the host
clock around work that ends in ``torch.cuda.synchronize()``.

Usage::

    engine = InferenceEngine.from_config("qwen3-8b", EngineSpec())
    result = engine.generate(prompts, GenerationConfig(max_new_tokens=32,
                                                       cache_format="int8_tok"))
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import configs
from repro_torch.core.hsa import HSAConfig, HSAEngine
from repro_torch.models import deploy, lm
from repro_torch.models.config import ModelConfig
from repro_torch.serving.sampling import GenerationConfig, sample


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """How to build the serving stack around a model config.

    The default is the paper's deployment: W8A8 prefill (MMM dataflow) and
    MXINT4 decode (MVM dataflow) with the Eq. (4) fused RMSNorm and the
    online RoPE unit.  ``kernel_impl='auto'`` runs the Hopper kernels on
    CUDA tensors and their plain versions on CPU tensors.
    """

    quantize: bool = True               # PTQ-deploy master weights
    prefill_format: str = "w8a8"        # 'w8a8' | 'fp'
    decode_format: str = "mxint4"       # 'mxint4' | 'w8a8' | 'fp'
    fuse_rmsnorm: bool = True           # C3 ablation switch
    kernel_impl: str = "auto"           # 'auto' | 'kernel' | 'ref'
    reduced: bool = False               # use cfg.reduced() (CPU-scale)
    seed: int = 0                       # init seed when no model is supplied

    def hsa_config(self) -> HSAConfig:
        return HSAConfig(
            prefill_format=self.prefill_format if self.quantize else "fp",
            decode_format=self.decode_format if self.quantize else "fp",
            fuse_rmsnorm=self.fuse_rmsnorm, kernel_impl=self.kernel_impl)


@dataclasses.dataclass
class GenerationResult:
    """Output of `InferenceEngine.generate`."""

    tokens: torch.Tensor     # int64 [B, max_new_tokens]; pad after stop token
    lengths: torch.Tensor    # int32 [B] — emitted tokens incl. the stop token
    prefill_s: float         # wall-clock MMM phase
    decode_s: float          # wall-clock MVM phase
    decode_steps: int = 0    # forward_decode calls the loop made


class InferenceEngine:
    """Deployed model + HSA engine + prefill / decode loop."""

    def __init__(self, cfg: ModelConfig, model: lm.LM, spec: EngineSpec,
                 hsa: HSAEngine | None = None):
        self.cfg = cfg
        self.model = model
        self.spec = spec
        self.hsa = hsa or HSAEngine(spec.hsa_config())
        self.device = model.embed.device

    @classmethod
    def from_config(cls, cfg: ModelConfig | str, spec: EngineSpec = EngineSpec(),
                    *, model: lm.LM | None = None, device="cuda"
                    ) -> "InferenceEngine":
        """Build the serving stack: init (or adopt) a model, PTQ-deploy it in
        place when ``spec.quantize`` and it still has master weights, and
        wire the HSA engine.

        ``device`` defaults to the card; the CPU runs only when asked for.
        """
        if isinstance(cfg, str):
            cfg = configs.get_config(cfg)
        if spec.reduced:
            cfg = cfg.reduced()
        lm._check_family(cfg)
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "plain PyTorch path on the CPU")
        if model is None:
            model = lm.init(cfg, seed=spec.seed, device=device)
        if spec.quantize and deploy.is_master(model):
            deploy.deploy_quantize(model)
        return cls(cfg, model, spec)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, *, cache_len: int | None = None
                ) -> tuple[torch.Tensor, dict]:
        """MMM phase: prompts [B, S] -> (last-token logits [B, V], cache).

        ``cache_len`` (default S) is the KV slots a dense model's cache
        holds: S plus the tokens decode will append."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return lm.forward_prefill(self.model, tokens, self.cfg, self.hsa,
                                  cache_len=cache_len or tokens.shape[1])

    @torch.inference_mode()
    def decode_step(self, tokens: torch.Tensor, cache: dict
                    ) -> tuple[torch.Tensor, dict]:
        """One MVM step: tokens [B, 1] + warm cache -> (logits [B, V], cache)."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return lm.forward_decode(self.model, tokens, cache, self.cfg, self.hsa)

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor,
                 gen: GenerationConfig = GenerationConfig(), *,
                 generator: torch.Generator | None = None) -> GenerationResult:
        """Prefill + decode loop.  prompts [B, S] -> GenerationResult.

        ``generator`` seeds stochastic sampling (a fixed seed when absent);
        greedy decoding draws nothing.
        """
        prompts = torch.as_tensor(prompts, device=self.device).long()
        if generator is None and not gen.sampling.greedy:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        b, n = prompts.shape[0], gen.max_new_tokens

        self._sync()
        t0 = time.perf_counter()
        logits, cache = self.prefill(prompts, cache_len=prompts.shape[1] + n)
        cache = self._encode_cache(cache, gen)
        self._sync()
        t_prefill = time.perf_counter() - t0

        t0 = time.perf_counter()
        stop = (torch.tensor(gen.stop_tokens, device=self.device)
                if gen.stop_tokens else None)
        out = torch.full((b, n), gen.pad_token_id, dtype=torch.long,
                         device=self.device)
        done = torch.zeros(b, dtype=torch.bool, device=self.device)
        lengths = torch.zeros(b, dtype=torch.int32, device=self.device)
        tok = sample(logits, gen.sampling, generator)
        steps = 0
        for i in range(n):
            out[:, i] = torch.where(done, gen.pad_token_id, tok)
            lengths += (~done).to(torch.int32)
            if stop is not None:
                done = done | (tok[:, None] == stop[None, :]).any(dim=-1)
            logits, cache = self.decode_step(tok[:, None], cache)
            steps += 1
            tok = sample(logits, gen.sampling, generator)
            if stop is not None and bool(done.all()):
                break
        self._sync()
        return GenerationResult(tokens=out, lengths=lengths, prefill_s=t_prefill,
                                decode_s=time.perf_counter() - t0,
                                decode_steps=steps)

    @torch.inference_mode()
    def _encode_cache(self, cache: dict, gen: GenerationConfig) -> dict:
        """Apply ``gen.cache_format`` at the prefill/decode boundary: prefill
        ran f32, the decode residency streams the encoded bytes."""
        if gen.cache_format is None:
            return cache
        return lm.quantize_cache(cache, self.cfg, gen.cache_format)
