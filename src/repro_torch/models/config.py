"""ModelConfig — one config dataclass covering every assigned architecture.

A torch-free, jax-free copy of the JAX package's ``models/config.py``: the
port keeps its own so that it never imports the reference.  Each entry of
`repro_torch.configs.REGISTRY` instantiates this with the published numbers;
`reduced()` derives the family-preserving tiny config the CPU tests use.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense|moe|ssm|hybrid|retnet|encdec|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads

    # --- attention ---------------------------------------------------------
    attn_type: str = "gqa"          # 'gqa' | 'mla' | 'none' | 'retention'
    qk_norm: bool = False           # qwen3
    qkv_bias: bool = False          # qwen1.5
    rope: bool = True
    rope_base: float = 10000.0
    abs_pos_embed: bool = False     # sinusoidal absolute positions (seamless)
    sliding_window: int = 0         # 0 = full attention
    full_attn_every: int = 0        # hybrid: layer i is full-attn if i % this == 0
    norm_type: str = "rmsnorm"      # 'rmsnorm' | 'layernorm'

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0     # deepseek-v3: first 3 layers dense
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # --- MLA (deepseek-v3) ---------------------------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False               # multi-token-prediction extra block

    # --- SSM (mamba-1) -------------------------------------------------------
    ssm_state: int = 0
    d_inner: int = 0                # 0 -> 2 * d_model
    conv_width: int = 4
    dt_rank: int = 0                # 0 -> ceil(d_model / 16)
    ssm_chunk: int = 128

    # --- retention (retnet) --------------------------------------------------
    # v/gate use 2*d_model (RetNet's d_v = 2 d); heads are retention heads.

    # --- enc-dec / frontends --------------------------------------------------
    encoder_layers: int = 0         # >0 -> encoder-decoder
    frontend: str | None = None     # 'audio' | 'vision' (stub embeddings)
    frontend_tokens: int = 0        # patches/frames occupying the prompt head

    # --- numerics / structure -------------------------------------------------
    param_dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256
    tie_embeddings: bool = False

    # ------------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner_(self) -> int:
        return self.d_inner or (2 * self.d_model)

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or max(1, math.ceil(self.d_model / 16))

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context with bounded state?"""
        return self.family in ("ssm", "retnet") or (
            self.family == "hybrid" and self.sliding_window > 0)

    def reduced(self) -> "ModelConfig":
        """Family-preserving tiny config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2 + self.first_dense_layers),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 2,
            head_dim=32,
            d_ff=192 if self.d_ff else 0,
            vocab_size=512,
            vocab_pad_multiple=64,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            moe_d_ff=64 if self.moe_d_ff else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_nope_head_dim=32 if self.qk_nope_head_dim else 0,
            qk_rope_head_dim=16 if self.qk_rope_head_dim else 0,
            v_head_dim=32 if self.v_head_dim else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            d_inner=256 if self.family in ("ssm", "hybrid") else 0,
            dt_rank=8 if self.family in ("ssm", "hybrid") else 0,
            ssm_chunk=16,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            encoder_layers=min(self.encoder_layers, 2),
            frontend_tokens=min(self.frontend_tokens, 8),
            param_dtype="float32",
        )
