"""Architecture registry — the port's own copy of the reference registry.

The numbers are the published ones, the same as the JAX package's
``configs/<arch>.py``; `get_config` resolves an ``--arch`` name.  Only the
``retnet`` family runs in the port so far (`InferenceEngine.from_config`
raises for the others), but the registry is complete so names resolve alike.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

RETNET_1_3B = ModelConfig(
    name="retnet-1.3b", family="retnet", attn_type="retention", n_layers=24,
    d_model=2048, n_heads=8, n_kv_heads=8, d_ff=4096, vocab_size=32768)

RETNET_6_7B = ModelConfig(
    name="retnet-6.7b", family="retnet", attn_type="retention", n_layers=32,
    d_model=4096, n_heads=16, n_kv_heads=16, d_ff=8192, vocab_size=32768)

_OTHERS = (
    ModelConfig(name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
                n_heads=25, n_kv_heads=5, head_dim=64, d_ff=5504,
                vocab_size=32001, sliding_window=1024, ssm_state=16,
                d_inner=3200, dt_rank=100, ssm_chunk=128),
    ModelConfig(name="falcon-mamba-7b", family="ssm", n_layers=64,
                d_model=4096, n_heads=16, n_kv_heads=16, d_ff=0,
                vocab_size=65024, rope=False, ssm_state=16, d_inner=8192,
                dt_rank=256, ssm_chunk=128),
    ModelConfig(name="deepseek-v3-671b", family="moe", n_layers=61,
                d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
                d_ff=18432, vocab_size=129280, attn_type="mla",
                q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                qk_rope_head_dim=64, v_head_dim=128, n_experts=256, top_k=8,
                moe_d_ff=2048, n_shared_experts=1, first_dense_layers=3,
                mtp=True),
    ModelConfig(name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
                n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1024,
                vocab_size=50304, qk_norm=True, n_experts=64, top_k=8,
                moe_d_ff=1024),
    ModelConfig(name="internlm2-1.8b", family="dense", n_layers=24,
                d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
                d_ff=8192, vocab_size=92544),
    ModelConfig(name="qwen1.5-4b", family="dense", n_layers=40, d_model=2560,
                n_heads=20, n_kv_heads=20, head_dim=128, d_ff=6912,
                vocab_size=151936, qkv_bias=True),
    ModelConfig(name="qwen3-8b", family="dense", n_layers=36, d_model=4096,
                n_heads=32, n_kv_heads=8, head_dim=128, d_ff=12288,
                vocab_size=151936, qk_norm=True),
    ModelConfig(name="starcoder2-15b", family="dense", n_layers=40,
                d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
                d_ff=24576, vocab_size=49152, norm_type="layernorm"),
    ModelConfig(name="seamless-m4t-medium", family="audio", n_layers=12,
                encoder_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
                head_dim=64, d_ff=4096, vocab_size=256206,
                norm_type="layernorm", rope=False, abs_pos_embed=True,
                frontend="audio", frontend_tokens=1536),
    ModelConfig(name="llava-next-34b", family="vlm", n_layers=60,
                d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
                d_ff=20480, vocab_size=64000, frontend="vision",
                frontend_tokens=2880),
)

REGISTRY: dict[str, ModelConfig] = {
    c.name: c for c in (*_OTHERS, RETNET_1_3B, RETNET_6_7B)}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
