"""Decoder LM assembly — the ``retnet`` kind of the reference's `models/lm.py`.

Per-layer modules in an ``nn.ModuleList`` and a Python loop take the place of
the reference's ``lax.scan`` over stacked params; the residual stream is cast
back to the param dtype after every block, as the scan carry is there.

    forward_prefill — full prompt (MMM phase): last-token logits + warm cache
    forward_decode  — one token with the warm cache (MVM phase)

The decode cache is ``{"pos": int, "rope": OnlineRopeState, "blocks":
[{"s": f32 [B, H, dk, dv]} per layer]}``.  The position lives on the host:
the Python decode loop knows it without reading the card.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import online_rope as orp
from repro_torch.core.hsa import HSAEngine
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.models import retnet as R
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import Init, Linear, Norm


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "retnet":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; repro_torch serves retnet")


class RetNetBlock(nn.Module):
    def __init__(self, ln1: Norm, ret: R.Retention, ln2: Norm, mlp: M.MLP):
        super().__init__()
        self.ln1, self.ret, self.ln2, self.mlp = ln1, ret, ln2, mlp

    @classmethod
    def init(cls, init: Init, cfg: ModelConfig) -> "RetNetBlock":
        return cls(L.norm_init(init, cfg.d_model, cfg), R.Retention.init(init, cfg),
                   L.norm_init(init, cfg.d_model, cfg),
                   M.MLP.init(init, cfg.d_model, cfg.d_ff, gated=False))


class LM(nn.Module):
    def __init__(self, embed: torch.Tensor, blocks: list[RetNetBlock],
                 final_norm: Norm, lm_head: Linear):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        self.lm_head = lm_head


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> LM:
    """Seeded random weights in ``cfg.param_dtype`` on ``device``."""
    _check_family(cfg)
    ini = Init.from_seed(seed, device, getattr(torch, cfg.param_dtype))
    embed = ini.normal((cfg.padded_vocab, cfg.d_model), 0.02)
    blocks = [RetNetBlock.init(ini, cfg) for _ in range(cfg.n_layers)]
    final_norm = L.norm_init(ini, cfg.d_model, cfg)
    lm_head = Linear.init(ini, cfg.d_model, cfg.padded_vocab, scale=0.02)
    return LM(embed, blocks, final_norm, lm_head)


def _rope_dim(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.n_heads


def _rope_tables(cfg: ModelConfig, s: int, device):
    if not cfg.rope:
        return None, None
    th = orp.rope_thetas(_rope_dim(cfg), cfg.rope_base, device)
    return orp.rope_table(torch.arange(s, device=device), th)


def _embed(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    return model.embed[tokens]


def _block_apply(p: RetNetBlock, x, cfg, engine, phase, sin, cos):
    xs, sig = L.norm_emit(p.ln1, x, engine)
    y, cache = R.retention_apply(p.ret, xs, sig, engine, phase, cfg,
                                 rope_sin=sin, rope_cos=cos)
    x = x + y
    xs2, sig2 = L.norm_emit(p.ln2, x, engine)
    return x + M.mlp_apply(p.mlp, xs2, sig2, engine, phase), cache


def _block_decode(p: RetNetBlock, x, cfg, engine, cache, sin, cos):
    xs, sig = L.norm_emit(p.ln1, x, engine)
    y, cache = R.retention_decode(p.ret, xs, sig, engine, cfg, cache,
                                  rope_sin=sin, rope_cos=cos)
    x = x + y
    xs2, sig2 = L.norm_emit(p.ln2, x, engine)
    return x + M.mlp_apply(p.mlp, xs2, sig2, engine, "decode"), cache


def forward_prefill(model: LM, tokens: torch.Tensor, cfg: ModelConfig,
                    engine: HSAEngine) -> tuple[torch.Tensor, dict]:
    """Prompt processing (MMM phase): tokens [B, S] -> (logits [B, V], cache)."""
    _check_family(cfg)
    x = _embed(model, tokens)
    s = tokens.shape[1]
    sin, cos = _rope_tables(cfg, s, x.device)
    states = []
    for blk in model.blocks:
        y, cache = _block_apply(blk, x, cfg, engine, "prefill", sin, cos)
        x = y.to(x.dtype)          # keep the residual stream in param dtype
        states.append(cache)
    h = L.norm_full(model.final_norm, x[:, -1:])
    logits = engine.linear(model.lm_head, h, "prefill")[:, 0]
    caches = {"pos": s, "blocks": states}
    if cfg.rope:
        caches["rope"] = orp.init_state(_rope_dim(cfg), cfg.rope_base, pos=s,
                                        device=x.device)
    return logits, caches


def forward_decode(model: LM, tokens: torch.Tensor, cache: dict,
                   cfg: ModelConfig, engine: HSAEngine
                   ) -> tuple[torch.Tensor, dict]:
    """One generation step (MVM phase): tokens [B, 1] -> (logits [B, V], cache)."""
    x = _embed(model, tokens)
    new_cache = {"pos": cache["pos"] + 1}
    sin = cos = None
    if cfg.rope:
        st = cache["rope"]
        sin, cos = st.sin, st.cos                          # C4 Embed mode
        th = orp.rope_thetas(_rope_dim(cfg), cfg.rope_base, x.device)
        new_cache["rope"] = orp.advance(st, th)            # C4 Update mode
    states = []
    for blk, c in zip(model.blocks, cache["blocks"]):
        y, c2 = _block_decode(blk, x, cfg, engine, c, sin, cos)
        x = y.to(x.dtype)
        states.append(c2)
    new_cache["blocks"] = states
    h = L.norm_full(model.final_norm, x)
    logits = engine.linear(model.lm_head, h, "decode")[:, 0]
    return logits, new_cache


def make_decode_cache(cfg: ModelConfig, batch: int, *, start_pos: int = 0,
                      device="cuda") -> dict:
    """Cold cache at ``start_pos`` (zeros are the exact initial state)."""
    _check_family(cfg)
    caches = {"pos": start_pos,
              "blocks": [R.retention_make_cache(cfg, batch, device)
                         for _ in range(cfg.n_layers)]}
    if cfg.rope:
        caches["rope"] = orp.init_state(_rope_dim(cfg), cfg.rope_base,
                                        pos=start_pos, device=device)
    return caches
