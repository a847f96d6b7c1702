"""Decoder LM assembly: the ``retnet`` and ``dense`` kinds of the reference's
`models/lm.py`, dense with GQA or MLA attention.

Per-layer modules in an ``nn.ModuleList`` and a Python loop take the place of
the reference's ``lax.scan`` over stacked params; the residual stream is cast
back to the param dtype after every block, as the scan carry is there.

    forward_prefill       — full prompt (MMM phase), exact or bucketed:
                            last-token logits + warm cache
    forward_prefill_chunk — one chunk of a prompt over a warm cache (MMM)
    forward_decode        — one token with the warm cache (MVM phase)

Layers come in the reference's groups (`layer_groups`), held in one flat
list in group order: deepseek-v3's leading dense layers (``dense_head``)
run, and a config cut to them has no MoE layer; MoE layers are not ported.

The decode cache is ``{"pos": i32 scalar, "rope": OnlineRopeState, "blocks":
[one per layer]}``: ``{"s": f32 [B, H, dk, dv]}`` for RetNet, ``{"k", "v"}``
``[B, C, KV, hd]`` leaves for dense GQA, ``{"c_kv" [B, C, kv_lora_rank],
"k_rope" [B, C, qk_rope_head_dim]}`` for MLA (plain tensors or kvq-encoded
dicts).
The position lives on the device, as the reference's traced scalar does: no
host integer that changes from step to step reaches a kernel, a shape or a
branch of `forward_decode`, so one captured step replays at every position
(`serving/engine.py`).  ``pos`` is an int32 scalar shared by the batch, or
an int32 ``[B]`` vector with one position per lane (``make_decode_cache(...,
per_lane=True)``: a scheduler's slot class, the port's counterpart of the
reference's per-slot scalar under ``vmap``); the rope angles, the slots
written and flash-decode's ``kv_len`` then follow each lane's own.  Dense decode writes each new K/V row into the cache
in place (`layers.cache_update`).  The multi-token-prediction head of
deepseek-v3 (``cfg.mtp``) is not built: generation never reads it.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.core import kvq
from repro_torch.core import online_rope as orp
from repro_torch.core.hsa import HSAEngine
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.models import retnet as R
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import MLA, Attention, Init, Linear, Norm


def layer_groups(cfg: ModelConfig) -> list[tuple[str, int, str]]:
    """The reference's homogeneous runs of layers, in order, as ``(name,
    count, kind)``, for the families the port serves: a MoE model's
    ``first_dense_layers`` form ``dense_head`` ahead of its MoE ``blocks``."""
    if cfg.family == "moe" and cfg.first_dense_layers:
        dense = min(cfg.first_dense_layers, cfg.n_layers)
        return [("dense_head", dense, "dense"), ("blocks", cfg.n_layers - dense, "moe")]
    return [("blocks", cfg.n_layers, "retnet" if cfg.family == "retnet" else "dense")]


def _check_family(cfg: ModelConfig) -> None:
    """Raise, naming what is missing, unless the port serves ``cfg``."""
    if cfg.family == "retnet":
        return
    if cfg.family == "moe":
        if cfg.n_layers > cfg.first_dense_layers:
            raise NotImplementedError(
                f"{cfg.name}: MoE layers are not ported yet; repro_torch serves a "
                f"MoE model cut to its {cfg.first_dense_layers} leading dense layers "
                f"(n_layers={cfg.first_dense_layers})")
    elif cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; repro_torch serves "
            f"retnet and dense")
    missing = [what for what, present in (
        (f"norm_type {cfg.norm_type!r}", cfg.norm_type != "rmsnorm"),
        ("sliding-window attention", bool(cfg.sliding_window)),
        (f"frontend {cfg.frontend!r}", cfg.frontend is not None),
        ("absolute position embeddings", cfg.abs_pos_embed),
        (f"attn_type {cfg.attn_type!r}", cfg.attn_type not in ("gqa", "mla")))
        if present]
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} not ported yet")


class RetNetBlock(nn.Module):
    def __init__(self, ln1: Norm, ret: R.Retention, ln2: Norm, mlp: M.MLP):
        super().__init__()
        self.ln1, self.ret, self.ln2, self.mlp = ln1, ret, ln2, mlp

    @classmethod
    def init(cls, init: Init, cfg: ModelConfig) -> "RetNetBlock":
        return cls(L.norm_init(init, cfg.d_model, cfg), R.Retention.init(init, cfg),
                   L.norm_init(init, cfg.d_model, cfg),
                   M.MLP.init(init, cfg.d_model, cfg.d_ff, gated=False))


class DenseBlock(nn.Module):
    """Pre-norm attention (GQA, or MLA for ``attn_type == "mla"``) then an
    MLP, gated for RMSNorm archs."""

    def __init__(self, ln1: Norm, attn: Attention | MLA, ln2: Norm, mlp: M.MLP):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp

    @classmethod
    def init(cls, init: Init, cfg: ModelConfig) -> "DenseBlock":
        ln1 = L.norm_init(init, cfg.d_model, cfg)
        attn = L.mla_init(init, cfg) if cfg.attn_type == "mla" else L.gqa_init(init, cfg)
        return cls(ln1, attn, L.norm_init(init, cfg.d_model, cfg),
                   M.MLP.init(init, cfg.d_model, cfg.d_ff,
                              gated=cfg.norm_type == "rmsnorm"))


BLOCK_KINDS = {"retnet": RetNetBlock, "dense": DenseBlock}


class LM(nn.Module):
    def __init__(self, embed: torch.Tensor, blocks: list[nn.Module],
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
    blocks = [BLOCK_KINDS[kind].init(ini, cfg)
              for _, count, kind in layer_groups(cfg) for _ in range(count)]
    final_norm = L.norm_init(ini, cfg.d_model, cfg)
    lm_head = Linear.init(ini, cfg.d_model, cfg.padded_vocab, scale=0.02)
    return LM(embed, blocks, final_norm, lm_head)


def _rope_dim(cfg: ModelConfig) -> int:
    """Rotary width: the MLA rope head, RetNet's d_model / n_heads, else the
    attention head dim (the reference's rule)."""
    if cfg.attn_type == "mla":
        return cfg.qk_rope_head_dim
    if cfg.family == "retnet":
        return cfg.d_model // cfg.n_heads
    return cfg.head_dim_


@functools.lru_cache(maxsize=None)
def _thetas(dim: int, base: float, device: torch.device) -> torch.Tensor:
    """The rotary frequencies of one width, base and device, computed once
    (building them copies ``base`` to the device, which a captured decode
    step must not do).  Callers must not modify the tensor."""
    return orp.rope_thetas(dim, base, device)


def _rope_tables(cfg: ModelConfig, s: int, device, start=0):
    """(sin, cos) ``[s, d/2]`` at positions ``start .. start + s - 1``;
    ``start`` may be an int32 scalar on the device (a chunk's position)."""
    if not cfg.rope:
        return None, None
    th = _thetas(_rope_dim(cfg), cfg.rope_base, device)
    return orp.rope_table(start + torch.arange(s, device=device), th)


def _rope_state(cfg: ModelConfig, pos: torch.Tensor) -> orp.OnlineRopeState:
    """The online RoPE unit's angle memory at ``pos``, an int32 scalar on the
    device (`orp.init_state` at a position that is not a host int).  It
    keeps its own copy of ``pos``: a decode step updates a cache's
    position and its rope state in place, one after the other."""
    sin, cos = orp.rope_table(pos, _thetas(_rope_dim(cfg), cfg.rope_base, pos.device))
    return orp.OnlineRopeState(sin=sin, cos=cos, pos=pos.clone())


def _embed(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    return model.embed[tokens]


def _seed_attn_cache(leaves: dict, cache_len: int = 0) -> dict:
    """Prefill K/V (or MLA's latents) -> the decode cache layout: each leaf
    ``[B, S, ...]`` right-padded with zeros along the slot axis to
    ``cache_len`` so generation can continue."""
    out = {}
    for name, x in leaves.items():
        if cache_len > x.shape[1]:
            pad = (0, 0) * (x.ndim - 2) + (0, cache_len - x.shape[1])
            x = torch.nn.functional.pad(x, pad)
        out[name] = x
    return out


def _block_apply(p, x, cfg, engine, phase, sin, cos, cache_len: int = 0,
                 valid_len=None):
    """Full-sequence block -> (x_out, cache seed).

    ``valid_len`` (bucketed prefill) marks the tokens from it on as padding:
    causality keeps them out of every real token's output, and RetNet's
    state masks them; a linear KV cache keeps its padded tail, which decode
    masks and then overwrites."""
    xs, sig = L.norm_emit(p.ln1, x, engine)
    if isinstance(p, RetNetBlock):
        y, cache = R.retention_apply(p.ret, xs, sig, engine, phase, cfg,
                                     rope_sin=sin, rope_cos=cos, valid_len=valid_len)
    elif cfg.attn_type == "mla":
        y, (c_kv, k_rope) = L.mla_apply(p.attn, xs, sig, engine, phase, cfg,
                                        rope_sin=sin, rope_cos=cos)
        cache = _seed_attn_cache({"c_kv": c_kv, "k_rope": k_rope}, cache_len)
    else:
        y, (k, v) = L.gqa_apply(p.attn, xs, sig, engine, phase, cfg,
                                rope_sin=sin, rope_cos=cos)
        cache = _seed_attn_cache({"k": k, "v": v}, cache_len)
    x = x + y
    xs2, sig2 = L.norm_emit(p.ln2, x, engine)
    return x + M.mlp_apply(p.mlp, xs2, sig2, engine, phase), cache


def _block_decode(p, x, cfg, engine, cache, pos: torch.Tensor, sin, cos):
    """One-token block at absolute position ``pos`` -> (x_out, cache)."""
    xs, sig = L.norm_emit(p.ln1, x, engine)
    if isinstance(p, RetNetBlock):
        y, cache = R.retention_decode(p.ret, xs, sig, engine, cfg, cache,
                                      rope_sin=sin, rope_cos=cos)
    else:
        decode = L.mla_decode if cfg.attn_type == "mla" else L.gqa_decode
        y, cache = decode(p.attn, xs, sig, engine, cfg, cache, pos,
                          rope_sin=sin, rope_cos=cos)
    x = x + y
    xs2, sig2 = L.norm_emit(p.ln2, x, engine)
    return x + M.mlp_apply(p.mlp, xs2, sig2, engine, "decode"), cache


def forward_prefill(model: LM, tokens: torch.Tensor, cfg: ModelConfig,
                    engine: HSAEngine, cache_len: int = 0,
                    valid_len: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, dict]:
    """Prompt processing (MMM phase): tokens [B, S] -> (logits [B, V], cache).

    ``cache_len`` > S reserves KV slots for the tokens decode will append.

    Bucketed mode: ``valid_len`` (an int32 scalar on the device) marks
    ``tokens`` as a prompt of that length right-padded to S.  The logits are
    taken at the last real token, and the cache's ``pos`` and RoPE state
    start there (see `_block_apply` for the cache seeds)."""
    _check_family(cfg)
    x = _embed(model, tokens)
    s = tokens.shape[1]
    sin, cos = _rope_tables(cfg, s, x.device)
    states = []
    for blk in model.blocks:
        y, cache = _block_apply(blk, x, cfg, engine, "prefill", sin, cos, cache_len,
                                valid_len=valid_len)
        x = y.to(x.dtype)          # keep the residual stream in param dtype
        states.append(cache)
    if valid_len is None:
        last = x[:, -1:]
        pos = torch.tensor(s, dtype=torch.int32, device=x.device)
    else:
        last = x.index_select(1, (valid_len - 1).to(torch.int64).view(1))
        pos = valid_len.to(torch.int32).clone()
    h = L.norm_full(model.final_norm, last)
    logits = engine.linear(model.lm_head, h, "prefill")[:, 0]
    caches = {"pos": pos, "blocks": states}
    if cfg.rope:
        caches["rope"] = (orp.init_state(_rope_dim(cfg), cfg.rope_base, pos=s,
                                         device=x.device)
                          if valid_len is None else _rope_state(cfg, pos))
    return logits, caches


def _block_chunk(p, x, cfg, engine, cache, pos: torch.Tensor, sin, cos):
    """One chunked-prefill block: [B, C] tokens continuing a warm cache at
    absolute position ``pos`` -> (x_out, cache).  The MMM-shaped sibling of
    `_block_decode`: the same cache in, cache out, C tokens at once through
    the prefill dataflow."""
    xs, sig = L.norm_emit(p.ln1, x, engine)
    if isinstance(p, RetNetBlock):
        y, cache = R.retention_apply(p.ret, xs, sig, engine, "prefill", cfg,
                                     rope_sin=sin, rope_cos=cos, cache=cache)
    else:
        chunk = L.mla_chunk if cfg.attn_type == "mla" else L.gqa_chunk
        y, cache = chunk(p.attn, xs, sig, engine, cfg, cache, pos,
                         rope_sin=sin, rope_cos=cos)
    x = x + y
    xs2, sig2 = L.norm_emit(p.ln2, x, engine)
    return x + M.mlp_apply(p.mlp, xs2, sig2, engine, "prefill"), cache


def _chunk_stack(model: LM, tokens: torch.Tensor, cache: dict, cfg: ModelConfig,
                 engine: HSAEngine) -> tuple[torch.Tensor, dict]:
    """Run [B, C] tokens against a warm cache -> (pre-final-norm activations
    [B, C, D], advanced cache).  Positions, RoPE tables and the new
    position come from the device scalar ``cache["pos"]``."""
    _check_family(cfg)
    x = _embed(model, tokens)
    c = x.shape[1]
    pos0 = cache["pos"]
    sin, cos = _rope_tables(cfg, c, x.device, start=pos0)
    new_cache = {"pos": pos0 + c}
    if cfg.rope:
        new_cache["rope"] = _rope_state(cfg, new_cache["pos"])
    states = []
    for blk, cl in zip(model.blocks, cache["blocks"]):
        y, c2 = _block_chunk(blk, x, cfg, engine, cl, pos0, sin, cos)
        x = y.to(x.dtype)
        states.append(c2)
    new_cache["blocks"] = states
    return x, new_cache


def forward_prefill_chunk(model: LM, tokens: torch.Tensor, cache: dict,
                          cfg: ModelConfig, engine: HSAEngine
                          ) -> tuple[torch.Tensor, dict]:
    """Chunked prefill (MMM phase over a warm cache): tokens [B, C] continue
    ``cache`` at absolute positions ``cache["pos"] .. + C - 1`` -> (last-token
    logits [B, V], advanced cache).  Chunks are exact, never padded, so the
    RetNet state needs no correction.  Dense K/V rows are written into the
    cache's leaves in place."""
    x, new_cache = _chunk_stack(model, tokens, cache, cfg, engine)
    h = L.norm_full(model.final_norm, x[:, -1:])
    logits = engine.linear(model.lm_head, h, "prefill")[:, 0]
    return logits, new_cache


def forward_decode(model: LM, tokens: torch.Tensor, cache: dict,
                   cfg: ModelConfig, engine: HSAEngine
                   ) -> tuple[torch.Tensor, dict]:
    """One generation step (MVM phase): tokens [B, 1] -> (logits [B, V], cache).

    ``cache["pos"]`` is a shared scalar or per-lane ``[B]`` (see the module
    docstring); every lane advances by one."""
    x = _embed(model, tokens)
    pos = cache["pos"]
    new_cache = {"pos": pos + 1}
    sin = cos = None
    if cfg.rope:
        st = cache["rope"]
        sin, cos = st.sin, st.cos                          # C4 Embed mode
        th = _thetas(_rope_dim(cfg), cfg.rope_base, x.device)
        new_cache["rope"] = orp.advance(st, th)            # C4 Update mode
    states = []
    for blk, c in zip(model.blocks, cache["blocks"]):
        y, c2 = _block_decode(blk, x, cfg, engine, c, pos, sin, cos)
        x = y.to(x.dtype)
        states.append(c2)
    new_cache["blocks"] = states
    h = L.norm_full(model.final_norm, x)
    logits = engine.linear(model.lm_head, h, "decode")[:, 0]
    return logits, new_cache


def make_decode_cache(cfg: ModelConfig, batch: int, cache_len: int = 0, *,
                      dtype=torch.bfloat16, start_pos: int = 0,
                      device="cuda", per_lane: bool = False) -> dict:
    """Cold cache at ``start_pos`` (zeros are the exact initial state of
    every cache kind), with ``cache_len`` KV slots per layer for dense GQA
    and MLA.
    The reference's decode-only dry-run default (pos = cache_len - 1) is not
    ported: pass ``start_pos`` for it.

    ``dtype`` is a torch dtype or a kvq format name: KV leaves then start as
    encoded zero dicts; RetNet state stays f32.  ``per_lane`` gives every
    lane its own position (``pos`` int32 ``[batch]``, rope angles
    ``[batch, d/2]``), as a scheduler's slot class holds them."""
    _check_family(cfg)
    pos = torch.tensor(start_pos, dtype=torch.int32, device=device)
    if per_lane:
        pos = pos.repeat(batch)
    if cfg.family == "retnet":
        blocks = [R.retention_make_cache(cfg, batch, device)
                  for _ in range(cfg.n_layers)]
    else:
        make = L.mla_make_cache if cfg.attn_type == "mla" else L.gqa_make_cache
        blocks = [make(cfg, batch, cache_len, dtype, device) for _ in range(cfg.n_layers)]
    caches = {"pos": pos, "blocks": blocks}
    if cfg.rope:
        caches["rope"] = (_rope_state(cfg, pos) if per_lane else
                          orp.init_state(_rope_dim(cfg), cfg.rope_base, pos=start_pos,
                                         device=device))
    return caches


def quantize_cache(cache: dict, cfg: ModelConfig, fmt: str) -> dict:
    """Encode the KV leaves (MLA: the latent and the rope key) of a warm
    decode cache into ``fmt``.

    The bridge between prefill (always f32) and a quantized decode
    residency: the engine calls it once, right after `forward_prefill`.
    RetNet state, ``pos`` and the rope angles pass through; encoded leaves
    pass through unchanged.  The reference runs this step eagerly, so
    int8_tok scales take the division form (see `core/kvq.py`)."""
    kvq.check_format(fmt)
    out = dict(cache)
    if cfg.family != "retnet":
        out["blocks"] = [{name: kvq.encode(leaf, fmt) for name, leaf in b.items()}
                         for b in cache["blocks"]]
    return out
