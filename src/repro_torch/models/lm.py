"""Decoder LM and encoder-decoder assembly: the ``retnet``, ``dense``,
``moe``, ``ssm``, ``hybrid``, ``enc`` and ``dec`` kinds of the reference's
`models/lm.py`, dense and MoE with GQA or MLA attention.

Per-layer modules in an ``nn.ModuleList`` and a Python loop take the place of
the reference's ``lax.scan`` over stacked params; the residual stream is cast
back to the param dtype after every block, as the scan carry is there.

    forward_prefill       — full prompt (MMM phase), exact or bucketed:
                            last-token logits + warm cache
    forward_prefill_chunk — one chunk of a prompt over a warm cache (MMM)
    forward_verify_chunk  — a speculative block over a warm cache (MMM):
                            logits at every position, rolled back to the
                            accepted prefix by `commit_verified_cache`
    forward_decode        — one token with the warm cache (MVM phase)
    mtp_decode_step       — one depth step of deepseek-v3's multi-token-
                            prediction head (the speculative MTP drafter)
    forward_train         — teacher-forced loss over the padded vocab, each
                            block rematerialized in backward (retnet and
                            the dense family; `train_leaves` names the
                            masters a step updates)

and the shared-prefix helpers `serving/paging.py` builds on
(`prefix_sharing_mode`, `slice_cache_rows`, `assemble_prefix_cache`).

Layers come in the reference's groups (`layer_groups`), held in one flat
list in group order: deepseek-v3's leading dense layers (``dense_head``),
then its MoE layers.  A ``moe`` block (olmoe, deepseek-v3) is a dense
block whose MLP is the routed MoE (`models/mlp.py`): the tokens of one
forward share a dispatch (each lane alone under ``per_lane``), and a
speculative verify block's dispatch never drops (``no_drop``).  An ``ssm`` block (falcon-mamba) is a pre-norm Mamba mixer
(`models/ssm.py`); a ``hybrid`` block (hymba) runs GQA attention over a
sliding-window ring and a Mamba mixer side by side on the same normed input,
averages their normed outputs, then an MLP.  Hymba's first, middle and last
layers attend to the whole prompt in prefill (`hybrid_full_attn_flags`);
their decode cache is the same ring, as in the reference.

An encoder-decoder (seamless-m4t-medium, ``cfg.is_encdec``) keeps its
encoder layers (``enc`` blocks: a dense block with non-causal attention and
no cache) in `LM.enc_blocks` with ``enc_final_norm``, and its decoder
layers (``dec`` blocks: a dense block with a cross-attention between its
self-attention and its MLP) in `LM.blocks`.  Prefill takes the frames
(``src_embeds`` [B, T, D], `models/frontends.py`) through `_encode`; each
decoder layer projects the encoder output to its cross K/V once and keeps
them in its cache, which decode reads through flash-decode at ``kv_len`` =
T every step.  Positions are sinusoidal (``abs_pos_embed``), added to the
frames, the prompt and, at the device position, each decoded token.  A
vision model (llava-next-34b, the ``vlm`` family) is a dense decoder whose
prefill takes the frontend stub's patch embeddings (``patch_embeds`` [B, P,
D]) in place of its prompt's first P token embeddings (`_embed`).

The decode cache is ``{"pos": i32 scalar, "rope": OnlineRopeState, "blocks":
[one per layer]}``: ``{"s": f32 [B, H, dk, dv]}`` for RetNet, ``{"k", "v"}``
``[B, C, KV, hd]`` leaves for dense GQA (C = the window for a ring;
``{"self": {"k", "v"}, "cross_k", "cross_v"}`` for a decoder layer, the cross
leaves ``[B, T, KV, hd]``),
``{"c_kv" [B, C, kv_lora_rank], "k_rope" [B, C, qk_rope_head_dim]}`` for MLA
(plain tensors or kvq-encoded dicts), ``{"h" f32 [B, d_inner, state], "conv"
f32 [B, conv_width - 1, d_inner]}`` for an SSM block and ``{"attn": {"k",
"v"}, "mamba": {"h", "conv"}}`` for a hybrid one.
The position lives on the device, as the reference's traced scalar does: no
host integer that changes from step to step reaches a kernel, a shape or a
branch of `forward_decode`, so one captured step replays at every position
(`serving/engine.py`).  ``pos`` is an int32 scalar shared by the batch, or
an int32 ``[B]`` vector with one position per lane (``make_decode_cache(...,
per_lane=True)``: a scheduler's slot class, the port's counterpart of the
reference's per-slot scalar under ``vmap``); the rope angles, the slots
written and flash-decode's ``kv_len`` then follow each lane's own.  Dense decode writes each new K/V row into the cache
in place (`layers.cache_update`).

A config with ``cfg.mtp`` (deepseek-v3) carries the multi-token-prediction
head, `MTPHead`: ``proj`` (2 d_model -> d_model) and one block of the
family's kind (a `MoEBlock` on deepseek-v3, with MLA and the shared
expert).  Plain generation never reads it; the speculative MTP drafter
chains it (`mtp_decode_step`).  A model norms with RMSNorm, or with
LayerNorm (starcoder2; its MLP is then ungated GeLU), as its norms' biases
say (`modules.Norm`).
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as _checkpoint

from repro_torch.core import kvq
from repro_torch.core import online_rope as orp
from repro_torch.core.hsa import HSAEngine
from repro_torch.kernels import ops
from repro_torch.models import deploy
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.models import retnet as R
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import MLA, Attention, Init, Linear, Norm


def layer_groups(cfg: ModelConfig) -> list[tuple[str, int, str]]:
    """The reference's homogeneous runs of layers, in order, as ``(name,
    count, kind)``, for the families the port serves: a MoE model's
    ``first_dense_layers`` form ``dense_head`` ahead of its MoE ``blocks``."""
    if cfg.family == "moe" and cfg.first_dense_layers:
        dense = min(cfg.first_dense_layers, cfg.n_layers)
        return [("dense_head", dense, "dense"), ("blocks", cfg.n_layers - dense, "moe")]
    if cfg.is_encdec:
        return [("enc_blocks", cfg.encoder_layers, "enc"), ("blocks", cfg.n_layers, "dec")]
    kind = cfg.family if cfg.family in ("retnet", "ssm", "hybrid", "moe") else "dense"
    return [("blocks", cfg.n_layers, kind)]


def block_groups(cfg: ModelConfig) -> list[tuple[str, int, str]]:
    """The groups whose layers are `LM.blocks` and hold decode caches: every
    group but an encoder's."""
    return [g for g in layer_groups(cfg) if g[2] != "enc"]


def hybrid_full_attn_flags(cfg: ModelConfig, count: int) -> list[bool]:
    """Hymba: full attention on the first, middle and last layer of a
    group, the sliding window elsewhere."""
    return [i in (0, count // 2, count - 1) for i in range(count)]


def _check_family(cfg: ModelConfig) -> None:
    """Raise, naming what is missing, unless the port serves ``cfg``: the
    encoder-decoder (the ``audio`` family, its frames from the frontend
    stub, sinusoidal positions) and a decoder-only model with a ``vision``
    frontend (the ``vlm`` family: patch embeddings over the prompt's head)
    are served; any other frontend is not."""
    if cfg.family in ("retnet", "ssm"):
        return
    if cfg.family not in ("dense", "hybrid", "moe", "audio", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; repro_torch serves "
            f"retnet, dense, moe, ssm, hybrid, vlm and the encoder-decoder")
    encdec = cfg.is_encdec
    frontend = "audio" if encdec else "vision"
    missing = [what for what, present in (
        (f"norm_type {cfg.norm_type!r}", cfg.norm_type not in ("rmsnorm", "layernorm")),
        (f"frontend {cfg.frontend!r}", cfg.frontend not in (None, frontend)),
        ("absolute position embeddings without an encoder", cfg.abs_pos_embed and not encdec),
        (f"attn_type {cfg.attn_type!r}",
         cfg.attn_type not in (("gqa",) if encdec else ("gqa", "mla"))))
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
    MLP, gated (SiLU) for RMSNorm archs, ungated GeLU for LayerNorm ones."""

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


class MoEBlock(nn.Module):
    """Pre-norm attention (GQA, or MLA for ``attn_type == "mla"``) then the
    routed MoE (olmoe; deepseek-v3 past its dense head, with its shared
    expert)."""

    def __init__(self, ln1: Norm, attn: Attention | MLA, ln2: Norm, moe: M.MoE):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.moe = ln1, attn, ln2, moe

    @classmethod
    def init(cls, init: Init, cfg: ModelConfig) -> "MoEBlock":
        ln1 = L.norm_init(init, cfg.d_model, cfg)
        attn = L.mla_init(init, cfg) if cfg.attn_type == "mla" else L.gqa_init(init, cfg)
        return cls(ln1, attn, L.norm_init(init, cfg.d_model, cfg), M.MoE.init(init, cfg))


class SSMBlock(nn.Module):
    """Pre-norm Mamba mixer, no MLP (falcon-mamba)."""

    def __init__(self, ln1: Norm, mamba: S.Mamba):
        super().__init__()
        self.ln1, self.mamba = ln1, mamba

    @classmethod
    def init(cls, init: Init, cfg: ModelConfig) -> "SSMBlock":
        return cls(L.norm_init(init, cfg.d_model, cfg), S.mamba_init(init, cfg))


class HybridBlock(nn.Module):
    """Hymba: GQA attention and a Mamba mixer on the same normed input, each
    output normed (``attn_norm``, ``mamba_norm``) and averaged, then a gated
    MLP.  ``full_attn`` (a layer flag, `hybrid_full_attn_flags`) widens the
    attention's window to the whole prompt in prefill."""

    def __init__(self, ln1: Norm, attn: Attention, mamba: S.Mamba, attn_norm: Norm,
                 mamba_norm: Norm, ln2: Norm, mlp: M.MLP, full_attn: bool = False):
        super().__init__()
        self.ln1, self.attn, self.mamba = ln1, attn, mamba
        self.attn_norm, self.mamba_norm, self.ln2, self.mlp = attn_norm, mamba_norm, ln2, mlp
        self.full_attn = full_attn

    @classmethod
    def init(cls, init: Init, cfg: ModelConfig) -> "HybridBlock":
        d = cfg.d_model
        return cls(L.norm_init(init, d, cfg), L.gqa_init(init, cfg), S.mamba_init(init, cfg),
                   L.norm_init(init, d, cfg), L.norm_init(init, d, cfg),
                   L.norm_init(init, d, cfg), M.MLP.init(init, d, cfg.d_ff))


class EncoderBlock(DenseBlock):
    """An encoder layer: a dense block whose attention is non-causal and
    keeps no cache."""


class DecoderBlock(nn.Module):
    """A decoder layer of an encoder-decoder: pre-norm causal self-attention,
    then pre-norm (``ln_cross``) cross-attention (``cross``: its ``wq`` on
    the decoder stream, ``wk`` / ``wv`` on the encoder output), then the MLP."""

    def __init__(self, ln1: Norm, attn: Attention, ln_cross: Norm, cross: Attention,
                 ln2: Norm, mlp: M.MLP):
        super().__init__()
        self.ln1, self.attn, self.ln_cross, self.cross = ln1, attn, ln_cross, cross
        self.ln2, self.mlp = ln2, mlp

    @classmethod
    def init(cls, init: Init, cfg: ModelConfig) -> "DecoderBlock":
        d = cfg.d_model
        return cls(L.norm_init(init, d, cfg), L.gqa_init(init, cfg), L.norm_init(init, d, cfg),
                   L.gqa_init(init, cfg), L.norm_init(init, d, cfg),
                   M.MLP.init(init, d, cfg.d_ff, gated=cfg.norm_type == "rmsnorm"))


BLOCK_KINDS = {"retnet": RetNetBlock, "dense": DenseBlock, "moe": MoEBlock,
               "ssm": SSMBlock, "hybrid": HybridBlock, "enc": EncoderBlock,
               "dec": DecoderBlock}


class MTPHead(nn.Module):
    """deepseek-v3's depth-1 multi-token-prediction head: ``proj`` [2 D, D]
    over ``[h ; embed(tok)]``, then one block, a `MoEBlock` for the ``moe``
    family and a `DenseBlock` otherwise (the reference's ``mtp`` subtree)."""

    def __init__(self, proj: Linear, block: nn.Module):
        super().__init__()
        self.proj, self.block = proj, block

    @classmethod
    def init(cls, init: Init, cfg: ModelConfig) -> "MTPHead":
        proj = Linear.init(init, 2 * cfg.d_model, cfg.d_model)
        kind = "moe" if cfg.family == "moe" else "dense"
        return cls(proj, BLOCK_KINDS[kind].init(init, cfg))


def mark_full_attn(cfg: ModelConfig, blocks: list[nn.Module]) -> None:
    """Set each hybrid block's ``full_attn`` from its place in its group."""
    at = 0
    for _, count, kind in block_groups(cfg):
        if kind == "hybrid":
            for blk, flag in zip(blocks[at:at + count], hybrid_full_attn_flags(cfg, count)):
                blk.full_attn = flag
        at += count


class LM(nn.Module):
    """The embedding, the decoder (or only) stack ``blocks``, the final norm
    and the LM head; an encoder-decoder's encoder stack ``enc_blocks`` and
    its ``enc_final_norm``; deepseek-v3's ``mtp`` head."""

    def __init__(self, embed: torch.Tensor, blocks: list[nn.Module],
                 final_norm: Norm, lm_head: Linear, mtp: MTPHead | None = None, *,
                 enc_blocks: list[nn.Module] = (), enc_final_norm: Norm | None = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        self.lm_head = lm_head
        self.mtp = mtp
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.enc_final_norm = enc_final_norm


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda", deployed: bool = False) -> LM:
    """Seeded random weights in ``cfg.param_dtype`` on ``device``, drawn in
    the reference's order: the layer groups (an encoder's first), the final
    norm (then an encoder's), the LM head, and the MTP head when
    ``cfg.mtp``.

    ``deployed`` PTQ-deploys each block (`deploy.deploy_quantize`) as soon
    as its masters are drawn, and the rest of the model at the end: the
    random numbers are drawn in the same order and deploy draws none, so
    the bytes equal those of the whole init followed by deploy, while at
    most one block's masters are held at a time (llava-next-34b's bf16
    masters alone would fill most of an 80 GB card)."""
    _check_family(cfg)
    ini = Init.from_seed(seed, device, getattr(torch, cfg.param_dtype))
    ready = deploy.deploy_quantize if deployed else (lambda blk: blk)
    embed = ini.normal((cfg.padded_vocab, cfg.d_model), 0.02)
    layers = {gname: [ready(BLOCK_KINDS[kind].init(ini, cfg)) for _ in range(count)]
              for gname, count, kind in layer_groups(cfg)}
    blocks = [blk for gname, _, _ in block_groups(cfg) for blk in layers[gname]]
    mark_full_attn(cfg, blocks)
    final_norm = L.norm_init(ini, cfg.d_model, cfg)
    enc_final_norm = L.norm_init(ini, cfg.d_model, cfg) if cfg.is_encdec else None
    lm_head = Linear.init(ini, cfg.d_model, cfg.padded_vocab, scale=0.02)
    mtp = MTPHead.init(ini, cfg) if cfg.mtp else None
    return ready(LM(embed, blocks, final_norm, lm_head, mtp,
                    enc_blocks=layers.get("enc_blocks", ()), enc_final_norm=enc_final_norm))


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
    ``start`` may be an int32 scalar on the device (a chunk's position), or
    an int32 ``[B]`` vector (each lane's own), which gives ``[B, s, d/2]``."""
    if not cfg.rope:
        return None, None
    th = _thetas(_rope_dim(cfg), cfg.rope_base, device)
    if isinstance(start, torch.Tensor) and start.ndim == 1:
        start = start[:, None]
    return orp.rope_table(start + torch.arange(s, device=device), th)


def _rope_state(cfg: ModelConfig, pos: torch.Tensor) -> orp.OnlineRopeState:
    """The online RoPE unit's angle memory at ``pos``, an int32 scalar on the
    device (`orp.init_state` at a position that is not a host int).  It
    keeps its own copy of ``pos``: a decode step updates a cache's
    position and its rope state in place, one after the other."""
    sin, cos = orp.rope_table(pos, _thetas(_rope_dim(cfg), cfg.rope_base, pos.device))
    return orp.OnlineRopeState(sin=sin, cos=cos, pos=pos.clone())


def _embed(model: LM, tokens: torch.Tensor, cfg: ModelConfig, start=0,
           patch_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Token embeddings ``[B, S, D]``; a ``vision`` frontend's
    ``patch_embeds`` ``[B, P, D]`` (P <= S), cast to the embedding's dtype,
    take the place of the first P rows, as the reference splices them (any
    other model ignores them, as the reference does); with
    ``abs_pos_embed``, plus the sinusoid at positions ``start .. start + S -
    1`` (``start`` an int, an int32 device scalar, or ``[B]`` with each
    lane's own), cast to the embedding's dtype as the reference adds it."""
    x = model.embed[tokens]
    if patch_embeds is not None and cfg.frontend == "vision":
        p = patch_embeds.to(x.dtype)
        if p.shape[1] > x.shape[1]:
            raise ValueError(f"{p.shape[1]} patch embeddings do not fit a prompt of "
                             f"{x.shape[1]} tokens")
        x = torch.cat([p, x[:, p.shape[1]:]], dim=1)
    if cfg.abs_pos_embed:
        pos = L._lanes(start) + torch.arange(tokens.shape[1], device=x.device)
        x = x + _sinusoidal(pos, cfg.d_model).to(x.dtype)
    return x


@functools.lru_cache(maxsize=None)
def _sin_denoms(d: int, device: torch.device) -> torch.Tensor:
    """``10000 ** (2 i / d)`` for i < d / 2 in f32, computed once per (d,
    device) (a captured decode step must copy nothing to the card).  The
    exponent is the reference's f32 ``2 i / d``; the power is taken in f64
    and rounded, which gives XLA's f32 ``power`` bit for bit where torch's
    f32 ``pow`` is one ulp off at some i (d 1024).  Callers must not modify
    it."""
    e = 2 * torch.arange(d // 2, dtype=torch.float32, device=device) / d
    return torch.pow(10000.0, e.double()).float()


def _sinusoidal(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal absolute position embeddings ``[..., d]`` (f32) of the
    integer positions ``pos`` (on the device; a decode step's come from the
    cache): ``[sin(pos / den) | cos(pos / den)]``, as the reference's."""
    ang = pos.to(torch.float32)[..., None] / _sin_denoms(d, pos.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _seed_attn_cache(cfg: ModelConfig, leaves: dict, cache_len: int = 0,
                     valid_len: torch.Tensor | None = None) -> dict:
    """Prefill K/V (or MLA's latents) -> the decode cache layout.

    A linear cache's leaves ``[B, S, ...]`` are right-padded with zeros along
    the slot axis to ``cache_len`` so generation can continue (a bucketed
    prefill keeps its padded tail: decode masks it, then overwrites it).  A
    sliding-window ring holds position p in slot ``p % window``: a prompt
    that fits is padded up to the window, a longer one keeps its last
    ``window`` positions, rolled into their slots.  ``valid_len`` (an int32
    device scalar: a bucketed prefill) builds the ring from the real
    positions only, slot i taking the largest real position congruent to i
    (a device gather; padded keys would alias live slots once the ring
    wraps)."""
    w = cfg.sliding_window
    out = {}
    for name, x in leaves.items():
        s = x.shape[1]
        if w and valid_len is not None:
            i = torch.arange(w, device=x.device)
            p = i + w * torch.div(valid_len - 1 - i, w, rounding_mode="floor")
            keep = (p >= 0).reshape(1, w, *([1] * (x.ndim - 2)))
            x = torch.where(keep, x.index_select(1, p.clamp(0, s - 1)), 0.0)
        elif w and s <= w:
            x = torch.nn.functional.pad(x, (0, 0) * (x.ndim - 2) + (0, w - s))
        elif w:
            x = torch.roll(x[:, -w:], s % w, dims=1)
        elif cache_len > s:
            x = torch.nn.functional.pad(x, (0, 0) * (x.ndim - 2) + (0, cache_len - s))
        out[name] = x
    return out


def _block_apply(p, x, cfg, engine, phase, sin, cos, cache_len: int = 0,
                 valid_len=None, enc_out=None):
    """Full-sequence block -> (x_out, cache seed).

    ``valid_len`` (bucketed prefill) marks the tokens from it on as padding:
    causality keeps them out of every real token's output, and the RetNet,
    Mamba and ring cache seeds mask them; a linear KV cache keeps its padded
    tail, which decode masks and then overwrites.  An encoder block attends
    non-causally and seeds no cache (None); a decoder block reads the
    encoder's final-normed output ``enc_out`` and seeds ``{"self",
    "cross_k", "cross_v"}``."""
    xs, sig = L.norm_emit(p.ln1, x, engine)
    if isinstance(p, SSMBlock):
        y, cache = S.mamba_apply(p.mamba, xs, sig, engine, phase, cfg, valid_len=valid_len)
        return x + y, cache
    if isinstance(p, HybridBlock):
        s = x.shape[1]
        a_out, (k, v) = L.gqa_apply(p.attn, xs, sig, engine, phase, cfg,
                                    window=s if p.full_attn else cfg.sliding_window,
                                    rope_sin=sin, rope_cos=cos)
        m_out, m_cache = S.mamba_apply(p.mamba, xs, sig, engine, phase, cfg,
                                       valid_len=valid_len)
        cache = {"attn": _seed_attn_cache(cfg, {"k": k, "v": v}, cache_len, valid_len),
                 "mamba": m_cache}
        return _hybrid_tail(p, x, a_out, m_out, engine, phase), cache
    if isinstance(p, RetNetBlock):
        y, cache = R.retention_apply(p.ret, xs, sig, engine, phase, cfg,
                                     rope_sin=sin, rope_cos=cos, valid_len=valid_len)
    elif cfg.attn_type == "mla":
        y, (c_kv, k_rope) = L.mla_apply(p.attn, xs, sig, engine, phase, cfg,
                                        rope_sin=sin, rope_cos=cos)
        cache = _seed_attn_cache(cfg, {"c_kv": c_kv, "k_rope": k_rope}, cache_len)
    else:
        causal = not isinstance(p, EncoderBlock)
        y, (k, v) = L.gqa_apply(p.attn, xs, sig, engine, phase, cfg, causal=causal,
                                window=cfg.sliding_window, rope_sin=sin, rope_cos=cos)
        cache = (_seed_attn_cache(cfg, {"k": k, "v": v}, cache_len, valid_len)
                 if causal else None)
    x = x + y
    if isinstance(p, DecoderBlock):
        if enc_out is None:
            raise TypeError("decoder blocks need encoder output")
        xc, sigc = L.norm_emit(p.ln_cross, x, engine)
        c_out, (ck, cv) = _cross_from_enc(p.cross, xc, sigc, engine, phase, cfg, enc_out)
        x = x + c_out
        cache = {"self": cache, "cross_k": ck, "cross_v": cv}
    xs2, sig2 = L.norm_emit(p.ln2, x, engine)
    return x + _ffn(p, xs2, sig2, engine, phase, cfg), cache


def _cross_from_enc(p: Attention, xc, sigc, engine, phase: str, cfg: ModelConfig, enc_out):
    """Cross-attention over the whole encoder output: q from the decoder
    stream (its sigma^-1 as ``row_scale``), K/V projected from ``enc_out``
    (already normed: no ``row_scale``) -> (out, (k, v) ``[B, T, KV, hd]``)."""
    b, t, _ = enc_out.shape
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    k = engine.linear(p.wk, enc_out, phase).reshape(b, t, kv, hd)
    v = engine.linear(p.wv, enc_out, phase).reshape(b, t, kv, hd)
    out, _ = L.gqa_apply(p, xc, sigc, engine, phase, cfg, causal=False, kv_override=(k, v))
    return out, (k, v)


@functools.lru_cache(maxsize=None)
def _full_len(c: int, device: torch.device) -> torch.Tensor:
    """``c`` as an int32 scalar on ``device``, made once per (c, device):
    a cross cache's ``kv_len``, its capacity, inside a captured decode step
    (which must copy nothing to the card).  Callers must not modify it."""
    return torch.tensor(c, dtype=torch.int32, device=device)


def _cross_decode(p: Attention, xc, sigc, engine, cfg: ModelConfig, cache: dict):
    """One decode step's cross-attention: ``wq`` (in the decode format, its
    sigma^-1 as ``row_scale``), flash-decode over the cross cache at
    ``kv_len`` = its capacity (every frame is valid), then ``wo``."""
    b = xc.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = engine.linear(p.wq, xc, "decode", row_scale=sigc).reshape(b, kv, h // kv, hd)
    k, v = cache["cross_k"], cache["cross_v"]
    kv_len = _full_len(L.cache_capacity(k), xc.device)
    out = ops.flash_decode(q, k, v, kv_len, impl=engine.config.kernel_impl)
    return engine.linear(p.wo, out.reshape(b, 1, h * hd), "decode")


def _ffn(p, xs, sig, engine, phase: str, cfg: ModelConfig, no_drop: bool = False):
    """A dense or MoE block's feed-forward on its normed input."""
    if isinstance(p, MoEBlock):
        return M.moe_apply(p.moe, xs, sig, engine, phase, cfg, no_drop=no_drop)
    return M.mlp_apply(p.mlp, xs, sig, engine, phase)


def _hybrid_tail(p: HybridBlock, x, a_out, m_out, engine, phase: str):
    """A hybrid block after its two mixers: the mean of their normed
    outputs joins the residual, then the MLP."""
    x = x + 0.5 * (L.norm_full(p.attn_norm, a_out) + L.norm_full(p.mamba_norm, m_out))
    xs2, sig2 = L.norm_emit(p.ln2, x, engine)
    return x + M.mlp_apply(p.mlp, xs2, sig2, engine, phase)


def _block_decode(p, x, cfg, engine, cache, pos: torch.Tensor, sin, cos):
    """One-token block at absolute position ``pos`` -> (x_out, cache)."""
    xs, sig = L.norm_emit(p.ln1, x, engine)
    if isinstance(p, SSMBlock):
        y, cache = S.mamba_decode(p.mamba, xs, sig, engine, cfg, cache)
        return x + y, cache
    if isinstance(p, HybridBlock):
        a_out, a_cache = L.gqa_decode(p.attn, xs, sig, engine, cfg, cache["attn"], pos,
                                      rope_sin=sin, rope_cos=cos)
        m_out, m_cache = S.mamba_decode(p.mamba, xs, sig, engine, cfg, cache["mamba"])
        return (_hybrid_tail(p, x, a_out, m_out, engine, "decode"),
                {"attn": a_cache, "mamba": m_cache})
    if isinstance(p, RetNetBlock):
        y, cache = R.retention_decode(p.ret, xs, sig, engine, cfg, cache,
                                      rope_sin=sin, rope_cos=cos)
    elif isinstance(p, DecoderBlock):
        y, self_cache = L.gqa_decode(p.attn, xs, sig, engine, cfg, cache["self"], pos,
                                     rope_sin=sin, rope_cos=cos)
        x = x + y
        xc, sigc = L.norm_emit(p.ln_cross, x, engine)
        y = _cross_decode(p.cross, xc, sigc, engine, cfg, cache)
        cache = {"self": self_cache, "cross_k": cache["cross_k"], "cross_v": cache["cross_v"]}
    else:
        decode = L.mla_decode if cfg.attn_type == "mla" else L.gqa_decode
        y, cache = decode(p.attn, xs, sig, engine, cfg, cache, pos,
                          rope_sin=sin, rope_cos=cos)
    x = x + y
    xs2, sig2 = L.norm_emit(p.ln2, x, engine)
    return x + _ffn(p, xs2, sig2, engine, "decode", cfg), cache


def _frames_in(model: LM, src_embeds: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The encoder's input: the frames ``[B, T, D]`` in the param dtype plus
    their sinusoid."""
    x = src_embeds.to(model.embed.dtype)
    return x + _sinusoidal(torch.arange(x.shape[1], device=x.device), cfg.d_model).to(x.dtype)


def _encode(model: LM, src_embeds: torch.Tensor, cfg: ModelConfig,
            engine: HSAEngine) -> torch.Tensor:
    """The encoder (prefill format): `_frames_in`, the encoder blocks, then
    ``enc_final_norm`` -> ``[B, T, D]``."""
    x = _frames_in(model, src_embeds, cfg)
    for blk in model.enc_blocks:
        x = _block_apply(blk, x, cfg, engine, "prefill", None, None)[0].to(x.dtype)
    return L.norm_full(model.enc_final_norm, x)


def forward_prefill(model: LM, tokens: torch.Tensor, cfg: ModelConfig,
                    engine: HSAEngine, cache_len: int = 0,
                    valid_len: torch.Tensor | None = None, *,
                    return_hidden: bool = False,
                    src_embeds: torch.Tensor | None = None,
                    patch_embeds: torch.Tensor | None = None) -> tuple:
    """Prompt processing (MMM phase): tokens [B, S] -> (logits [B, V], cache).

    ``cache_len`` > S reserves KV slots for the tokens decode will append.
    ``return_hidden`` appends the pre-final-norm hidden state of the last
    real token ([B, D], the residual stream's dtype) to the return: the MTP
    drafter chains its head from it.  An encoder-decoder takes the frames
    ``src_embeds`` [B, T, D]: the encoder runs once, and every decoder
    layer's cache holds its cross K/V over the T frames.  A ``vision``
    frontend's ``patch_embeds`` [B, P, D] replace the embeddings of the
    prompt's first P tokens (`_embed`); RoPE positions run 0 .. S - 1 over
    patches and text alike, and decode never sees the patches again.

    Bucketed mode: ``valid_len`` (an int32 scalar on the device) marks
    ``tokens`` as a prompt of that length right-padded to S.  The logits are
    taken at the last real token, and the cache's ``pos`` and RoPE state
    start there (see `_block_apply` for the cache seeds).  An
    encoder-decoder prefills at exact length only, as the reference's."""
    _check_family(cfg)
    enc_out = None
    if cfg.is_encdec:
        if valid_len is not None:
            raise NotImplementedError("bucketed prefill: encoder-decoder models "
                                      "prefill at exact length")
        if src_embeds is None:
            raise TypeError("decoder blocks need encoder output: pass src_embeds")
        enc_out = _encode(model, src_embeds, cfg, engine)
    x = _embed(model, tokens, cfg, patch_embeds=patch_embeds)
    s = tokens.shape[1]
    sin, cos = _rope_tables(cfg, s, x.device)
    states = []
    for blk in model.blocks:
        y, cache = _block_apply(blk, x, cfg, engine, "prefill", sin, cos, cache_len,
                                valid_len=valid_len, enc_out=enc_out)
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
    if return_hidden:
        return logits, caches, last[:, 0]
    return logits, caches


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

# The families `forward_train` ports (ROADMAP A13); the rest wait for A13b.
TRAIN_FAMILIES = ("retnet", "dense")


def check_train(cfg: ModelConfig) -> None:
    """Raise, naming ROADMAP A13b, unless `forward_train` ports ``cfg``:
    retnet and the dense family (RMSNorm or LayerNorm GQA, no frontend),
    without deepseek-v3's multi-token-prediction loss."""
    missing = [what for what, present in (
        (f"family {cfg.family!r}", cfg.family not in TRAIN_FAMILIES),
        ("the MTP loss", cfg.mtp), (f"frontend {cfg.frontend!r}", cfg.frontend is not None),
        ("absolute position embeddings", cfg.abs_pos_embed),
        (f"attn_type {cfg.attn_type!r}", cfg.attn_type not in ("gqa", "retention")))
        if present]
    if missing:
        raise NotImplementedError(f"forward_train: {cfg.name}: {', '.join(missing)} not "
                                  "ported yet (ROADMAP A13b); repro_torch trains retnet "
                                  "and the dense family")
    _check_family(cfg)


def train_leaves(model: LM) -> dict[str, torch.Tensor]:
    """Every master tensor of ``model`` by name: the embedding, each
    linear's ``w`` and bias ``b``, each norm's gain ``g`` (and LayerNorm
    bias ``b``).  Names follow the modules (``blocks.<i>.ret.wq.w``,
    ``final_norm.g``, ``lm_head.w``), which mirror the reference's tree with
    its stacked ``[L, ...]`` block leaves cut per layer.  Deployed buffers
    are no masters and never appear; a deployed model raises."""
    if not deploy.is_master(model):
        raise ValueError("train_leaves: the model is deployed; training needs its masters")
    out = dict(model.named_parameters())
    for name, mod in model.named_modules():
        if isinstance(mod, Linear) and mod.b is not None:
            out[f"{name}.b"] = mod.b
    return out


def leaf_key(name: str) -> str:
    """The reference leaf a master belongs to: a block tensor's name with its
    layer index dropped (``blocks.3.ret.wq.w`` -> ``blocks.ret.wq.w``), since
    the reference stacks a group's layers into one ``[L, ...]`` leaf; any
    other master is its own leaf.  The optimizer and the compressor take
    this grouping as a ``{master: leaf}`` map (`leaf_groups`)."""
    parts = name.split(".")
    if parts[0] in ("blocks", "enc_blocks") and len(parts) > 2:
        return ".".join(parts[:1] + parts[2:])
    return name


def leaf_groups(names) -> dict[str, str]:
    """``{master name: its reference leaf}`` (`leaf_key`) for ``names``."""
    return {n: leaf_key(n) for n in names}


def set_trainable(model: LM, trainable: bool = True) -> dict[str, torch.Tensor]:
    """Make every master of ``model`` a leaf that takes a gradient, or, with
    ``trainable=False``, none (their gradients dropped); returns them by
    name (`train_leaves`)."""
    leaves = train_leaves(model)
    for t in leaves.values():
        t.requires_grad_(trainable)
        if not trainable:
            t.grad = None
    return leaves


def _train_block(p, x, cfg, engine, sin, cos):
    return _block_apply(p, x, cfg, engine, "train", sin, cos)[0].to(x.dtype)


def forward_train(model: LM, batch: dict, cfg: ModelConfig, engine: HSAEngine
                  ) -> tuple[torch.Tensor, dict]:
    """Teacher-forced loss: batch ``tokens`` / ``labels`` [B, S] -> (loss +
    aux, {"loss", "aux_loss", "tokens"}), as the reference's.

    Every linear runs its f32 master product (the train phase), RetNet's
    retention the chunkwise kernel with its backward kernel on the card
    (`ops.RetentionChunkwise`), dense attention `layers.FlashAttention`.
    Each block runs under non-reentrant ``torch.utils.checkpoint``, the
    counterpart of the reference's ``jax.checkpoint(nothing_saveable)``:
    its activations are recomputed in backward, so the forward of every
    block runs twice a step.  The
    embedding is ``F.embedding``, whose CUDA backward sums each row's
    cotangents in a fixed order (an indexed gather's backward accumulates
    with atomics).  There is no auxiliary loss in these families (0)."""
    check_train(cfg)
    tokens = batch["tokens"]
    x = torch.nn.functional.embedding(tokens, model.embed)
    sin, cos = _rope_tables(cfg, tokens.shape[1], x.device)
    for blk in model.blocks:
        x = _checkpoint.checkpoint(_train_block, blk, x, cfg, engine, sin, cos,
                                   use_reentrant=False)
    h = L.norm_full(model.final_norm, x)
    logits = engine.linear(model.lm_head, h, "train")
    loss, n_tok = _xent(logits, batch["labels"], cfg)
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss + aux, {"loss": loss, "aux_loss": aux, "tokens": n_tok}


def _xent(logits: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig):
    """Mean next-token cross-entropy over the padded vocab, labels below 0
    masked -> (loss, number of counted tokens), as the reference's."""
    mask = labels >= 0
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = torch.where(mask, lse - gold, 0.0)
    n = mask.sum().clamp(min=1)
    return nll.sum() / n, n


def _block_chunk(p, x, cfg, engine, cache, pos: torch.Tensor, sin, cos,
                 collect: bool = False):
    """One chunked-prefill block: [B, C] tokens continuing a warm cache at
    absolute position ``pos`` -> (x_out, cache).  The MMM-shaped sibling of
    `_block_decode`: the same cache in, cache out, C tokens at once through
    the prefill dataflow.  ``collect`` (a speculative verify block) keeps
    RetNet's and Mamba's state after every position and the rows a ring's
    writes evict (see `commit_verified_cache`), and keeps a MoE dispatch
    from dropping any assignment."""
    xs, sig = L.norm_emit(p.ln1, x, engine)
    if isinstance(p, SSMBlock):
        y, cache = S.mamba_apply(p.mamba, xs, sig, engine, "prefill", cfg, cache=cache,
                                 collect_states=collect)
        return x + y, cache
    if isinstance(p, HybridBlock):
        # A full-attention layer sees every resident position: the ring
        # bounds it to the last `window`, the degradation decode applies too.
        window = pos + x.shape[1] if p.full_attn else cfg.sliding_window
        a_out, a_cache = L.gqa_chunk(p.attn, xs, sig, engine, cfg, cache["attn"], pos,
                                     window=window, rope_sin=sin, rope_cos=cos,
                                     keep_evicted=collect)
        m_out, m_cache = S.mamba_apply(p.mamba, xs, sig, engine, "prefill", cfg,
                                       cache=cache["mamba"], collect_states=collect)
        return (_hybrid_tail(p, x, a_out, m_out, engine, "prefill"),
                {"attn": a_cache, "mamba": m_cache})
    if isinstance(p, RetNetBlock):
        y, cache = R.retention_apply(p.ret, xs, sig, engine, "prefill", cfg,
                                     rope_sin=sin, rope_cos=cos, cache=cache,
                                     collect_states=collect)
    elif cfg.attn_type == "mla":
        y, cache = L.mla_chunk(p.attn, xs, sig, engine, cfg, cache, pos,
                               rope_sin=sin, rope_cos=cos)
    else:
        y, cache = L.gqa_chunk(p.attn, xs, sig, engine, cfg, cache, pos,
                               window=cfg.sliding_window, rope_sin=sin, rope_cos=cos,
                               keep_evicted=collect)
    x = x + y
    xs2, sig2 = L.norm_emit(p.ln2, x, engine)
    # collect (a verify block): rejected drafts share the dispatch with real
    # tokens and must not evict them from expert slots.
    return x + _ffn(p, xs2, sig2, engine, "prefill", cfg, no_drop=collect), cache


def _chunk_stack(model: LM, tokens: torch.Tensor, cache: dict, cfg: ModelConfig,
                 engine: HSAEngine, collect: bool = False) -> tuple[torch.Tensor, dict]:
    """Run [B, C] tokens against a warm cache -> (pre-final-norm activations
    [B, C, D], advanced cache).  Positions, RoPE tables and the new
    position come from ``cache["pos"]`` on the device: a scalar, or ``[B]``
    with each lane at its own (a slot class, all lanes in one dispatch).
    An encoder-decoder or a frontend model prefills monolithically, as the
    reference's, so its chunks raise."""
    _check_family(cfg)
    if cfg.is_encdec:
        raise NotImplementedError("chunked prefill: encoder-decoder models "
                                  "prefill monolithically")
    if cfg.frontend:
        raise NotImplementedError("chunked prefill: frontend (vision/audio) "
                                  "prompts splice patch embeddings: prefill "
                                  "monolithically")
    x = _embed(model, tokens, cfg, start=cache["pos"])
    c = x.shape[1]
    pos0 = cache["pos"]
    sin, cos = _rope_tables(cfg, c, x.device, start=pos0)
    new_cache = {"pos": pos0 + c}
    if cfg.rope:
        new_cache["rope"] = _rope_state(cfg, new_cache["pos"])
    states = []
    for blk, cl in zip(model.blocks, cache["blocks"]):
        y, c2 = _block_chunk(blk, x, cfg, engine, cl, pos0, sin, cos, collect)
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


def forward_verify_chunk(model: LM, tokens: torch.Tensor, cache: dict,
                         cfg: ModelConfig, engine: HSAEngine
                         ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Speculative verify: score a [B, C] block (the pending token and the
    drafts) in one MMM dispatch over a warm cache -> (logits [B, C, V] at
    every position, pre-final-norm hidden [B, C, D], verified cache).

    The chunked-prefill machinery with two differences: the LM head runs at
    every position (logits[:, i] is the target distribution after block
    position i), and RetNet keeps its state after every position
    (``s_all``) so `commit_verified_cache` can roll back to exactly the
    accepted prefix.  Dense K/V rows are written in place, so the verified
    cache shares those leaves with ``cache``; ``cache["pos"]`` may be a
    scalar or per lane ``[B]``."""
    x, new_cache = _chunk_stack(model, tokens, cache, cfg, engine, collect=True)
    h = L.norm_full(model.final_norm, x)
    logits = engine.linear(model.lm_head, h, "prefill")
    return logits, x, new_cache


def commit_verified_cache(prev: dict, ver: dict, n_accept, c: int,
                          cfg: ModelConfig) -> dict:
    """Roll a verified cache back to its accepted prefix (speculative decode).

    ``ver`` is `forward_verify_chunk`'s cache after a ``c``-token block at
    ``prev["pos"]``; ``n_accept`` (an int32 device scalar, or ``[B]`` with
    each lane's own, in 1..c) is how many of those tokens were accepted:

      * linear KV / MLA latents keep the verified buffers and rewind the
        position pointer: decode's validity mask hides the rejected rows and
        the next block overwrites them;
      * a sliding-window ring gets back, in place, the rows that the
        rejected positions' writes evicted (`layers.ring_rollback`);
      * RetNet takes the state snapshot at the acceptance boundary,
        ``s_all[:, :, n_accept - 1]``, and Mamba ``h_all[:, n_accept - 1]``
        and the conv window ``conv_ext[:, n_accept : n_accept + cw - 1]``,
        gathered per lane.

    A MoE layer's cache is its attention's, so it rewinds as a dense
    layer's does.  The rope state is rebuilt at the new position on the
    device."""
    pos0 = prev["pos"]
    new_pos = (pos0 + n_accept).to(pos0.dtype)
    out = {"pos": new_pos}
    if cfg.rope:
        out["rope"] = _rope_state(cfg, new_pos)

    def lanes(t: torch.Tensor) -> torch.Tensor:
        return torch.arange(t.shape[0], device=t.device)

    def last(t: torch.Tensor) -> torch.Tensor:
        """Each lane's index of its last accepted position."""
        return (n_accept - 1).clamp(0, c - 1).to(torch.int64).expand(t.shape[0])

    def conv_window(ext: torch.Tensor) -> torch.Tensor:
        """Each lane's ``ext[:, n_accept : n_accept + cw - 1]``."""
        start = n_accept.to(torch.int64).expand(ext.shape[0])[:, None]
        return ext[lanes(ext)[:, None],
                   start + torch.arange(cfg.conv_width - 1, device=ext.device)]

    def commit(blk: dict) -> dict:
        if "s_all" in blk:                                    # [B, H, C, dk, dv]
            s_all = blk["s_all"]
            return {"s": s_all[lanes(s_all), :, last(s_all)]}
        if "h_all" in blk:                                    # [B, C, di, n]
            h_all = blk["h_all"]
            return {"h": h_all[lanes(h_all), last(h_all)], "conv": conv_window(blk["conv_ext"])}
        if "attn" in blk:
            return {"attn": commit(blk["attn"]), "mamba": commit(blk["mamba"])}
        if "k_evicted" in blk:
            return L.ring_rollback(blk, pos0, c, n_accept, cfg.sliding_window)
        return blk                                            # pointer rewind only

    out["blocks"] = [commit(blk) for blk in ver["blocks"]]
    return out


def forward_decode(model: LM, tokens: torch.Tensor, cache: dict,
                   cfg: ModelConfig, engine: HSAEngine
                   ) -> tuple[torch.Tensor, dict]:
    """One generation step (MVM phase): tokens [B, 1] -> (logits [B, V], cache).

    ``cache["pos"]`` is a shared scalar or per-lane ``[B]`` (see the module
    docstring); every lane advances by one.  With ``abs_pos_embed`` the
    token's sinusoid is computed at ``pos`` on the device."""
    pos = cache["pos"]
    x = _embed(model, tokens, cfg, start=pos)
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


def mtp_decode_step(model: LM, h: torch.Tensor, tok: torch.Tensor, cfg: ModelConfig,
                    engine: HSAEngine) -> tuple[torch.Tensor, torch.Tensor]:
    """One depth step of the MTP head at decode time (the reference's
    `mtp_decode_step`): ``h`` [B, D] is the pre-final-norm hidden at the
    last committed position (or the previous step's), ``tok`` [B] the next
    token.  ``proj`` over ``[h ; embed(tok)]`` in the decode format, the
    head's block as a full-sequence block over one position in the decode
    format, with no cache and no RoPE (a position attends only to itself,
    and same-position rotations cancel in q.k), its MoE dispatching the B
    rows together, then the final norm and the LM head.  Returns (draft
    logits [B, V], the head's hidden [B, D], f32, to chain deeper)."""
    emb = model.embed[tok].to(h.dtype)
    hx = engine.linear(model.mtp.proj, torch.cat([h, emb], dim=-1)[:, None, :], "decode")
    hx, _ = _block_apply(model.mtp.block, hx, cfg, engine, "decode", None, None)
    logits = engine.linear(model.lm_head, L.norm_full(model.final_norm, hx), "decode")[:, 0]
    return logits, hx[:, 0]


def make_decode_cache(cfg: ModelConfig, batch: int, cache_len: int = 0, *,
                      dtype=torch.bfloat16, start_pos: int = 0,
                      device="cuda", per_lane: bool = False) -> dict:
    """Cold cache at ``start_pos`` (zeros are the exact initial state of
    every cache kind), with ``cache_len`` KV slots per layer for dense GQA
    and MLA (a sliding-window ring always has ``window``; a decoder layer's
    cross leaves ``frontend_tokens`` frames, or ``cache_len`` without them).
    The reference's decode-only dry-run default (pos = cache_len - 1) is not
    ported: pass ``start_pos`` for it.

    ``dtype`` is a torch dtype or a kvq format name: KV leaves then start as
    encoded zero dicts; RetNet and Mamba state stays f32.  ``per_lane`` gives
    every lane its own position (``pos`` int32 ``[batch]``, rope angles
    ``[batch, d/2]``), as a scheduler's slot class holds them."""
    _check_family(cfg)
    pos = torch.tensor(start_pos, dtype=torch.int32, device=device)
    if per_lane:
        pos = pos.repeat(batch)

    def one_layer(kind):
        if kind == "retnet":
            return R.retention_make_cache(cfg, batch, device)
        if kind == "ssm":
            return S.mamba_make_cache(cfg, batch, device)
        if kind == "hybrid":
            return {"attn": L.gqa_make_cache(cfg, batch, cache_len, dtype, device),
                    "mamba": S.mamba_make_cache(cfg, batch, device)}
        if kind == "dec":
            shape = (batch, cfg.frontend_tokens or cache_len, cfg.n_kv_heads, cfg.head_dim_)
            return {"self": L.gqa_make_cache(cfg, batch, cache_len, dtype, device),
                    "cross_k": L.make_cache_leaf(shape, dtype, device),
                    "cross_v": L.make_cache_leaf(shape, dtype, device)}
        make = L.mla_make_cache if cfg.attn_type == "mla" else L.gqa_make_cache
        return make(cfg, batch, cache_len, dtype, device)

    blocks = [one_layer(kind) for _, count, kind in block_groups(cfg) for _ in range(count)]
    caches = {"pos": pos, "blocks": blocks}
    if cfg.rope:
        caches["rope"] = (_rope_state(cfg, pos) if per_lane else
                          orp.init_state(_rope_dim(cfg), cfg.rope_base, pos=start_pos,
                                         device=device))
    return caches


def quantize_cache(cache: dict, cfg: ModelConfig, fmt: str) -> dict:
    """Encode the KV leaves (MLA: the latent and the rope key; hybrid: its
    attention's; a decoder layer: its self and its cross leaves) of a warm
    decode cache into ``fmt``.

    The bridge between prefill (always f32) and a quantized decode
    residency: the engine calls it once, right after `forward_prefill`.
    RetNet and Mamba state, ``pos`` and the rope angles pass through (a
    cache with no KV, falcon-mamba's, is returned as it is); encoded leaves
    pass through unchanged.  The reference runs this step eagerly, so
    int8_tok scales take the division form (see `core/kvq.py`)."""
    kvq.check_format(fmt)

    def enc(blk: dict) -> dict:
        return {name: kvq.encode(leaf, fmt) for name, leaf in blk.items()}

    def one_layer(kind, blk):
        if kind in ("retnet", "ssm"):
            return blk
        if kind == "hybrid":
            return {"attn": enc(blk["attn"]), "mamba": blk["mamba"]}
        if kind == "dec":
            return {"self": enc(blk["self"]), **enc({n: blk[n] for n in ("cross_k", "cross_v")})}
        return enc(blk)

    kinds = [kind for _, count, kind in block_groups(cfg) for _ in range(count)]
    return dict(cache, blocks=[one_layer(kind, blk)
                               for kind, blk in zip(kinds, cache["blocks"])])


# ---------------------------------------------------------------------------
# Shared-prefix cache reuse (serving/paging.py builds on these).
# ---------------------------------------------------------------------------

# Cache kinds whose per-position rows are position-addressable: row j of every
# leaf is a pure function of (token_j, position j, params), the property that
# makes token-prefix pages reusable across requests.  Recurrent state (RetNet
# S) folds the whole history into O(1) slots, so it cannot share *pages*; it
# snapshots whole cache states instead (`prefix_sharing_mode` -> 'snapshot').
_PAGEABLE_KINDS = frozenset({"dense", "moe"})


def prefix_sharing_mode(cfg: ModelConfig) -> str | None:
    """How this architecture can reuse a cached token prefix.

    'paged'    — every decode-cache group is position-addressable linear
                 attention (dense/moe GQA or MLA, no sliding window): token
                 prefixes map to immutable page runs sliced on the cache
                 axis, adoptable at any boundary.
    'snapshot' — at least one group is recurrent state: the *whole cache*
                 at a finished prompt is a valid prefix state, adoptable at
                 that exact token boundary.
    None       — encoder-decoder and frontend prompts prefill monolithically,
                 so there is no admission seam to adopt a prefix through.
    """
    if cfg.is_encdec or cfg.frontend:
        return None
    kinds = {kind for _, _, kind in layer_groups(cfg)}
    if kinds <= _PAGEABLE_KINDS and not cfg.sliding_window:
        return "paged"
    return "snapshot"


def prefix_page_groups(cfg: ModelConfig) -> list[str]:
    """The reference's cache groups a page row covers, in layer order; the
    port holds their layers in one flat ``blocks`` list.  Only meaningful
    when `prefix_sharing_mode(cfg) == 'paged'`."""
    if prefix_sharing_mode(cfg) != "paged":
        raise ValueError(f"{cfg.name}: cache is not pageable "
                         f"(mode={prefix_sharing_mode(cfg)!r})")
    return [gname for gname, _, kind in layer_groups(cfg) if kind != "enc"]


def _block_leaves(blocks: list):
    """(path, tensor) of every block leaf, encoded planes included: path is
    ``(layer, name)`` or ``(layer, name, plane)``."""
    for i, layer in enumerate(blocks):
        for name, leaf in layer.items():
            if isinstance(leaf, dict):
                for plane, t in leaf.items():
                    yield (i, name, plane), t
            else:
                yield (i, name), leaf


@functools.lru_cache(maxsize=None)
def _page_axes(cfg: ModelConfig) -> dict:
    """The cache axis of every block leaf of a pageable cache, in each
    residency (f32, bf16 and the kvq formats), keyed by `_block_leaves`
    path: the one axis whose length follows ``cache_len`` in
    `make_decode_cache` (batch-1 caches of 1 and 2 rows on the CPU, a few
    hundred KB; the meta device would import PyTorch's fake-tensor
    machinery on first use, seconds of host time inside an admission).  A
    plain leaf's path and its encoded planes' paths differ, so one map
    serves every format."""
    prefix_page_groups(cfg)
    axes = {}
    for fmt in (torch.float32, *kvq.FORMATS):
        one, two = (dict(_block_leaves(make_decode_cache(cfg, 1, c, dtype=fmt,
                                                         device="cpu")["blocks"]))
                    for c in (1, 2))
        for path, t in one.items():
            (axes[path],) = [ax for ax, (a, b) in enumerate(zip(t.shape, two[path].shape))
                             if a != b]
    return axes


def slice_cache_rows(cache: dict, cfg: ModelConfig, start: int, stop: int) -> dict:
    """Copies of cache rows [start, stop) of every block leaf:
    ``{"blocks": [one dict per layer]}``, each leaf cut on its cache axis.

    Encoded residency slices its planes the same way: `core.kvq` formats
    encode along the *last* axis only, so a cache-axis slice of the ``q``/
    ``s`` (or ``m``/``e``) planes is exactly the encoding of the sliced rows.
    The rows are cloned, never views: a page must neither keep the whole
    cache it was cut from alive nor be written through it later."""
    axes = _page_axes(cfg)
    out = [{} for _ in cache["blocks"]]
    for path, t in _block_leaves(cache["blocks"]):
        rows = t.narrow(axes[path], start, stop - start).clone(
            memory_format=torch.contiguous_format)
        if len(path) == 3:
            out[path[0]].setdefault(path[1], {})[path[2]] = rows
        else:
            out[path[0]][path[1]] = rows
    return {"blocks": out}


def assemble_prefix_cache(cfg: ModelConfig, rows: list[dict], n_tokens: int,
                          cache_len: int, dtype, device) -> dict:
    """Build the warm batch-1 decode cache an adopted prefix resumes from.

    ``rows`` are `slice_cache_rows` outputs (a run of pages) laid end to end,
    covering positions [0, n_tokens).  The scaffold is `make_decode_cache(
    start_pos=n_tokens)`, whose ``pos`` and RoPE angle state are what a
    chunked prefill of those tokens leaves behind, and the page rows are
    copied under it.  The result has the structure, shapes and dtypes of a
    cold chunked-prefill cache, so `ChunkedPrefill` and `CachePool.write`
    take it unchanged; it shares no tensor with any page."""
    cache = make_decode_cache(cfg, 1, cache_len, dtype=dtype, start_pos=n_tokens,
                              device=device)
    axes = _page_axes(cfg)
    dst = list(_block_leaves(cache["blocks"]))
    at = 0
    for part in rows:
        src = dict(_block_leaves(part["blocks"]))
        for path, full in dst:
            n = src[path].shape[axes[path]]
            full.narrow(axes[path], at, n).copy_(src[path])
        at += n
    if at != n_tokens:
        raise ValueError(f"page rows cover {at} positions, expected {n_tokens}")
    return cache
