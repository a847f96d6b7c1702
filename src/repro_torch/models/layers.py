"""Shared layers: fused norms, flash attention, KV-cache helpers, GQA and MLA.

Every matmul goes through the HSA engine, and every pre-matmul norm uses the
Eq. (4) fused emission (C3): `norm_emit` returns ``(x*, sigma^{-1})`` and
sigma^{-1} rides into the consuming linears' epilogues as ``row_scale``.
Only RMSNorm is ported so far.

Attention keeps the reference's GQA layout: head ``h`` belongs to kv head
``h // G`` (``q.reshape(b, kv, h // kv, hd)``), QK-norm comes before RoPE,
and K/V caches are ``[B, C, KV, hd]`` leaves, plain tensors or kvq-encoded
dicts.  Decode attention is the flash-decode kernel; prefill attention
(monolithic and chunked) is the reference's online-softmax forward in plain
PyTorch (it is no Pallas kernel there either).  Chunked prefill
(`gqa_chunk`, `mla_chunk`) appends a chunk's rows into a warm cache at the
device position and attends over the resident prefix.  Sliding-window ring
caches are not ported yet.

MLA (deepseek-v3) caches the compressed ``c_kv [B, C, kv_lora_rank]`` and
the shared rope key ``k_rope [B, C, qk_rope_head_dim]``.  Prefill expands
them per head for flash attention (a chunk re-expands the whole resident
latent); decode absorbs ``wk_b``/``wv_b`` into the
query and the output and attends in the latent space through flash-decode's
MLA mode.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import fused_rmsnorm as fr
from repro_torch.core import kvq
from repro_torch.core import online_rope as orp
from repro_torch.core.hsa import HSAEngine
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import MLA, Attention, Init, Linear, Norm

# ---------------------------------------------------------------------------
# Norms (fused emission, C3)
# ---------------------------------------------------------------------------


def norm_init(init: Init, dim: int, cfg: ModelConfig) -> Norm:
    if cfg.norm_type != "rmsnorm":
        raise NotImplementedError(f"norm_type {cfg.norm_type!r} is not ported")
    return Norm(init.ones((dim,)))


def norm_emit(p: Norm, x: torch.Tensor, engine: HSAEngine
              ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Return (x*, sigma_inv) fused, or (normalized x, None) unfused."""
    if engine.config.fuse_rmsnorm:
        return fr.fused_rmsnorm_emit(x, p.g)
    return fr.rmsnorm(x, p.g), None


def norm_full(p: Norm, x: torch.Tensor) -> torch.Tensor:
    """Always-normalized variant (final norm before the LM head)."""
    return fr.rmsnorm(x, p.g)


# ---------------------------------------------------------------------------
# Flash attention (forward only: online softmax over KV chunks)
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int | torch.Tensor = 0,
                    kv_len: int | torch.Tensor | None = None, q_chunk: int = 512,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """q ``[B, Sq, KV, G, hd]``, k/v ``[B, Sk, KV, hd]`` -> ``[B, Sq, KV, G, dv]``
    in v's dtype, never materializing more than one [q_chunk, kv_chunk]
    score tile per head.

    The reference's `_flash_fwd_impl` step for step: q pre-scaled by
    ``1/sqrt(hd)`` in f32, both sides padded to whole chunks (padded keys
    masked, padded queries dropped), masked scores at -inf, and the
    finite-max guard on all-masked rows.  Queries sit at absolute positions
    ``q_offset + i`` and keys at ``j``; keys at or past ``kv_len`` are masked
    (``kv_len`` defaults to ``Sk``).  ``q_offset`` and ``kv_len`` are ints or
    int32 scalars on the device (chunked prefill passes the cache's
    position), so the mask is computed on the device and nothing is read
    back.  The reference's sliding ``window`` and ``k_offset`` (its ring
    caches) come with the hybrid families.
    """
    b, sq, kv_h, g, hd = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, sk)
    pq, pk = (-sq) % q_chunk, (-sk) % kv_chunk
    f32 = torch.float32
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=f32, device=q.device))
    qs = torch.nn.functional.pad(q.to(f32) * scale, (0, 0, 0, 0, 0, 0, 0, pq))
    kf = torch.nn.functional.pad(k.to(f32), (0, 0, 0, 0, 0, pk))
    vf = torch.nn.functional.pad(v.to(f32), (0, 0, 0, 0, 0, pk))
    k_pos = torch.arange(sk + pk, device=q.device)
    k_valid = k_pos < (sk if kv_len is None else kv_len)
    outs = []
    for q0 in range(0, sq + pq, q_chunk):
        q_blk = qs[:, q0:q0 + q_chunk]
        q_pos = q_offset + q0 + torch.arange(q_chunk, device=q.device)
        m = torch.full((b, kv_h, g, q_chunk), -torch.inf, dtype=f32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, kv_h, g, q_chunk, dv, dtype=f32, device=q.device)
        for k0 in range(0, sk + pk, kv_chunk):
            kp = k_pos[k0:k0 + kv_chunk]
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, kf[:, k0:k0 + kv_chunk])
            mask = k_valid[k0:k0 + kv_chunk][None, :].expand(q_chunk, -1)
            if causal:
                mask = mask & (q_pos[:, None] >= kp[None, :])
            s = s.masked_fill(~mask, -torch.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe, -torch.inf))
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vf[:, k0:k0 + kv_chunk])
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))          # [B, qc, KV, G, dv]
    return torch.cat(outs, dim=1)[:, :sq].to(v.dtype)


# ---------------------------------------------------------------------------
# KV-cache leaves: plain tensors or kvq-encoded dicts, axis 1 = cache slot
# ---------------------------------------------------------------------------

KV8_SCALE = kvq.KV8_SCALE


def to_cache_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Plain cache dtype; int8 is the legacy static-scale format."""
    if dtype == torch.int8:
        return torch.round(x.to(torch.float32) * KV8_SCALE).clamp(-127, 127).to(torch.int8)
    return x.to(dtype)


def from_cache_dtype(c) -> torch.Tensor:
    """Cache leaf (plain tensor or kvq-encoded dict) -> f32 tensor."""
    return kvq.decode(c)


def to_cache_like(x: torch.Tensor, leaf):
    """Encode fresh K/V rows to match the resident cache leaf's format.

    The reference appends rows inside jitted code only (its decode loop and
    its chunked-prefill step), where XLA compiles int8_tok's ``absmax /
    127.0`` into a reciprocal multiply, so the rows here take that form (see
    `core/kvq.py`)."""
    if isinstance(leaf, dict):
        return kvq.encode_like(x, leaf, reciprocal=True)
    return to_cache_dtype(x, leaf.dtype)


def cache_update(leaf, x: torch.Tensor, pos: torch.Tensor):
    """Write the rows ``x [B, n, ...]`` into ``leaf`` at slot ``pos`` (axis 1),
    **in place**, and return the leaf.

    ``pos`` is an int32 tensor on the leaf's device: a scalar (every row at
    that slot) or a ``[B]`` vector (row b at ``pos[b]``, one indexed scatter:
    a slot class whose lanes sit at different positions).  The write is an
    indexed copy, so a captured decode step replays it at whatever slots the
    device holds.  The reference's ``dynamic_update_slice`` returns a new
    buffer, which XLA performs in place inside its loop; here the write goes
    into the preallocated leaf, so a full-width step never copies the cache.
    A caller that needs the cache as it was (a test that replays a step)
    clones it first.  Each slot is clamped on the device so the rows fit, as
    the reference's is.
    """
    enc = to_cache_like(x, leaf)
    n, c = x.shape[1], cache_capacity(leaf)
    idx = pos.clamp(0, c - n).to(torch.int64)[..., None] + torch.arange(n, device=pos.device)
    parts = leaf.items() if isinstance(leaf, dict) else ((None, leaf),)
    for name, buf in parts:
        rows = enc if name is None else enc[name]
        if pos.ndim == 0:
            buf.index_copy_(1, idx, rows)
        else:
            lanes = torch.arange(buf.shape[0], device=pos.device)[:, None]
            buf.index_put_((lanes, idx), rows)
    return leaf


def decode_slots(pos: torch.Tensor, c: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The slot a linear cache of capacity ``c`` writes at position ``pos``
    and the rows attention reads, ``(min(pos, c - 1), min(pos + 1, c))``:
    int32 tensors computed on the device, as the reference computes them
    in its loop; per lane for a ``[B]`` position."""
    return pos.clamp(max=c - 1), (pos + 1).clamp(max=c)


def cache_capacity(leaf) -> int:
    """Slot count of a cache leaf (axis 1), dict- or tensor-formed."""
    if isinstance(leaf, dict):
        return next(iter(leaf.values())).shape[1]
    return leaf.shape[1]


def make_cache_leaf(shape: tuple, dtype, device=None):
    """One attention-cache buffer: ``dtype`` is a torch dtype or a kvq format
    name ('int8_tok' / 'mxint4_blk'), which gives the encoded dict
    (bit-identical to encoding a zero buffer)."""
    if kvq.is_format(dtype):
        return kvq.zeros(shape, dtype, device=device)
    return torch.zeros(shape, dtype=dtype, device=device)


def attend_one_step(q: torch.Tensor, k_cache, v_cache,
                    valid_mask: torch.Tensor) -> torch.Tensor:
    """Decode attention over the cache with an explicit ``[B, C]`` validity
    mask (the reference's oracle).  The decode path goes through
    `ops.flash_decode`, whose plain version is the same math with a prefix
    mask."""
    return kref.masked_decode_attention(q, k_cache, v_cache,
                                        valid_mask[:, None, None, :])


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------


def gqa_init(init: Init, cfg: ModelConfig) -> Attention:
    d, hd, h, kv = cfg.d_model, cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    bias = cfg.qkv_bias
    qn = kn = None
    wq = Linear.init(init, d, h * hd, bias=bias)
    wk = Linear.init(init, d, kv * hd, bias=bias)
    wv = Linear.init(init, d, kv * hd, bias=bias)
    wo = Linear.init(init, h * hd, d)
    if cfg.qk_norm:
        qn, kn = norm_init(init, hd, cfg), norm_init(init, hd, cfg)
    return Attention(wq, wk, wv, wo, qn, kn)


def _qk_head_norm(p: Attention, q, k, cfg: ModelConfig):
    if not cfg.qk_norm:
        return q, k
    return fr.rmsnorm(q, p.qnorm.g), fr.rmsnorm(k, p.knorm.g)


def _project_qkv(p: Attention, x_star, sig_inv, engine: HSAEngine, phase: str,
                 cfg: ModelConfig):
    b, s, _ = x_star.shape
    hd, h, kv = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    q = engine.linear(p.wq, x_star, phase, row_scale=sig_inv).reshape(b, s, h, hd)
    k = engine.linear(p.wk, x_star, phase, row_scale=sig_inv).reshape(b, s, kv, hd)
    v = engine.linear(p.wv, x_star, phase, row_scale=sig_inv).reshape(b, s, kv, hd)
    q, k = _qk_head_norm(p, q, k, cfg)
    return q, k, v


def gqa_apply(p: Attention, x_star, sig_inv, engine: HSAEngine, phase: str,
              cfg: ModelConfig, *, rope_sin=None, rope_cos=None
              ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence causal attention -> (out [B, S, D], (k, v) for the cache)."""
    b, s, _ = x_star.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q, k, v = _project_qkv(p, x_star, sig_inv, engine, phase, cfg)
    if rope_sin is not None:
        sin, cos = rope_sin[None, :, None, :], rope_cos[None, :, None, :]
        q, k = orp.apply_rope(q, sin, cos), orp.apply_rope(k, sin, cos)
    out = flash_attention(q.reshape(b, s, kv, h // kv, hd), k, v)
    out = engine.linear(p.wo, out.reshape(b, s, h * hd), phase)
    return out, (k, v)


def gqa_decode(p: Attention, x_star, sig_inv, engine: HSAEngine,
               cfg: ModelConfig, cache: dict, pos: torch.Tensor, *, rope_sin=None,
               rope_cos=None) -> tuple[torch.Tensor, dict]:
    """One decode step: project, rotate (online RoPE), append the new K/V
    row in place (`cache_update`), attend through the flash-decode kernel.

    ``pos`` is the absolute position of this token, an int32 scalar on the
    device, or a ``[B]`` vector of per-lane positions (then ``rope_sin`` /
    ``rope_cos`` are ``[B, hd/2]`` and flash-decode reads a per-lane
    ``kv_len``).  A linear cache clamps at its capacity, as the reference's
    does."""
    b = x_star.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q, k, v = _project_qkv(p, x_star, sig_inv, engine, "decode", cfg)
    if rope_sin is not None:
        sin, cos = orp.lane_angles(rope_sin, q.ndim), orp.lane_angles(rope_cos, q.ndim)
        q = orp.apply_rope(q, sin, cos)
        k = orp.apply_rope(k, sin, cos)
    q = q[:, 0].reshape(b, kv, h // kv, hd)
    slot, kv_len = decode_slots(pos, cache_capacity(cache["k"]))
    k_cache = cache_update(cache["k"], k, slot)
    v_cache = cache_update(cache["v"], v, slot)
    out = ops.flash_decode(q, k_cache, v_cache, kv_len, impl=engine.config.kernel_impl)
    out = engine.linear(p.wo, out.reshape(b, 1, h * hd), "decode")
    return out, {"k": k_cache, "v": v_cache}


def gqa_chunk(p: Attention, x_star, sig_inv, engine: HSAEngine, cfg: ModelConfig,
              cache: dict, pos: torch.Tensor, *, rope_sin=None,
              rope_cos=None) -> tuple[torch.Tensor, dict]:
    """Chunked prefill (MMM phase over a warm cache): append the chunk's C
    K/V rows at ``pos`` in place (`cache_update`) and attend to the whole
    resident prefix.

    ``pos`` is the absolute position of the chunk's first token, an int32
    scalar on the device: the rows' slots, the causal offsets and the valid
    length ``pos + C`` are all computed there.  ``rope_sin``/``rope_cos`` are
    ``[C, hd/2]`` at the chunk's absolute positions.  Sliding-window rings
    are not ported yet (A9) and raise.
    """
    if cfg.sliding_window:
        raise NotImplementedError("sliding-window ring caches are not ported yet")
    b, c, _ = x_star.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q, k, v = _project_qkv(p, x_star, sig_inv, engine, "prefill", cfg)
    if rope_sin is not None:
        sin, cos = rope_sin[None, :, None, :], rope_cos[None, :, None, :]
        q, k = orp.apply_rope(q, sin, cos), orp.apply_rope(k, sin, cos)
    k_cache = cache_update(cache["k"], k, pos)
    v_cache = cache_update(cache["v"], v, pos)
    out = flash_attention(q.reshape(b, c, kv, h // kv, hd), from_cache_dtype(k_cache),
                          from_cache_dtype(v_cache), causal=True, q_offset=pos,
                          kv_len=pos + c)
    out = engine.linear(p.wo, out.reshape(b, c, h * hd), "prefill")
    return out, {"k": k_cache, "v": v_cache}


def gqa_make_cache(cfg: ModelConfig, batch: int, cache_len: int,
                   dtype=torch.bfloat16, device=None) -> dict:
    if cfg.sliding_window:
        raise NotImplementedError("sliding-window ring caches are not ported yet")
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": make_cache_leaf(shape, dtype, device),
            "v": make_cache_leaf(shape, dtype, device)}


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (deepseek-v3)
# ---------------------------------------------------------------------------


def mla_init(init: Init, cfg: ModelConfig) -> MLA:
    d, h = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    wq_a = Linear.init(init, d, qr)                    # q down-projection
    q_norm = norm_init(init, qr, cfg)
    wq_b = Linear.init(init, qr, h * (dn + dr))        # q up-projection
    wkv_a = Linear.init(init, d, kvr + dr)             # c_kv + shared k_rope
    kv_norm = norm_init(init, kvr, cfg)
    wk_b = Linear.init(init, kvr, h * dn)              # k up (nope part)
    wv_b = Linear.init(init, kvr, h * dv)              # v up
    wo = Linear.init(init, h * dv, d)
    return MLA(wq_a, q_norm, wq_b, wkv_a, kv_norm, wk_b, wv_b, wo)


def _mla_q(p: MLA, x_star, sig_inv, engine: HSAEngine, phase: str, cfg: ModelConfig):
    b, s, _ = x_star.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_lat = engine.linear(p.wq_a, x_star, phase, row_scale=sig_inv)
    q_lat, q_sig = norm_emit(p.q_norm, q_lat, engine)
    q = engine.linear(p.wq_b, q_lat, phase, row_scale=q_sig)
    q = q.reshape(b, s, cfg.n_heads, dn + dr)
    return q[..., :dn], q[..., dn:]                    # (q_nope, q_rope)


def _mla_latents(p: MLA, x_star, sig_inv, engine: HSAEngine, phase: str,
                 cfg: ModelConfig):
    """The compressed latent (normalized) and the shared rope key, unrotated."""
    kv_a = engine.linear(p.wkv_a, x_star, phase, row_scale=sig_inv)
    kvr = cfg.kv_lora_rank
    return norm_full(p.kv_norm, kv_a[..., :kvr]), kv_a[..., kvr:]


def mla_apply(p: MLA, x_star, sig_inv, engine: HSAEngine, phase: str,
              cfg: ModelConfig, *, rope_sin=None, rope_cos=None
              ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Prefill MLA: materialize per-head K/V from the latent (the MMM phase)
    -> (out [B, S, D], (c_kv, k_rope)), the compressed tensors the cache
    keeps."""
    b, s, _ = x_star.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, x_star, sig_inv, engine, phase, cfg)
    c_kv, k_rope = _mla_latents(p, x_star, sig_inv, engine, phase, cfg)
    if rope_sin is not None:
        sin, cos = rope_sin[None, :, None, :], rope_cos[None, :, None, :]
        q_rope = orp.apply_rope(q_rope, sin, cos)
        k_rope = orp.apply_rope(k_rope[:, :, None, :], sin, cos)[:, :, 0]
    k_nope = engine.linear(p.wk_b, c_kv, phase).reshape(b, s, h, dn)
    v = engine.linear(p.wv_b, c_kv, phase).reshape(b, s, h, dv)
    # The rope part rides beside the nope part, so one flash call takes both
    # score terms (k_rope is shared by every head).
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
    out = flash_attention(q_full.reshape(b, s, h, 1, dn + dr), k_full, v)
    out = engine.linear(p.wo, out.reshape(b, s, h * dv), phase)
    return out, (c_kv, k_rope)


@functools.lru_cache(maxsize=None)
def _mla_scale(width: int) -> float:
    """The decode score scale ``1 / sqrt(width)``, in f32 arithmetic as the
    reference computes it, once per width."""
    return float(1.0 / torch.sqrt(torch.tensor(width, dtype=torch.float32)))


def mla_decode(p: MLA, x_star, sig_inv, engine: HSAEngine, cfg: ModelConfig,
               cache: dict, pos: torch.Tensor, *, rope_sin=None, rope_cos=None
               ) -> tuple[torch.Tensor, dict]:
    """One decode step with absorbed projections: the query takes ``wk_b``
    and the latent output ``wv_b``, so attention runs in the compressed
    space through flash-decode's MLA mode (the rope term is its second score
    stream) and the cache stays compressed.  The new latent and rope rows
    are written into the cache in place (`cache_update`).  ``pos`` is a
    scalar or per-lane ``[B]``, as in `gqa_decode`."""
    b = x_star.shape[0]
    h = cfg.n_heads
    kvr, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                       cfg.qk_rope_head_dim, cfg.v_head_dim)
    q_nope, q_rope = _mla_q(p, x_star, sig_inv, engine, "decode", cfg)
    q_nope, q_rope = q_nope[:, 0], q_rope[:, 0]        # [B, H, dn], [B, H, dr]
    c_kv_new, k_rope_new = _mla_latents(p, x_star, sig_inv, engine, "decode", cfg)
    if rope_sin is not None:
        sin, cos = orp.lane_angles(rope_sin, 3), orp.lane_angles(rope_cos, 3)
        q_rope = orp.apply_rope(q_rope, sin, cos)
        k_rope_new = orp.apply_rope(k_rope_new, sin, cos)

    slot, kv_len = decode_slots(pos, cache_capacity(cache["c_kv"]))
    c_kv = cache_update(cache["c_kv"], c_kv_new, slot)
    k_rope = cache_update(cache["k_rope"], k_rope_new, slot)

    # q_abs[b, h, r] = sum_n q_nope[b, h, n] wk_b[r, h, n]: plain products,
    # as the reference leaves them to XLA, on the f32 master.
    f32 = torch.float32
    wk_b = p.wk_b.w.reshape(kvr, h, dn).to(f32)
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope.to(f32), wk_b)
    lat_out = ops.flash_decode(q_abs, c_kv, c_kv, kv_len, q2=q_rope, k2=k_rope,
                               scale=_mla_scale(dn + dr), impl=engine.config.kernel_impl)
    wv_b = p.wv_b.w.reshape(kvr, h, dv).to(f32)
    out_heads = torch.einsum("bhr,rhv->bhv", lat_out, wv_b)
    out = engine.linear(p.wo, out_heads.reshape(b, 1, h * dv), "decode")
    return out, {"c_kv": c_kv, "k_rope": k_rope}


def mla_chunk(p: MLA, x_star, sig_inv, engine: HSAEngine, cfg: ModelConfig,
              cache: dict, pos: torch.Tensor, *, rope_sin=None, rope_cos=None
              ) -> tuple[torch.Tensor, dict]:
    """Chunked prefill for MLA: append the chunk's compressed latent and rope
    rows at ``pos`` in place, then re-expand the *whole* resident latent
    through ``wk_b``/``wv_b`` (M = B x capacity rows per linear) for the flash
    call, as the reference does; the cache itself stays compressed.
    ``pos`` is an int32 scalar on the device, as in `gqa_chunk`."""
    b, c, _ = x_star.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, x_star, sig_inv, engine, "prefill", cfg)
    c_kv_new, k_rope_new = _mla_latents(p, x_star, sig_inv, engine, "prefill", cfg)
    if rope_sin is not None:
        sin, cos = rope_sin[None, :, None, :], rope_cos[None, :, None, :]
        q_rope = orp.apply_rope(q_rope, sin, cos)
        k_rope_new = orp.apply_rope(k_rope_new[:, :, None, :], sin, cos)[:, :, 0]
    c_kv = cache_update(cache["c_kv"], c_kv_new, pos)
    k_rope = cache_update(cache["k_rope"], k_rope_new, pos)

    cap = cache_capacity(c_kv)
    c_kv_f = from_cache_dtype(c_kv)
    k_nope = engine.linear(p.wk_b, c_kv_f, "prefill").reshape(b, cap, h, dn)
    v = engine.linear(p.wv_b, c_kv_f, "prefill").reshape(b, cap, h, dv)
    k_rope_f = from_cache_dtype(k_rope)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope_f[:, :, None, :].expand(b, cap, h, dr)], dim=-1)
    out = flash_attention(q_full.reshape(b, c, h, 1, dn + dr), k_full, v, causal=True,
                          q_offset=pos, kv_len=pos + c)
    out = engine.linear(p.wo, out.reshape(b, c, h * dv), "prefill")
    return out, {"c_kv": c_kv, "k_rope": k_rope}


def mla_make_cache(cfg: ModelConfig, batch: int, cache_len: int,
                   dtype=torch.bfloat16, device=None) -> dict:
    return {"c_kv": make_cache_leaf((batch, cache_len, cfg.kv_lora_rank), dtype, device),
            "k_rope": make_cache_leaf((batch, cache_len, cfg.qk_rope_head_dim), dtype,
                                      device)}
