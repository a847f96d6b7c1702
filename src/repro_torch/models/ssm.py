"""Mamba-1 selective-SSM block (falcon-mamba-7b; the SSM half of hymba).

Diagonal-A selective scan.  Per channel d and state n:

    h_t = exp(dt_t * A[d,n]) * h_{t-1} + dt_t * B_t[n] * x_t[d]
    y_t = sum_n C_t[n] * h_t[d,n]  +  D[d] * x_t[d]

Prefill and every chunk run the reference's **chunked** scan: chunks of
``cfg.ssm_chunk`` tokens carry the O(1) state from one to the next, and inside
a chunk a log-depth inclusive prefix over the pairs ``(exp(dt A), dt B x)``
with the combine ``(a1, b1) o (a2, b2) = (a1 a2, b2 + a2 b1)`` gives the state
after every position, as ``jax.lax.associative_scan`` does there.  At most
one chunk's ``[chunk, B, d_inner, state]`` decay and state tensors exist at a
time (134 MB f32 for falcon-mamba-7b at B 2), never the whole sequence's.
The scan is plain PyTorch on both devices: it is no Pallas kernel in the
reference either.  Decode is the one-step recurrence, whose linears are the
MXINT4 MVM workload.

Like the reference, ``x_proj`` reads the pre-conv input, and the cache is
``{"h": f32 [B, d_inner, state], "conv": f32 [B, conv_width - 1, d_inner]}``
(the last pre-conv inputs).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.hsa import HSAEngine
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import Init, Linear


class Mamba(nn.Module):
    """The projections ``in_proj`` (x and z branches), ``x_proj`` (dt, B,
    C), ``dt_proj`` (with bias) and ``out_proj``, and the plain parameters
    the scan reads: the depthwise conv ``conv_w [cw, d_inner]`` and
    ``conv_b``, ``a_log [d_inner, state]`` and ``d_skip [d_inner]``."""

    def __init__(self, in_proj: Linear, conv_w: torch.Tensor, conv_b: torch.Tensor,
                 x_proj: Linear, dt_proj: Linear, a_log: torch.Tensor,
                 d_skip: torch.Tensor, out_proj: Linear):
        super().__init__()
        self.in_proj, self.x_proj, self.dt_proj, self.out_proj = (in_proj, x_proj,
                                                                  dt_proj, out_proj)
        for name, t in (("conv_w", conv_w), ("conv_b", conv_b), ("a_log", a_log),
                        ("d_skip", d_skip)):
            setattr(self, name, nn.Parameter(t, requires_grad=False))


def mamba_init(init: Init, cfg: ModelConfig) -> Mamba:
    """The reference's `mamba_init` distributions: linears at std 1/sqrt(K),
    ``conv_w`` at 1/conv_width, ``conv_b`` and the dt bias zeros, ``a_log``
    and ``d_skip`` ones."""
    d, di, n, r = cfg.d_model, cfg.d_inner_, cfg.ssm_state, cfg.dt_rank_
    in_proj = Linear.init(init, d, 2 * di)
    conv_w = init.normal((cfg.conv_width, di), 1.0 / cfg.conv_width)
    conv_b = init.zeros((di,))
    x_proj = Linear.init(init, di, r + 2 * n)
    dt_proj = Linear.init(init, r, di, bias=True)
    return Mamba(in_proj, conv_w, conv_b, x_proj, dt_proj, init.ones((di, n)),
                 init.ones((di,)), Linear.init(init, di, d))


def _ssm_inputs(p: Mamba, xz: torch.Tensor, engine: HSAEngine, phase: str,
                cfg: ModelConfig):
    """Split in_proj's output -> (pre-conv x, z, dt, B, C)."""
    di, n, r = cfg.d_inner_, cfg.ssm_state, cfg.dt_rank_
    x, z = xz[..., :di], xz[..., di:]
    dbc = engine.linear(p.x_proj, x, phase)
    dt = F.softplus(engine.linear(p.dt_proj, dbc[..., :r], phase))
    return x, z, dt, dbc[..., r:r + n], dbc[..., r + n:]


def _conv_causal(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 state: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv over the sequence, then SiLU.  x ``[B, S, di]``,
    w ``[cw, di]``; ``state`` ``[B, cw-1, di]`` is the carried-in window
    (zeros when absent)."""
    cw, s = w.shape[0], x.shape[1]
    pad = (torch.zeros(x.shape[0], cw - 1, x.shape[2], dtype=x.dtype, device=x.device)
           if state is None else state)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + s] * w[i] for i in range(cw))
    return F.silu(out + bias)


def _prefix_scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along axis 0 of the pairs ``(a, b)`` under ``(a1, b1)
    o (a2, b2) = (a1 a2, b2 + a2 b1)``, in log2(len) doubling rounds
    (Hillis-Steele) between two pairs of buffers.  Consumes its inputs."""
    a2, b2 = torch.empty_like(a), torch.empty_like(b)
    d = 1
    while d < a.shape[0]:
        a2[:d], b2[:d] = a[:d], b[:d]
        torch.addcmul(b[d:], a[d:], b[:-d], out=b2[d:])
        torch.mul(a[d:], a[:-d], out=a2[d:])
        a, b, a2, b2 = a2, b2, a, b
        d *= 2
    return a, b


def _scan_block(h0, dt, xc, bc, cc, a):
    """One chunk, seq-major ``[c, B, ...]`` f32 inputs, from the state ``h0``
    ``[B, di, n]`` -> (the state after every position ``[c, B, di, n]``, y
    ``[c, B, di]``)."""
    da = torch.exp(dt[..., None] * a)                     # [c, B, di, n]
    db = (dt * xc)[..., None] * bc[..., None, :]
    a_sc, b_sc = _prefix_scan(da, db)
    h = a_sc * h0[None] + b_sc
    return h, torch.einsum("sbdn,sbn->sbd", h, cc)


def selective_scan(h0, dt, xc, bc, cc, a, chunk: int, collect: bool = False):
    """The scan over a sequence, seq-major ``[S, B, ...]`` f32 inputs
    (dt and the conv output ``[S, B, di]``, B and C ``[S, B, n]``), from
    ``h0`` ``[B, di, n]``, with ``a = -exp(a_log)`` -> (y ``[S, B, di]``, the
    final state, and with ``collect`` the state after every position ``[S,
    B, di, n]``, from one pass over all S).  Otherwise chunks of ``chunk``
    positions, the tail chunk last, each carrying the state to the next."""
    if collect:
        h_all, y = _scan_block(h0, dt, xc, bc, cc, a)
        return y, h_all[-1], h_all
    ys, h = [], h0
    for c0 in range(0, dt.shape[0], chunk):
        h_c, y = _scan_block(h, *(t[c0:c0 + chunk] for t in (dt, xc, bc, cc)), a)
        h = h_c[-1]
        ys.append(y)
        del h_c
    return torch.cat(ys), h, None


def ssm_step(h, dt, xc, bc, cc, a):
    """One recurrent step: ``[B, di]`` f32 dt and conv output, ``[B, n]`` B
    and C, the state ``h`` ``[B, di, n]`` -> (y ``[B, di]``, the new state)."""
    da = torch.exp(dt[..., None] * a)                      # [B, di, n]
    db = (dt * xc)[..., None] * bc[:, None, :]
    h = da * h + db
    return torch.einsum("bdn,bn->bd", h, cc), h


def mamba_apply(p: Mamba, x_star, sig_inv, engine: HSAEngine, phase: str,
                cfg: ModelConfig, cache: dict | None = None,
                valid_len: torch.Tensor | None = None,
                collect_states: bool = False) -> tuple[torch.Tensor, dict]:
    """Full-sequence chunked selective scan -> (out ``[B, S, D]``, cache).

    ``cache`` (a chunk of a chunked prefill, or a verify block) seeds the
    scan and the conv window with the previous state.  ``valid_len`` (an
    int32 device scalar: a bucketed prefill) freezes the state through the
    padded tail, whose ``dt`` is zeroed, and takes the outgoing conv window
    at the last real token by a device index.  ``collect_states`` (a verify
    block of a few tokens) scans the block in one pass and adds ``h_all``
    ``[B, S, di, n]`` (the state after every token) and ``conv_ext`` ``[B,
    cw-1+S, di]`` (the carried-in window, then the block's pre-conv inputs)
    to the cache, from which `lm.commit_verified_cache` takes the state at
    the acceptance boundary."""
    bsz, s, _ = x_star.shape
    di, n, cw = cfg.d_inner_, cfg.ssm_state, cfg.conv_width
    chunk = min(cfg.ssm_chunk, s)
    f32 = torch.float32

    xz = engine.linear(p.in_proj, x_star, phase, row_scale=sig_inv)
    x_pre, z, dt, bc, cc = _ssm_inputs(p, xz, engine, phase, cfg)
    conv_in = cache["conv"].to(x_pre.dtype) if cache is not None else None
    xc = _conv_causal(x_pre, p.conv_w, p.conv_b, state=conv_in)
    if valid_len is not None:
        dt = dt * (torch.arange(s, device=dt.device) < valid_len)[None, :, None]
    a = -torch.exp(p.a_log.to(f32))                        # [di, n], negative

    h0 = (cache["h"] if cache is not None
          else torch.zeros(bsz, di, n, dtype=f32, device=x_star.device))
    y_seq, h_last, h_all = selective_scan(
        h0, *(t.to(f32).transpose(0, 1) for t in (dt, xc, bc, cc)), a, chunk,
        collect=collect_states)
    y = y_seq.transpose(0, 1)

    y = y + xc.to(f32) * p.d_skip.to(f32)
    y = y * F.silu(z.to(f32))
    out = engine.linear(p.out_proj, y.to(x_star.dtype), phase)
    prev = (cache["conv"].to(f32) if cache is not None
            else torch.zeros(bsz, cw - 1, di, dtype=f32, device=x_star.device))
    pre_ext = torch.cat([prev, x_pre.to(f32)], dim=1)     # [B, cw-1+s, di]
    if valid_len is None:
        conv_state = pre_ext[:, s:]
    else:
        at = valid_len.to(torch.int64) + torch.arange(cw - 1, device=pre_ext.device)
        conv_state = pre_ext.index_select(1, at)
    new_cache = {"h": h_last, "conv": conv_state}
    if collect_states:
        new_cache["h_all"] = h_all.transpose(0, 1)        # [B, S, di, n]
        new_cache["conv_ext"] = pre_ext
    return out, new_cache


def mamba_decode(p: Mamba, x_star, sig_inv, engine: HSAEngine, cfg: ModelConfig,
                 cache: dict) -> tuple[torch.Tensor, dict]:
    """One-step recurrence on the O(1) state -> (out ``[B, 1, D]``, cache)."""
    di, f32 = cfg.d_inner_, torch.float32
    xz = engine.linear(p.in_proj, x_star, "decode", row_scale=sig_inv)
    x_raw = xz[..., :di]                                   # pre-conv input
    conv_state = torch.cat([cache["conv"][:, 1:], x_raw.to(f32)], dim=1)
    xc = _conv_causal(x_raw, p.conv_w, p.conv_b, state=cache["conv"].to(x_raw.dtype))
    _, z, dt, bc, cc = _ssm_inputs(p, xz, engine, "decode", cfg)

    a = -torch.exp(p.a_log.to(f32))
    y, h = ssm_step(cache["h"], *(t[:, 0].to(f32) for t in (dt, xc, bc, cc)), a)
    y = y + xc[:, 0].to(f32) * p.d_skip.to(f32)
    y = y * F.silu(z[:, 0].to(f32))
    out = engine.linear(p.out_proj, y[:, None].to(x_star.dtype), "decode")
    return out, {"h": h, "conv": conv_state}


def mamba_make_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    di, n = cfg.d_inner_, cfg.ssm_state
    return {"h": torch.zeros(batch, di, n, dtype=torch.float32, device=device),
            "conv": torch.zeros(batch, cfg.conv_width - 1, di, dtype=torch.float32,
                                device=device)}
