"""RetNet block: multi-scale retention with RoPE-rotated q/k, v and gate at
2 * d_model, per-head GroupNorm and a swish gate.

Prefill runs the chunkwise form (the Hopper kernel for a CUDA tensor), from a
zero state (monolithic and bucketed prefill) or a warm one (each chunk of a
chunked prefill); decode runs the O(1) recurrent step in plain PyTorch, as
the reference does.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import online_rope as orp
from repro_torch.core import retention as ret
from repro_torch.core.hsa import HSAEngine
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import Init, Linear


class Retention(nn.Module):
    def __init__(self, wq: Linear, wk: Linear, wv: Linear, wg: Linear,
                 wo: Linear):
        super().__init__()
        self.wq, self.wk, self.wv, self.wg, self.wo = wq, wk, wv, wg, wo

    @classmethod
    def init(cls, init: Init, cfg: ModelConfig) -> "Retention":
        d = cfg.d_model
        return cls(*(Linear.init(init, k, n) for k, n in
                     ((d, d), (d, d), (d, 2 * d), (d, 2 * d), (2 * d, d))))


def _project(p: Retention, x_star, sig_inv, engine: HSAEngine, phase: str,
             cfg: ModelConfig):
    b, s, d = x_star.shape
    h = cfg.n_heads
    dk, dv = d // h, 2 * d // h
    q = engine.linear(p.wq, x_star, phase, row_scale=sig_inv)
    k = engine.linear(p.wk, x_star, phase, row_scale=sig_inv)
    v = engine.linear(p.wv, x_star, phase, row_scale=sig_inv)
    g = engine.linear(p.wg, x_star, phase, row_scale=sig_inv)
    q = q.reshape(b, s, h, dk) * (dk ** -0.5)
    k = k.reshape(b, s, h, dk) * (dk ** -0.5)   # RetNet scales k too
    return q, k, v.reshape(b, s, h, dv), g


def _gate_out(p: Retention, y, g, engine: HSAEngine, phase: str, b: int,
              s: int, d: int):
    y = ret.group_norm_heads(y)
    y = y.reshape(b, s, 2 * d)
    y = y * F.silu(g.to(torch.float32)).to(y.dtype)
    return engine.linear(p.wo, y, phase)


def retention_apply(p: Retention, x_star, sig_inv, engine: HSAEngine,
                    phase: str, cfg: ModelConfig, *, rope_sin=None,
                    rope_cos=None, cache: dict | None = None,
                    valid_len: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """Full-sequence (chunkwise) retention -> (out, {"s": final state}).

    ``cache`` (chunked prefill) carries the state across chunks: the
    outputs and the new state include the decayed contribution of
    everything before this chunk (the kernel's ``state=``).  ``valid_len``
    (bucketed prefill; an int32 scalar on the device) masks the padded tail
    out of the state: its k/v rows are zeroed and the final state is
    rescaled by ``gamma^(valid_len - s)``, computed as the reference does,
    ``exp((valid_len - s) * log gamma)`` in f32, to undo the decay the
    padded steps applied.  Every length runs the chunkwise kernel: the whole
    128-row chunks in one launch, then the tail (``s % 128`` rows, or all of
    a shorter ``s``) as one chunk from the state the first launch carried.
    The reference takes its parallel or plain chunkwise form where ``s`` is
    not whole chunks of ``min(128, s)``; the two agree up to f32 summation
    order.
    """
    b, s, d = x_star.shape
    q, k, v, g = _project(p, x_star, sig_inv, engine, phase, cfg)
    if rope_sin is not None:
        sin, cos = rope_sin[None, :, None, :], rope_cos[None, :, None, :]
        q, k = orp.apply_rope(q, sin, cos), orp.apply_rope(k, sin, cos)
    gamma = ret.head_decays(cfg.n_heads, device=q.device)
    if valid_len is not None:
        keep = (torch.arange(s, device=q.device) < valid_len)[None, :, None, None]
        k, v = k * keep, v * keep
    # [B, H, S, d*] views of the [B, S, H, d*] projections, handed to the
    # kernel as they are (it reads through their strides).  The kernel's y
    # is a [B, H, S, dv] view of a [B, S, H, dv] buffer, so the transpose
    # back is contiguous (two launches' parts are joined along S into one
    # such buffer) and _gate_out's reshape copies nothing.
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    state = None if cache is None else cache["s"]
    whole = s - s % 128
    ys = []
    for lo, hi, chunk in ((0, whole, 128), (whole, s, s - whole)):
        if hi > lo:
            part = slice(lo, hi)
            y, state = ops.retention_chunkwise(
                qt[:, :, part], kt[:, :, part], vt[:, :, part], gamma, chunk=chunk,
                state=state, impl=engine.config.kernel_impl)
            ys.append(y.transpose(1, 2))
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    if valid_len is not None:
        undo = torch.exp((valid_len - s).to(torch.float32) * torch.log(gamma))
        state = state * undo[None, :, None, None]
    out = _gate_out(p, y, g, engine, phase, b, s, d)
    return out, {"s": state}


@functools.lru_cache(maxsize=None)
def _decays(n_heads: int, device: torch.device) -> torch.Tensor:
    """The per-head decays decode reads, computed once per head count and
    device.  Callers must not modify the tensor."""
    return ret.head_decays(n_heads, device=device)


def retention_decode(p: Retention, x_star, sig_inv, engine: HSAEngine,
                     cfg: ModelConfig, cache: dict, *, rope_sin=None,
                     rope_cos=None) -> tuple[torch.Tensor, dict]:
    """O(1)-state recurrent step — the decode workload.  ``rope_sin`` /
    ``rope_cos`` are the shared ``[d/2]`` angles or per-lane ``[B, d/2]``
    ones."""
    b, _, d = x_star.shape
    q, k, v, g = _project(p, x_star, sig_inv, engine, "decode", cfg)
    if rope_sin is not None:
        sin, cos = orp.lane_angles(rope_sin, q.ndim), orp.lane_angles(rope_cos, q.ndim)
        q = orp.apply_rope(q, sin, cos)
        k = orp.apply_rope(k, sin, cos)
    y, state = ret.retention_recurrent_step(q[:, 0], k[:, 0], v[:, 0], cache["s"],
                                            _decays(cfg.n_heads, q.device))
    return _gate_out(p, y, g, engine, "decode", b, 1, d), {"s": state}


def retention_make_cache(cfg: ModelConfig, batch: int, device) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    return {"s": torch.zeros(batch, h, d // h, 2 * d // h, dtype=torch.float32,
                             device=device)}
