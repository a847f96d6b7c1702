"""Plain PyTorch versions of the Hopper kernels.

Each function defines what its kernel must compute.  The CPU path of
kernels/ops.py runs them, and chip_smoke.py holds each kernel against them on
the card.  They repeat the kernels' arithmetic; they are no yardstick of speed.
"""

from __future__ import annotations

import torch

from repro_torch.core import fused_rmsnorm as fr
from repro_torch.core import kvq
from repro_torch.core import mxint4 as mx
from repro_torch.core import retention as ret


def _epilogue(y, out_scale, row_scale, bias, out_dtype):
    if out_scale is not None:
        y = y * out_scale
    if row_scale is not None:
        y = y * row_scale[:, None]
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


def mxint4_matmul_ref(x, q: mx.MXINT4Weight, out_scale=None, row_scale=None,
                      bias=None, out_dtype=torch.float32) -> torch.Tensor:
    """y = (x @ dequant(q)) * out_scale * row_scale + bias — the MVM dataflow."""
    w = mx.dequantize_mxint4(q, dtype=torch.float32)
    return _epilogue(x.to(torch.float32) @ w, out_scale, row_scale, bias,
                     out_dtype)


def mxint4_expert_matmul_ref(x, packed, exps_packed, expert_ids) -> torch.Tensor:
    """``y[a] = x[a] @ dequant(W[expert_ids[a]])`` in f32: each row times its
    own expert's MXINT4 weight from the stacks ``packed`` ``[E, K, N/2]`` /
    ``exps_packed`` ``[E, K, N/32]`` (gather the experts, dequantize, bmm)."""
    w = mx.dequantize_stacked(packed.index_select(0, expert_ids),
                              exps_packed.index_select(0, expert_ids))
    return torch.bmm(x.to(torch.float32)[:, None], w)[:, 0]


def w8a8_matmul_ref(x_q, w_q, combined_scale, row_scale=None, bias=None,
                    out_dtype=torch.float32) -> torch.Tensor:
    """int8 x int8 -> exact integer accumulate -> f32, then the epilogue.

    torch has no int8 GEMM on the CPU; float64 is exact here because
    127^2 * K < 2^53, and rounding that integer to f32 matches int32 -> f32.
    """
    acc = (x_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.float32)
    return _epilogue(acc, combined_scale, row_scale, bias, out_dtype)


def retention_chunkwise_ref(q, k, v, gamma, chunk=128, state=None):
    """Chunkwise retention (identical math to the kernel)."""
    return ret.retention_chunkwise(q, k, v, gamma, chunk=chunk, state=state)


def retention_chunkwise_bwd_ref(q, k, v, gamma, state, dy, dstate, chunk=128):
    """The backward kernel's function: ``torch.autograd.grad`` of
    `retention_chunkwise_ref` at (q, k, v, state) against the cotangents dy
    and dstate (None: zero) -> (dq, dk, dv, dstate0; dstate0 None without a
    state)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
        st = None if state is None else state.detach().requires_grad_(True)
        y, s_out = retention_chunkwise_ref(*ins, gamma, chunk=chunk, state=st)
        outs, cots = [y], [dy]
        if dstate is not None:
            outs.append(s_out)
            cots.append(dstate)
        grads = torch.autograd.grad(outs, ins + ([st] if st is not None else []), cots)
    return (*grads[:3], grads[3] if st is not None else None)


def rmsnorm_stats_ref(y: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """sigma^{-1} per row of ``[M, D]`` (the fused-RMSNorm producer) -> f32 [M]."""
    return fr.rms_sigma_inv(y, eps)


def flash_decode_ref(q, k, v, kv_len: torch.Tensor, *, q2=None, k2=None, scale=None
                     ) -> torch.Tensor:
    """Single-token decode attention over the first ``kv_len`` cache rows
    (``kv_len`` an int32 scalar tensor, as the Pallas kernel's operand is,
    or an int32 ``[B]`` tensor with each batch lane's own length, as the
    reference's kernel computes under ``vmap`` over a slot class).

    Two layouts, as the reference's `flash_decode_ref`, operation for
    operation:

    GQA (``q.ndim == 4``): q ``[B, KV, G, d]``; k/v ``[B, C, KV, *]`` cache
        leaves (f32/bf16/legacy-int8 tensors or kvq-encoded dicts).
        ``scale=None`` divides the scores by sqrt(d).
    MLA (``q.ndim == 3``): q the absorbed latent queries ``[B, H, r]``, k/v
        the latent cache ``[B, C, r]`` (the same leaf on the model path),
        with a second score stream ``q2 [B, H, dr]`` against the shared rope
        key ``k2 [B, C, dr]``; ``s = (q . k + q2 . k2) * scale``, and
        ``scale`` is required.

    Rows at index >= kv_len are masked to -inf before the softmax.
    """
    c = (next(iter(k.values())) if isinstance(k, dict) else k).shape[1]
    if kv_len.ndim:
        valid = torch.arange(c, device=q.device) < kv_len[:, None]     # [B, C]
        valid = valid[:, None, None, :] if q.ndim == 4 else valid[:, None, :]
    else:
        valid = torch.arange(c, device=q.device) < kv_len
    if q.ndim == 4:
        return masked_decode_attention(q, k, v, valid, scale=scale)
    if q2 is None or k2 is None or scale is None:
        raise ValueError("MLA layout (q.ndim == 3) needs q2, k2 and scale")
    kf, vf = kvq.decode(k), kvq.decode(v)
    s_lat = torch.einsum("bhr,bcr->bhc", q.to(torch.float32), kf)
    s_rope = torch.einsum("bhr,bcr->bhc", q2.to(torch.float32), kvq.decode(k2))
    s = (s_lat + s_rope) * scale
    p = torch.softmax(s.masked_fill(~valid, -torch.inf), dim=-1)
    return torch.einsum("bhc,bcr->bhr", p, vf)


def masked_decode_attention(q, k, v, valid: torch.Tensor, *, scale=None
                            ) -> torch.Tensor:
    """softmax(q . k / sqrt(d) masked to -inf where ``valid`` is False) @ v,
    with ``valid`` broadcast against the scores ``[B, KV, G, C]``."""
    kf, vf = kvq.decode(k), kvq.decode(v)
    s = torch.einsum("bhgd,bchd->bhgc", q.to(torch.float32), kf)
    if scale is None:
        # A tensor divisor: on the card torch turns division by a Python
        # scalar into a multiply by its reciprocal.
        d = torch.full((), q.shape[-1], dtype=torch.float32, device=s.device)
        s = s / d.sqrt()
    else:
        s = s * scale
    p = torch.softmax(s.masked_fill(~valid, -torch.inf), dim=-1)
    return torch.einsum("bhgc,bchd->bhgd", p, vf)
