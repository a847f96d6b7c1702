"""Public wrappers around the Hopper kernels.

Implementation selection (``impl``):
  'kernel' — the CUDA kernel; raises for a tensor that is not on the card
  'ref'    — the plain PyTorch version from ref.py
  'auto'   — 'kernel' for a CUDA tensor, 'ref' for a CPU tensor

There is no fallback: a kernel that fails to build or launch raises.  The
wrappers own the shape plumbing: leading batch dims flatten into M, absent
epilogue operands default to identities (exact: x * 1 and x + 0), the
retention op hands the kernel its strided views and an initial state, and
flash-decode splits each cache leaf into the arrays its format keeps.
"""

from __future__ import annotations

import torch

from repro_torch.core import kvq
from repro_torch.core.mxint4 import MXINT4Weight
from repro_torch.kernels import ref as _ref

IMPLS = ("auto", "kernel", "ref")


def use_kernel(impl: str, t: torch.Tensor) -> bool:
    """Resolve ``impl`` against the device of the tensor the op will run on."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "ref":
        return False
    if impl == "kernel" and not t.is_cuda:
        raise ValueError(f"impl='kernel' needs a CUDA tensor, got {t.device}")
    return t.is_cuda


def _vec(v, n: int, fill: float, like: torch.Tensor) -> torch.Tensor:
    if v is None:
        return torch.full((n,), fill, dtype=torch.float32, device=like.device)
    v = torch.as_tensor(v, dtype=torch.float32, device=like.device)
    return v.broadcast_to((n,)).contiguous()


def mxint4_matmul(x, q: MXINT4Weight, out_scale=None, row_scale=None, bias=None,
                  *, out_dtype=torch.float32, impl: str = "auto") -> torch.Tensor:
    """Decode-path quantized matmul with the Eq. (4) fused epilogue.

    ``x`` may have leading batch dims; they are flattened into M.
    """
    lead, k, n = x.shape[:-1], x.shape[-1], q.shape[1]
    x2 = x.reshape(-1, k)
    rs = None if row_scale is None else row_scale.reshape(-1)
    if not use_kernel(impl, x2):
        y = _ref.mxint4_matmul_ref(x2, q, out_scale, rs, bias, out_dtype)
        return y.reshape(*lead, n)
    from repro_torch.kernels import hopper
    y = hopper.mxint4_matmul(
        x2.to(torch.float32).contiguous(), q.packed.contiguous(),
        q.exps_packed.contiguous(), _vec(out_scale, n, 1.0, x2),
        _vec(rs, x2.shape[0], 1.0, x2), _vec(bias, n, 0.0, x2))
    return y.to(out_dtype).reshape(*lead, n)


def w8a8_matmul(x_q, w_q, combined_scale, row_scale=None, bias=None, *,
                out_dtype=torch.float32, impl: str = "auto") -> torch.Tensor:
    """Prefill MMM path: int8 x int8 -> int32, then the drain epilogue.

    The kernel takes ``w_q`` ``[K, N]`` K-major (``w_q.t()`` contiguous, as
    `deploy.k_major` stores it) and raises on any other layout: W is never
    copied per call.
    """
    lead, k, n = x_q.shape[:-1], x_q.shape[-1], w_q.shape[1]
    x2 = x_q.reshape(-1, k)
    rs = None if row_scale is None else row_scale.reshape(-1)
    if not use_kernel(impl, x2):
        y = _ref.w8a8_matmul_ref(x2, w_q, combined_scale, rs, bias, out_dtype)
        return y.reshape(*lead, n)
    from repro_torch.kernels import hopper
    y = hopper.w8a8_matmul(
        x2.contiguous(), w_q, _vec(combined_scale, n, 1.0, x2),
        _vec(rs, x2.shape[0], 1.0, x2), _vec(bias, n, 0.0, x2))
    return y.to(out_dtype).reshape(*lead, n)


def retention_chunkwise(q, k, v, gamma, *, chunk: int = 128, state=None,
                        impl: str = "auto"):
    """q, k ``[B, H, S, dk]``, v ``[B, H, S, dv]``, gamma ``[H]``, optional
    state ``[B, H, dk, dv]`` -> (y in v's dtype, final f32 state).

    The kernel reads q, k and v through their own strides (the model's
    ``transpose(1, 2)`` views as they are; `hopper.check_retention_operand`
    raises on a layout it does not take) and returns y as a ``[B, H, S, dv]``
    view of a ``[B, S, H, dv]`` buffer, so transposing it back is free.
    Inputs that are not f32 are cast (the model's are f32).
    """
    if not use_kernel(impl, q):
        return _ref.retention_chunkwise_ref(q, k, v, gamma, chunk=chunk,
                                            state=state)
    from repro_torch.kernels import hopper
    f32 = torch.float32
    y, st = hopper.retention_chunkwise(
        q.to(f32), k.to(f32), v.to(f32), gamma.to(f32),
        None if state is None else state.to(f32), chunk)
    return y.to(v.dtype), st


def _cache_parts(leaf) -> tuple[tuple, str]:
    """A cache leaf -> ((values, side or None), the kernel's format name)."""
    fmt = kvq.leaf_format(leaf)
    if fmt == "int8_tok":
        return (leaf["q"], leaf["s"]), fmt
    if fmt == "mxint4_blk":
        return (leaf["m"], leaf["e"]), fmt
    name = {torch.float32: "f32", torch.bfloat16: "bf16",
            torch.int8: "int8"}.get(leaf.dtype)
    if name is None:
        raise TypeError(f"flash_decode: no kernel for a {leaf.dtype} cache")
    return (leaf, None), name


def flash_decode(q, k, v, kv_len: torch.Tensor, *, q2=None, k2=None, scale=None,
                 impl: str = "auto") -> torch.Tensor:
    """Single-token decode attention over the first ``kv_len`` cache rows.

    Two layouts (see `ref.flash_decode_ref`).  GQA: q ``[B, KV, G, d]``, k/v
    ``[B, C, KV, *]`` cache leaves; ``scale=None`` divides the scores by
    sqrt(d); returns f32 ``[B, KV, G, dv]``.  MLA (``q.ndim == 3``): q
    ``[B, H, r]`` against the latent cache k = v ``[B, C, r]``, plus the rope
    stream ``q2 [B, H, dr]`` . ``k2 [B, C, dr]``; ``scale`` is required;
    returns f32 ``[B, H, r]``.  The MLA kernel reads each latent row once as
    both K and V, so on the card ``v`` must be the very leaf ``k`` and share
    its format with ``k2``.

    Leaves are f32, bf16 or legacy int8 tensors, or kvq-encoded dicts, which
    the kernels dequantize as they load them.  ``kv_len`` is an int32 scalar
    tensor on the device, in ``[1, C]``, as the Pallas kernel's operand is,
    or an int32 ``[B]`` tensor with each lane's own length (a slot class
    whose lanes sit at different positions): the kernels read it from
    device memory and their grid is fixed by the capacity C, so one
    captured launch serves every position.
    """
    from repro_torch.kernels import hopper
    hopper.check_kv_len(kv_len, q.device, q.shape[0])
    if q.ndim == 3 and (q2 is None or k2 is None or scale is None):
        raise ValueError("MLA layout (q.ndim == 3) needs q2, k2 and scale")
    if not use_kernel(impl, q):
        return _ref.flash_decode_ref(q, k, v, kv_len, q2=q2, k2=k2, scale=scale)
    if q.ndim == 3:
        if v is not k:
            raise ValueError("flash_decode (MLA): the kernel reads each latent row once "
                             "as both K and V, so v must be the same leaf as k")
        (lat, fmt), (rope, rope_fmt) = _cache_parts(k), _cache_parts(k2)
        if rope_fmt != fmt:
            raise ValueError(f"flash_decode (MLA): the latent ({fmt}) and rope "
                             f"({rope_fmt}) caches must share one format")
        return hopper.flash_decode_mla(q.to(torch.float32).contiguous(),
                                       q2.to(torch.float32).contiguous(), lat, rope, fmt,
                                       kv_len, float(scale))
    (kp, kf), (vp, vf) = _cache_parts(k), _cache_parts(v)
    return hopper.flash_decode(q.to(torch.float32).contiguous(), kp, kf, vp, vf,
                               kv_len, scale)


def rmsnorm_stats(y, *, eps: float = 1e-6, impl: str = "auto") -> torch.Tensor:
    """sigma^{-1} over the last axis (f32); leading dims preserved.

    The kernel reads a view whose rows lie one stride apart in place (no
    copy); a layout whose leading dims do not flatten to one stride, or
    whose rows' elements are not adjacent, raises.
    """
    lead = y.shape[:-1]
    if not use_kernel(impl, y):
        return _ref.rmsnorm_stats_ref(y.reshape(-1, y.shape[-1]), eps).reshape(lead)
    from repro_torch.kernels import hopper
    try:
        y2 = y.view(-1, y.shape[-1])
    except RuntimeError as e:
        raise ValueError(f"rmsnorm_stats: the kernel reads rows one stride apart; strides "
                         f"{tuple(y.stride())} do not flatten to that") from e
    return hopper.rmsnorm_stats(y2, eps)[:, 0].reshape(lead)
