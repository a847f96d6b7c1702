"""QuantizedLinear — one weight, three execution paths.

One logical weight ``W[K, N]`` stored in up to three formats:

  * ``w``   — bf16/f32 master (absent once deployed)
  * ``w8``  — per-tensor INT8 (prefill MMM dataflow, the W8A8 kernel)
  * ``mx``  — MXINT4 packed + group shifts (decode MVM dataflow)

`apply` runs the phase's format with the Eq. (4) epilogue (``row_scale`` =
sigma^{-1} from the upstream fused RMSNorm, ``bias``).  Unlike the
reference, ``impl`` reaches the W8A8 prefill path too.

``lane_act=True`` quantizes the W8A8 activations with one scale per lane
(the leading axis of ``x``) instead of one over the tensor, and folds each
lane's scale into its rows' ``row_scale``: a slot class's batched verify
block, whose lanes must not see each other's absmax.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import mxint4 as mx
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class QuantizedLinearParams:
    w: torch.Tensor | None            # [K, N] master
    w8: mx.Int8Weight | None          # prefill format
    mx: mx.MXINT4Weight | None        # decode format
    bias: torch.Tensor | None         # [N] (W8A8: padded as ``w8``)
    n: int | None = None              # logical N where ``w8`` is zero-padded


def apply(params: QuantizedLinearParams, x: torch.Tensor, phase: str, *,
          row_scale=None, out_scale=None, impl: str = "auto",
          out_dtype=torch.float32, lane_act: bool = False) -> torch.Tensor:
    """``y = (x @ W) * out_scale * row_scale + bias`` in the phase's format."""
    if phase == "train" or (phase == "prefill" and params.w8 is None):
        if params.w is None:
            raise TypeError("master weight required for train phase")
        # The un-quantized product is a plain matmul, as the reference
        # leaves it to XLA.
        y = x.to(torch.float32) @ params.w.to(torch.float32)
        if out_scale is not None:
            y = y * out_scale
        if row_scale is not None:
            y = y * row_scale[..., None]
        if params.bias is not None:
            y = y + params.bias
        return y.to(out_dtype)

    if phase == "prefill":
        # MMM dataflow: dynamic per-tensor A8, per-tensor W8, int32 accumulate.
        if lane_act:
            xq, lane_scale = mx.quantize_act_int8_lanes(x)
            rows = lane_scale.reshape(-1, *([1] * (x.ndim - 2))).expand(x.shape[:-1])
            combined = params.w8.scale * (1.0 if out_scale is None else out_scale)
            return ops.w8a8_matmul(xq, params.w8.values, combined,
                                   row_scale=rows if row_scale is None else rows * row_scale,
                                   bias=params.bias, n=params.n, out_dtype=out_dtype,
                                   impl=impl)
        xq, act_scale = mx.quantize_act_int8(x)
        combined = act_scale * params.w8.scale * (
            1.0 if out_scale is None else out_scale)
        return ops.w8a8_matmul(xq, params.w8.values, combined,
                               row_scale=row_scale, bias=params.bias, n=params.n,
                               out_dtype=out_dtype, impl=impl)

    if phase == "decode":
        # MVM dataflow: MXINT4 weights, dequantized inside the kernel.
        os = None
        if out_scale is not None:
            os = torch.as_tensor(out_scale, dtype=torch.float32,
                                 device=x.device).broadcast_to((params.mx.shape[1],))
        return ops.mxint4_matmul(x, params.mx, out_scale=os,
                                 row_scale=row_scale, bias=params.bias,
                                 out_dtype=out_dtype, impl=impl)

    raise ValueError(f"unknown phase: {phase!r}")
