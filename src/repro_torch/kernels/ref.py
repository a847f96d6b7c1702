"""Plain PyTorch versions of the three Hopper kernels.

Each function defines what its kernel must compute.  The CPU path of
kernels/ops.py runs them, and chip_smoke.py holds each kernel against them on
the card.  They repeat the kernels' arithmetic; they are no yardstick of speed.
"""

from __future__ import annotations

import torch

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
