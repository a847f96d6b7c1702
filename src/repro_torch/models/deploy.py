"""Deployment PTQ pass — Section III applied to a whole model.

`deploy_quantize` attaches the serving formats to every `Linear`:

    w [, b]  ->  w8_vals, w8_scale (prefill W8A8),
                 mx_packed, mx_exps (decode MXINT4, where N % 32 == 0) [, b]

and drops the master weight, except where the math uses the matrix itself
rather than an ``x @ W`` product: MLA's ``wk_b``/``wv_b``, which absorbed
decode folds into the query and the output (`KEEP_MASTER`, the reference's
rule).  Conv, ``a_log`` and ``d_skip`` of a Mamba mixer are no linears and
stay as they are.  ``w8_vals`` keeps the reference's logical ``[K, N]``
shape and values but is stored K-major (`k_major`), the layout the int8
tensor-core GEMM reads, so no call ever transposes it; where K or N is not
a multiple of 16 (hymba's ``x_proj`` N 132 and ``dt_proj`` K 100) it is
zero-padded to multiples of 16, as is the bias of such a linear
(`padded_vector`), and the linear's ``shape`` keeps the logical ``[K, N]``.
It works in place, one linear at
a time, so a full-width model never holds its master and deployed weights
at once.  Per-layer modules quantize per layer, as the reference's vmap over
its ``[L, ...]`` stacks does.

A MoE layer's expert stacks (`mlp.Experts`) get MXINT4 only, no INT8 copy
(the reference's ``quantize_stacked``): each expert's ``[K, N]`` is
quantized as a linear's weight is, one expert at a time into the stack's
``<name>_packed`` / ``<name>_exps``, and the master stack is dropped before
the next is quantized.
"""

from __future__ import annotations

import re

import torch
from torch import nn

from repro_torch.core import mxint4 as mx
from repro_torch.kernels.ops import up16
from repro_torch.models.mlp import EXPERT_WEIGHTS, Experts
from repro_torch.models.modules import Linear


# Linears whose master weight survives deployment (matched on the module's
# name): MLA's absorbed-decode einsums read the matrix itself.
KEEP_MASTER = re.compile(r"(wk_b|wv_b)$")


def _mx_ok(w: torch.Tensor) -> bool:
    """MXINT4 packing needs N % 32 == 0 (2 nibbles x group 16)."""
    return w.shape[-1] % (2 * mx.GROUP_SIZE) == 0


def k_major(w8: torch.Tensor) -> torch.Tensor:
    """``[K, N]`` int8 -> ``[up16(K), up16(N)]`` held K-major (the transpose
    of a contiguous buffer, ``.t().is_contiguous()``): ``w8`` in its leading
    ``[K, N]`` corner, zeros around it (none where K and N are multiples of
    16).  The GEMM reads it whole and slices its output back to N."""
    k, n = w8.shape
    buf = torch.zeros(up16(n), up16(k), dtype=w8.dtype, device=w8.device)
    buf[:n, :k] = w8.t()
    return buf.t()


def padded_vector(v: torch.Tensor) -> torch.Tensor:
    """A per-column vector ``[N]`` zero-padded to ``[up16(N)]`` (itself when
    N is a multiple of 16)."""
    n = v.shape[0]
    return v if n == up16(n) else torch.nn.functional.pad(v, (0, up16(n) - n))


def is_master(model: nn.Module) -> bool:
    """True while the model still carries un-deployed master weights."""
    head = model.lm_head
    return head.w is not None and head.w8_vals is None


def quantize_stacked(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """MXINT4 of an ``[E, K, N]`` expert stack, expert by expert: (packed
    int8 ``[E, K, N/2]``, exps uint8 ``[E, K, N/32]``)."""
    e, k, n = w.shape
    packed = torch.empty(e, k, n // 2, dtype=torch.int8, device=w.device)
    exps = torch.empty(e, k, n // 32, dtype=torch.uint8, device=w.device)
    for i in range(e):
        q = mx.quantize_mxint4(w[i])
        packed[i], exps[i] = q.packed, q.exps_packed
    return packed, exps


@torch.no_grad()
def _deploy_experts(ex: Experts) -> None:
    for name in EXPERT_WEIGHTS:
        w = getattr(ex, name)
        packed, exps = quantize_stacked(w.data)
        setattr(ex, name, None)
        del w
        setattr(ex, f"{name}_packed", packed)
        setattr(ex, f"{name}_exps", exps)


@torch.no_grad()
def deploy_quantize(model: nn.Module) -> nn.Module:
    """Quantize every master linear and expert stack of ``model`` in place;
    returns it."""
    for ex in model.modules():
        if isinstance(ex, Experts) and not ex.deployed:
            _deploy_experts(ex)
    for name, lin in model.named_modules():
        if not isinstance(lin, Linear) or lin.w is None or lin.w8_vals is not None:
            continue
        w = lin.w.data
        q8 = mx.quantize_int8_tensor(w)
        lin.w8_vals, lin.w8_scale = k_major(q8.values), q8.scale
        if lin.b is not None:
            lin.b = padded_vector(lin.b)
        if _mx_ok(w):
            q4 = mx.quantize_mxint4(w)
            lin.mx_packed, lin.mx_exps = q4.packed, q4.exps_packed
        if not KEEP_MASTER.search(name):
            lin.w = None
    return model
