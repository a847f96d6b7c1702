"""Deployment PTQ pass — Section III applied to a whole model.

`deploy_quantize` attaches the serving formats to every `Linear`:

    w [, b]  ->  w8_vals, w8_scale (prefill W8A8),
                 mx_packed, mx_exps (decode MXINT4, where N % 32 == 0) [, b]

and drops the master weight, except where the math uses the matrix itself
rather than an ``x @ W`` product: MLA's ``wk_b``/``wv_b``, which absorbed
decode folds into the query and the output (`KEEP_MASTER`, the reference's
rule).  ``w8_vals`` keeps the reference's logical ``[K, N]`` shape and
values but is stored K-major (`k_major`), the layout the int8 tensor-core
GEMM reads, so no call ever transposes it.  It works in place, one linear at
a time, so a full-width model never holds its master and deployed weights
at once.  Per-layer modules quantize per layer, as the reference's vmap over
its ``[L, ...]`` stacks does.
"""

from __future__ import annotations

import re

import torch
from torch import nn

from repro_torch.core import mxint4 as mx
from repro_torch.models.modules import Linear


# Linears whose master weight survives deployment (matched on the module's
# name): MLA's absorbed-decode einsums read the matrix itself.
KEEP_MASTER = re.compile(r"(wk_b|wv_b)$")


def _mx_ok(w: torch.Tensor) -> bool:
    """MXINT4 packing needs N % 32 == 0 (2 nibbles x group 16)."""
    return w.shape[-1] % (2 * mx.GROUP_SIZE) == 0


def k_major(w8: torch.Tensor) -> torch.Tensor:
    """``[K, N]`` int8 -> the same ``[K, N]`` values held as the transpose of a
    contiguous ``[N, K]`` buffer (``w8.t().is_contiguous()``)."""
    return w8.t().contiguous().t()


def is_master(model: nn.Module) -> bool:
    """True while the model still carries un-deployed master weights."""
    head = model.lm_head
    return head.w is not None and head.w8_vals is None


@torch.no_grad()
def deploy_quantize(model: nn.Module) -> nn.Module:
    """Quantize every master linear of ``model`` in place; returns it."""
    for name, lin in model.named_modules():
        if not isinstance(lin, Linear) or lin.w is None or lin.w8_vals is not None:
            continue
        w = lin.w.data
        q8 = mx.quantize_int8_tensor(w)
        lin.w8_vals, lin.w8_scale = k_major(q8.values), q8.scale
        if _mx_ok(w):
            q4 = mx.quantize_mxint4(w)
            lin.mx_packed, lin.mx_exps = q4.packed, q4.exps_packed
        if not KEEP_MASTER.search(name):
            lin.w = None
    return model
