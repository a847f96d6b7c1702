"""Carry the reference's parameter tree over into the port's modules.

The input is the JAX param tree as nested dicts of numpy arrays (the caller
converts with ``jax.device_get``; this module imports neither jax nor the JAX
package).  Per-layer params arrive stacked ``[L, ...]`` under ``"blocks"``
and are sliced per layer.  Every leaf is copied byte for byte, so int8 and
uint8 quantized leaves keep their exact bits.  numpy has no bfloat16 of its
own: jax's bf16 arrays arrive as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects, so they are reinterpreted through ``uint16``.
A deployed ``w8_vals`` is stored K-major, as `deploy.k_major` holds it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import deploy, lm
from repro_torch.models import mlp as M
from repro_torch.models import retnet as R
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import FORMATS, Attention, Linear, Norm


def to_tensor(a, device="cpu") -> torch.Tensor:
    """numpy array (bf16 included) -> torch tensor with the same bytes."""
    a = np.array(a, order="C")          # a writable copy; keeps 0-d shapes
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _layer(tree, i):
    """Slice layer ``i`` out of a stacked subtree (``i=None``: not stacked)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree if i is None else tree[i]


def _linear(d: dict, device) -> Linear:
    formats = {k: to_tensor(d[k], device) for k in FORMATS if k in d}
    if "w8_vals" in formats:
        formats["w8_vals"] = deploy.k_major(formats["w8_vals"])
    return Linear(to_tensor(d["w"], device) if "w" in d else None, **formats)


def _norm(d: dict, device) -> Norm:
    return Norm(to_tensor(d["g"], device))


def _block(d: dict, cfg: ModelConfig, device):
    """One layer's subtree -> the config's block kind: a `RetNetBlock`
    (``ret``) or a `DenseBlock` (``attn``)."""
    f = d["mlp"]
    mlp = M.MLP(_linear(f["wi"], device), _linear(f["wo"], device),
                _linear(f["wg"], device) if "wg" in f else None)
    ln1, ln2 = _norm(d["ln1"], device), _norm(d["ln2"], device)
    if lm.block_class(cfg) is lm.RetNetBlock:
        r = d["ret"]
        ret = R.Retention(*(_linear(r[n], device)
                            for n in ("wq", "wk", "wv", "wg", "wo")))
        return lm.RetNetBlock(ln1, ret, ln2, mlp)
    a = d["attn"]
    attn = Attention(*(_linear(a[n], device) for n in ("wq", "wk", "wv", "wo")),
                     *(_norm(a[n], device) if n in a else None
                       for n in ("qnorm", "knorm")))
    return lm.DenseBlock(ln1, attn, ln2, mlp)


def model_from_tree(cfg: ModelConfig, tree: dict, device="cpu") -> lm.LM:
    """The reference's (master or deployed) param tree -> the port's `LM`."""
    lm._check_family(cfg)
    blocks = [_block(_layer(tree["blocks"], i), cfg, device)
              for i in range(cfg.n_layers)]
    return lm.LM(to_tensor(tree["embed"], device), blocks,
                 _norm(tree["final_norm"], device),
                 _linear(tree["lm_head"], device))
