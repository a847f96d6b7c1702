"""Carry the reference's parameter tree over into the port's modules.

The input is the JAX param tree as nested dicts of numpy arrays (the caller
converts with ``jax.device_get``; this module imports neither jax nor the JAX
package).  Per-layer params arrive stacked ``[L, ...]`` per layer group
(`lm.layer_groups`: ``"dense_head"`` then ``"blocks"`` for deepseek-v3,
``"blocks"`` alone otherwise) and are sliced per layer, in group order.  The
multi-token-prediction head (``"mtp"``) is left out by name: the port does
not build it.  Every leaf is copied byte for byte, so int8 and
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
from repro_torch.models.modules import FORMATS, MLA, Attention, Linear, Norm

# Top-level entries of the reference's tree that the port does not build.
SKIPPED = ("mtp",)
MLA_PARTS = ("wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wk_b", "wv_b", "wo")


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


def _block(d: dict, cfg: ModelConfig, kind: str, device):
    """One layer's subtree -> its group's block kind: a `RetNetBlock`
    (``ret``) or a `DenseBlock` (``attn``: GQA, or `MLA` for deepseek-v3)."""
    f = d["mlp"]
    mlp = M.MLP(_linear(f["wi"], device), _linear(f["wo"], device),
                _linear(f["wg"], device) if "wg" in f else None)
    ln1, ln2 = _norm(d["ln1"], device), _norm(d["ln2"], device)
    if kind == "retnet":
        r = d["ret"]
        ret = R.Retention(*(_linear(r[n], device)
                            for n in ("wq", "wk", "wv", "wg", "wo")))
        return lm.RetNetBlock(ln1, ret, ln2, mlp)
    a = d["attn"]
    if cfg.attn_type == "mla":
        attn = MLA(*((_norm if n.endswith("norm") else _linear)(a[n], device)
                     for n in MLA_PARTS))
    else:
        attn = Attention(*(_linear(a[n], device) for n in ("wq", "wk", "wv", "wo")),
                         *(_norm(a[n], device) if n in a else None
                           for n in ("qnorm", "knorm")))
    return lm.DenseBlock(ln1, attn, ln2, mlp)


def _check_stack(tree, count: int, path: str) -> None:
    """Every leaf of a layer group's subtree stacks ``count`` layers."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _check_stack(v, count, f"{path}/{k}")
    elif np.shape(tree)[:1] != (count,):
        raise ValueError(f"{path}: stacks {np.shape(tree)[:1]} layers, the group has {count}")


def model_from_tree(cfg: ModelConfig, tree: dict, device="cpu") -> lm.LM:
    """The reference's (master or deployed) param tree -> the port's `LM`."""
    lm._check_family(cfg)
    groups = lm.layer_groups(cfg)
    known = {"embed", "final_norm", "lm_head", *SKIPPED, *(g for g, _, _ in groups)}
    if set(tree) - known:
        raise ValueError(f"unknown entries in the param tree: {sorted(set(tree) - known)}")
    blocks = []
    for gname, count, kind in groups:
        _check_stack(tree[gname], count, gname)
        blocks += [_block(_layer(tree[gname], i), cfg, kind, device) for i in range(count)]
    return lm.LM(to_tensor(tree["embed"], device), blocks,
                 _norm(tree["final_norm"], device),
                 _linear(tree["lm_head"], device))
