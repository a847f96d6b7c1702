"""Carry the reference's parameter tree over into the port's modules.

The input is the JAX param tree as nested dicts of numpy arrays (the caller
converts with ``jax.device_get``; this module imports neither jax nor the JAX
package).  Per-layer params arrive stacked ``[L, ...]`` per layer group
(`lm.layer_groups`: ``"dense_head"`` then ``"blocks"`` for deepseek-v3,
``"blocks"`` alone otherwise) and are sliced per layer, in group order.  The
multi-token-prediction head (``"mtp"``: ``proj`` and one unstacked block of
the family's kind) becomes the model's `lm.MTPHead`.  An encoder-decoder's
``"enc_blocks"`` (stacked) become `lm.LM.enc_blocks`, each decoder layer
carries ``ln_cross`` and ``cross`` (an attention), and ``enc_final_norm``
is the encoder's final norm.  A norm carries its
gain ``g`` and, in a LayerNorm model, its bias ``b``.  Every leaf is copied
byte for byte, so int8 and uint8 quantized leaves keep their exact bits.
numpy has no bfloat16 of its own: jax's bf16 arrays arrive as
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects, so they are
reinterpreted through ``uint16``.
A deployed ``w8_vals`` is stored K-major, as `deploy.k_major` holds it (with
its bias, zero-padded to multiples of 16 where the GEMM needs that; the
linear's ``shape`` keeps the tree's ``[K, N]``).  A MoE layer's ``moe``
subtree gives its router (a linear), its expert stacks (``experts.{wg, wi,
wo}``, or deployed ``experts.{wg, wi, wo}_mx.{packed, exps}``) and its
shared experts (an MLP).

Training: `flat_tree` names every leaf of a tree shaped like the params (the
params, the optimizer's moments, a gradient or residual tree) by the port's
master names (`lm.train_leaves`: ``blocks.<i>.ret.wq.w``, ``final_norm.g``,
...), cutting the stacked leaves per layer; `train_state_from_tree` carries
the reference's train state (``params``, ``opt.{m, v, step}`` and
``residuals``) into the port's (`runtime.train_step.init_state`'s layout),
and `grads_from_tree` a gradient tree.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import deploy, lm
from repro_torch.models import mlp as M
from repro_torch.models import retnet as R
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import FORMATS, MLA, Attention, Linear, Norm

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
    shape = (d["w"] if "w" in d else d["w8_vals"]).shape
    if "w8_vals" in formats:
        formats["w8_vals"] = deploy.k_major(formats["w8_vals"])
        if "b" in formats:
            formats["b"] = deploy.padded_vector(formats["b"])
    return Linear(to_tensor(d["w"], device) if "w" in d else None, shape=shape, **formats)


def _norm(d: dict, device) -> Norm:
    return Norm(to_tensor(d["g"], device), to_tensor(d["b"], device) if "b" in d else None)


def _mamba(d: dict, device) -> S.Mamba:
    return S.Mamba(_linear(d["in_proj"], device), to_tensor(d["conv_w"], device),
                   to_tensor(d["conv_b"], device), _linear(d["x_proj"], device),
                   _linear(d["dt_proj"], device), to_tensor(d["a_log"], device),
                   to_tensor(d["d_skip"], device), _linear(d["out_proj"], device))


def _attention(a: dict, device) -> Attention:
    return Attention(*(_linear(a[n], device) for n in ("wq", "wk", "wv", "wo")),
                     *(_norm(a[n], device) if n in a else None for n in ("qnorm", "knorm")))


def _mlp(f: dict, device) -> M.MLP:
    return M.MLP(_linear(f["wi"], device), _linear(f["wo"], device),
                 _linear(f["wg"], device) if "wg" in f else None)


def _moe(d: dict, device) -> M.MoE:
    ex = d["experts"]
    weights = {}
    for n in M.EXPERT_WEIGHTS:
        if n in ex:
            weights[n] = to_tensor(ex[n], device)
        else:
            weights[f"{n}_packed"] = to_tensor(ex[f"{n}_mx"]["packed"], device)
            weights[f"{n}_exps"] = to_tensor(ex[f"{n}_mx"]["exps"], device)
    return M.MoE(_linear(d["router"], device), M.Experts(**weights),
                 _mlp(d["shared"], device) if "shared" in d else None)


def _mla(a: dict, device) -> MLA:
    return MLA(*((_norm if n.endswith("norm") else _linear)(a[n], device)
                 for n in MLA_PARTS))


def _block(d: dict, cfg: ModelConfig, kind: str, device):
    """One layer's subtree -> its group's block kind: a `RetNetBlock`
    (``ret``), a `DenseBlock` (``attn``: GQA, or `MLA` for deepseek-v3), a
    `MoEBlock` (``attn`` and ``moe``), an `SSMBlock` (``mamba``), a
    `HybridBlock` (``attn`` and ``mamba``), an `EncoderBlock` (as a dense
    one) or a `DecoderBlock` (``attn``, ``ln_cross``, ``cross``, ``mlp``)."""
    ln1 = _norm(d["ln1"], device)
    if kind == "ssm":
        return lm.SSMBlock(ln1, _mamba(d["mamba"], device))
    ln2 = _norm(d["ln2"], device)
    if kind == "hybrid":
        return lm.HybridBlock(ln1, _attention(d["attn"], device), _mamba(d["mamba"], device),
                              _norm(d["attn_norm"], device), _norm(d["mamba_norm"], device),
                              ln2, _mlp(d["mlp"], device))
    if kind == "retnet":
        r = d["ret"]
        ret = R.Retention(*(_linear(r[n], device)
                            for n in ("wq", "wk", "wv", "wg", "wo")))
        return lm.RetNetBlock(ln1, ret, ln2, _mlp(d["mlp"], device))
    attn = (_mla if cfg.attn_type == "mla" else _attention)(d["attn"], device)
    if kind == "enc":
        return lm.EncoderBlock(ln1, attn, ln2, _mlp(d["mlp"], device))
    if kind == "dec":
        return lm.DecoderBlock(ln1, attn, _norm(d["ln_cross"], device),
                               _attention(d["cross"], device), ln2, _mlp(d["mlp"], device))
    if kind == "moe":
        return lm.MoEBlock(ln1, attn, ln2, _moe(d["moe"], device))
    return lm.DenseBlock(ln1, attn, ln2, _mlp(d["mlp"], device))


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
    known = {"embed", "final_norm", "lm_head", "mtp", "enc_final_norm",
             *(g for g, _, _ in groups)}
    if set(tree) - known:
        raise ValueError(f"unknown entries in the param tree: {sorted(set(tree) - known)}")
    blocks, enc_blocks = [], []
    for gname, count, kind in groups:
        _check_stack(tree[gname], count, gname)
        (enc_blocks if kind == "enc" else blocks).extend(
            _block(_layer(tree[gname], i), cfg, kind, device) for i in range(count))
    lm.mark_full_attn(cfg, blocks)
    mtp = None
    if "mtp" in tree:
        kind = "moe" if cfg.family == "moe" else "dense"
        mtp = lm.MTPHead(_linear(tree["mtp"]["proj"], device),
                         _block(tree["mtp"]["block"], cfg, kind, device))
    enc_norm = _norm(tree["enc_final_norm"], device) if cfg.is_encdec else None
    return lm.LM(to_tensor(tree["embed"], device), blocks,
                 _norm(tree["final_norm"], device),
                 _linear(tree["lm_head"], device), mtp,
                 enc_blocks=enc_blocks, enc_final_norm=enc_norm)


def _walk(tree, prefix: str):
    """(dotted path, leaf) of every leaf of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def flat_tree(cfg: ModelConfig, tree: dict) -> dict[str, np.ndarray]:
    """A params-shaped tree -> ``{port master name: array}``: each stacked
    ``[L, ...]`` leaf of a layer group cut into its layers, numbered as the
    port's `LM.blocks` (decoder groups in order) or ``enc_blocks``."""
    out, at, groups = {}, 0, lm.layer_groups(cfg)
    for gname, count, kind in groups:
        base, prefix = (0, "enc_blocks") if kind == "enc" else (at, "blocks")
        for path, leaf in _walk(tree[gname], ""):
            for i in range(count):
                out[f"{prefix}.{base + i}.{path}"] = np.asarray(leaf)[i]
        at += 0 if kind == "enc" else count
    names = {g for g, _, _ in groups}
    for key, sub in tree.items():
        if key not in names:
            out.update(_walk(sub, key))
    return out


def _named(cfg: ModelConfig, tree: dict, like: dict, device) -> dict[str, torch.Tensor]:
    flat = flat_tree(cfg, tree)
    if set(flat) != set(like):
        raise ValueError(f"tree and model masters differ: {sorted(set(flat) ^ set(like))[:8]}")
    return {n: to_tensor(flat[n], device) for n in like}


def grads_from_tree(cfg: ModelConfig, grads: dict, device="cpu") -> dict[str, torch.Tensor]:
    """The reference's gradient tree -> gradients by the port's master names."""
    return {n: to_tensor(a, device) for n, a in flat_tree(cfg, grads).items()}


def train_state_from_tree(cfg: ModelConfig, state: dict, device="cpu") -> dict:
    """The reference's train state ``{"params", "opt": {"m", "v", "step"}[,
    "residuals"]}`` (numpy trees) -> the port's ``{"model", "opt"[,
    "residuals"]}``, the model's masters trainable and the moments keyed
    by master name in `lm.train_leaves` order."""
    model = model_from_tree(cfg, state["params"], device)
    leaves = lm.set_trainable(model)
    opt = state["opt"]
    out = {"model": model,
           "opt": {"m": _named(cfg, opt["m"], leaves, device),
                   "v": _named(cfg, opt["v"], leaves, device),
                   "step": torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32,
                                        device=device)}}
    if "residuals" in state:
        out["residuals"] = _named(cfg, state["residuals"], leaves, device)
    return out
