"""Feed-forward layers: ``wo(act(x wi))``, gated with ``silu(x wg)`` when the
MLP carries ``wg`` (RetNet's is ungated: GeLU), and the routed top-k MoE
with capacity dispatch of the reference's `models/mlp.py`.

The MoE routes each token to its top ``k`` of ``E`` experts, fills each
expert's ``cap`` slots slot-major (every token's first choice, then every
token's second, token order breaking ties) and drops the assignments past
``cap`` (`dispatch`), runs the gated expert FFN and sums the kept outputs
gate-weighted per token (`_combine`).  The expert FFN takes one of two
forms, which differ only in f32 summation order:

* ``capacity`` (prefill and prefill chunks: thousands of assignments, every
  expert busy): the reference's ``[E, cap, D]`` buffer through ``torch.bmm``
  on each stack in f32 (deployed stacks dequantized whole, as the reference
  does on every call);
* ``assigned`` (decode steps and speculative verify: at most a few hundred
  assignments): one row per (token, slot), each times its own expert's
  weight, through `ops.mxint4_expert_matmul` on deployed stacks (it reads
  only the addressed experts' MXINT4 bytes, takes the expert ids from
  device memory and launches the same kernels whatever the routing, so the
  step captures into a CUDA graph), and a gather + ``bmm`` on fp stacks;
  dropped rows are computed and masked.

Which tokens share a dispatch follows the engine: the whole ``[B, S]``
input, or each lane (the leading axis) alone under ``per_lane`` (a slot
class's step, the reference's per-slot ``vmap``).  The router's load-balance
loss is read only by training and is not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import mxint4 as mx
from repro_torch.core.hsa import HSAEngine
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import Init, Linear, _param

EXPERT_WEIGHTS = ("wg", "wi", "wo")


class MLP(nn.Module):
    def __init__(self, wi: Linear, wo: Linear, wg: Linear | None = None):
        super().__init__()
        self.wi, self.wo, self.wg = wi, wo, wg

    @classmethod
    def init(cls, init: Init, d: int, f: int, gated: bool = True) -> "MLP":
        wg = Linear.init(init, d, f) if gated else None
        return cls(Linear.init(init, d, f), Linear.init(init, f, d), wg)


def mlp_apply(p: MLP, x_star: torch.Tensor, sig_inv, engine: HSAEngine,
              phase: str) -> torch.Tensor:
    up = engine.linear(p.wi, x_star, phase, row_scale=sig_inv)
    if p.wg is not None:
        gate = engine.linear(p.wg, x_star, phase, row_scale=sig_inv)
        up = F.silu(gate) * up
    else:
        up = F.gelu(up, approximate="tanh")   # jax.nn.gelu's default
    return engine.linear(p.wo, up, phase)


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------


class Experts(nn.Module):
    """Stacked expert weights ``wg``, ``wi`` ``[E, D, F]`` and ``wo``
    ``[E, F, D]`` (``y = x @ W[e]``): the masters, or after deployment their
    MXINT4 stacks ``<name>_packed`` int8 ``[E, K, N/2]`` and ``<name>_exps``
    uint8 ``[E, K, N/32]`` (each expert quantized as a `Linear`'s weight is;
    the reference's ``<name>_mx`` ``packed`` / ``exps``).  Expert stacks
    carry no INT8 copy: prefill and decode read the same bytes."""

    def __init__(self, **weights):
        super().__init__()
        known = {f"{n}{s}" for n in EXPERT_WEIGHTS for s in ("", "_packed", "_exps")}
        if set(weights) - known:
            raise TypeError(f"unknown expert weights {sorted(set(weights) - known)}")
        for n in EXPERT_WEIGHTS:
            self.register_parameter(n, _param(weights.get(n)))
            self.register_buffer(f"{n}_packed", weights.get(f"{n}_packed"))
            self.register_buffer(f"{n}_exps", weights.get(f"{n}_exps"))

    @classmethod
    def init(cls, init: Init, e: int, d: int, f: int) -> "Experts":
        # The reference's ParamBuilder draws a stacked param with std
        # 1/sqrt(shape[0]): here the expert count.
        std = 1.0 / math.sqrt(e)
        return cls(wg=init.normal((e, d, f), std), wi=init.normal((e, d, f), std),
                   wo=init.normal((e, f, d), std))

    @property
    def deployed(self) -> bool:
        return self.wg is None

    def stack(self, name: str) -> tuple[torch.Tensor, torch.Tensor]:
        """The deployed MXINT4 stack of ``name``: (packed, exps)."""
        return getattr(self, f"{name}_packed"), getattr(self, f"{name}_exps")

    def f32(self, name: str) -> torch.Tensor:
        """The whole stack of ``name`` in f32 (dequantized if deployed), the
        reference's `_expert_weight`."""
        if not self.deployed:
            return getattr(self, name).to(torch.float32)
        return mx.dequantize_stacked(*self.stack(name))


class MoE(nn.Module):
    """The router (a `Linear` ``[D, E]``), the routed experts and, for
    deepseek-v3, the shared experts (a gated `MLP` of ``moe_d_ff x
    n_shared_experts``)."""

    def __init__(self, router: Linear, experts: Experts, shared: MLP | None = None):
        super().__init__()
        self.router, self.experts, self.shared = router, experts, shared

    @classmethod
    def init(cls, init: Init, cfg: ModelConfig) -> "MoE":
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        router = Linear.init(init, d, e)
        experts = Experts.init(init, e, d, f)
        shared = (MLP.init(init, d, f * cfg.n_shared_experts)
                  if cfg.n_shared_experts else None)
        return cls(router, experts, shared)


def round_cap(cap: int) -> int:
    """Capacities above 256 round up to a multiple of 256 (the reference's
    `_round_cap`)."""
    return ((cap + 255) // 256) * 256 if cap > 256 else cap


def capacity(t: int, cfg: ModelConfig, no_drop: bool = False) -> int:
    """Expert slots per dispatch of ``t`` tokens: all of them under
    ``no_drop`` (a token takes an expert at most once), else
    ``round_cap(int(t * k / E * capacity_factor) + 1)``."""
    if no_drop:
        return t
    return round_cap(int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1)


def dispatch(idx: torch.Tensor, e: int, cap: int) -> torch.Tensor:
    """Each assignment's slot in its expert: ``idx`` ``[G, T, k]`` (G
    dispatches of T tokens) -> ``pos`` int64 ``[G, T, k]``, ``cap`` where
    the assignment is dropped.

    The reference's `_dispatch` fills the experts slot by slot: slot j's
    assignments take the places after every earlier slot's in their expert,
    in token order (the rank a stable sort by expert gives).  That place is
    the count of the assignments before it, in slot-major order, that chose
    the same expert: one cumulative sum over a one-hot, with no sort and no
    host read, so it captures into a graph."""
    g, t, k = idx.shape
    order = idx.transpose(1, 2).reshape(g, k * t)                 # slot-major
    hot = (order[..., None] == torch.arange(e, device=idx.device)).to(torch.int64)
    pos = (hot.cumsum(1) - hot).gather(2, order[..., None])[..., 0]
    pos = torch.where(pos < cap, pos, cap)
    return pos.view(g, k, t).transpose(1, 2)


def _combine(picked: torch.Tensor, pos: torch.Tensor, gates: torch.Tensor,
             cap: int) -> torch.Tensor:
    """Expert outputs ``picked`` ``[T, k, D]`` (in the expert input's dtype)
    -> ``[T, D]`` f32: the kept ones gate-weighted and summed over the slots
    in order (the reference's `_combine`)."""
    kept = torch.where((pos < cap)[..., None], picked,
                       torch.zeros((), dtype=picked.dtype, device=picked.device))
    terms = kept.to(torch.float32) * gates[..., None].to(torch.float32)
    y = torch.zeros_like(terms[:, 0])
    for j in range(terms.shape[1]):
        y = y + terms[:, j]
    return y


def _ffn_capacity(ex: Experts, x: torch.Tensor, idx: torch.Tensor, pos: torch.Tensor,
                  e: int, cap: int) -> torch.Tensor:
    """The capacity form: ``x`` ``[G, T, D]`` scattered into ``[E, G, cap +
    1, D]`` (slot ``cap`` takes the dropped rows; their outputs are masked), each
    expert's rows through its FFN in f32 (`_expert_ffn`), and each
    assignment's output gathered back -> ``[G, T, k, D]`` in x's dtype."""
    g, t, d = x.shape
    k = idx.shape[2]
    lane = torch.arange(g, device=x.device)[:, None, None]
    slot = (idx * g + lane) * (cap + 1) + pos                     # [G, T, k]
    buf = torch.zeros(e * g * (cap + 1), d, dtype=x.dtype, device=x.device)
    buf.index_copy_(0, slot.reshape(-1), x[:, :, None].expand(g, t, k, d).reshape(-1, d))
    out = _expert_ffn(buf.view(e, g * (cap + 1), d), ex.f32("wg"), ex.f32("wi"),
                      ex.f32("wo"))
    return out.to(x.dtype).view(-1, d)[slot.reshape(-1)].view(g, t, k, d)


def _expert_ffn(buf: torch.Tensor, wg, wi, wo) -> torch.Tensor:
    """``buf`` ``[E, C, D]`` -> ``[E, C, D]`` f32 through each expert's gated
    FFN (the reference's `_expert_ffn`)."""
    xf = buf.to(torch.float32)
    h = F.silu(torch.bmm(xf, wg)) * torch.bmm(xf, wi)
    return torch.bmm(h, wo)


def _ffn_assigned(ex: Experts, x: torch.Tensor, idx: torch.Tensor,
                  impl: str) -> torch.Tensor:
    """The assigned form: row (token, slot) of ``x`` ``[T, D]`` times its
    expert ``idx`` ``[T, k]`` -> ``[T, k, D]`` in x's dtype."""
    t, d = x.shape
    k = idx.shape[1]
    ids = idx.reshape(-1)
    rows = x.to(torch.float32)[:, None].expand(t, k, d).reshape(t * k, d)

    def matmul(a, name):
        if ex.deployed:
            packed, exps = ex.stack(name)
            return ops.mxint4_expert_matmul(a, packed, exps, ids, impl=impl)
        w = getattr(ex, name).index_select(0, ids).to(torch.float32)
        return torch.bmm(a[:, None], w)[:, 0]

    h = F.silu(matmul(rows, "wg")) * matmul(rows, "wi")
    return matmul(h, "wo").to(x.dtype).view(t, k, d)


def moe_apply(p: MoE, x_star: torch.Tensor, sig_inv, engine: HSAEngine, phase: str,
              cfg: ModelConfig, no_drop: bool = False) -> torch.Tensor:
    """``[B, S, D]`` -> ``[B, S, D]`` in x_star's dtype (the reference's
    `moe_apply` without its training-only aux loss).

    ``no_drop`` (speculative verify) makes the capacity every token of the
    dispatch: rejected drafts share it with real tokens and must not evict
    them, and one token alone never drops.  Decode and verify run the
    assigned form, prefill the capacity form (module docstring)."""
    b, s, d = x_star.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = engine.linear(p.router, x_star, phase, row_scale=sig_inv)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    # The expert input is normalized once, in x_star's dtype.
    x = x_star if sig_inv is None else (x_star * sig_inv[..., None]).to(x_star.dtype)
    gates, idx = torch.topk(probs, k, dim=-1, sorted=True)        # [B, S, k]
    gates = gates / gates.sum(dim=-1, keepdim=True)
    groups = b if engine.config.per_lane else 1
    t = b * s // groups
    cap = capacity(t, cfg, no_drop)
    idx_g = idx.reshape(groups, t, k)
    pos = dispatch(idx_g, e, cap)
    if phase == "decode" or no_drop:
        picked = _ffn_assigned(p.experts, x.reshape(-1, d), idx.reshape(-1, k),
                               engine.config.kernel_impl)
    else:
        picked = _ffn_capacity(p.experts, x.reshape(groups, t, d), idx_g, pos, e, cap)
    y = _combine(picked.reshape(-1, k, d), pos.reshape(-1, k), gates.reshape(-1, k), cap)
    if p.shared is not None:
        y = y + mlp_apply(p.shared, x_star, sig_inv, engine, phase).reshape(-1, d).to(
            torch.float32)
    return y.reshape(b, s, d).to(x_star.dtype)
