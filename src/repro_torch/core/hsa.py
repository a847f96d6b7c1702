"""HSA execution engine — the phase-to-dataflow dispatcher (contribution C1).

Prefill runs the MMM dataflow (W8A8) and decode the MVM dataflow (MXINT4).
Models call ``engine.linear(...)``; the engine picks the format from the
phase and degrades to the best format the weight actually carries, so a
master-only (un-deployed) model always runs.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import mxint4 as mx
from repro_torch.core import quantized_linear as ql

PHASES = ("train", "prefill", "decode")


@dataclasses.dataclass(frozen=True)
class HSAConfig:
    """Phase -> numeric format policy (the paper's default: W8A8 / MXINT4).

    Outputs are f32.  The online RoPE unit always drives decode, so the
    reference's unread ``online_rope`` and its one-valued ``out_dtype`` are
    left out.  ``per_lane`` makes every lane (the leading axis of the
    input) a dispatch of its own, as the reference's per-slot ``vmap`` over
    a scheduler's slot class has it: each lane's W8A8 activations take their
    own scale, and each lane's tokens fill the MoE experts' capacity alone
    (`models/mlp.py`)."""

    prefill_format: str = "w8a8"        # 'w8a8' | 'fp'
    decode_format: str = "mxint4"       # 'mxint4' | 'w8a8' | 'fp'
    fuse_rmsnorm: bool = True           # C3: Eq. (4) epilogue fusion
    kernel_impl: str = "auto"           # 'auto' | 'kernel' | 'ref'
    per_lane: bool = False              # each lane its own dispatch


class HSAEngine:
    """Phase-dependent linear-layer dispatcher (one per model instance).

    ``p`` is a `repro_torch.models.modules.Linear`: any subset of ``w``,
    ``b``, ``w8_vals``/``w8_scale`` and ``mx_packed``/``mx_exps``.
    """

    def __init__(self, config: HSAConfig | None = None):
        self.config = config or HSAConfig()

    def linear(self, p, x: torch.Tensor, phase: str, *, row_scale=None,
               out_scale=None) -> torch.Tensor:
        if phase not in PHASES:
            raise ValueError(f"unknown phase {phase!r}; expected one of {PHASES}")
        cfg = self.config
        fmt = {"train": "fp", "prefill": cfg.prefill_format,
               "decode": cfg.decode_format}[phase]
        if fmt == "mxint4" and p.mx_packed is None:
            fmt = "w8a8"
        if fmt == "w8a8" and p.w8_vals is None:
            fmt = "fp"
        if not cfg.fuse_rmsnorm:
            row_scale = None            # unfused ablation: caller normalized
        params = ql.QuantizedLinearParams(
            w=p.w,
            w8=mx.Int8Weight(p.w8_vals, p.w8_scale) if fmt == "w8a8" else None,
            mx=(mx.MXINT4Weight(p.mx_packed, p.mx_exps,
                                (p.mx_packed.shape[0], p.mx_packed.shape[1] * 2))
                if fmt == "mxint4" else None),
            bias=p.b, n=p.shape[1])
        eff_phase = {"fp": "train", "w8a8": "prefill", "mxint4": "decode"}[fmt]
        return ql.apply(params, x, eff_phase, row_scale=row_scale,
                        out_scale=out_scale, impl=cfg.kernel_impl,
                        lane_act=cfg.per_lane)
