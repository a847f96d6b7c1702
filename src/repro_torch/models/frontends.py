"""Modality frontend stubs: deterministic stand-ins for the embeddings an
audio or vision frontend would hand the backbone (the reference's
`models/frontends.py`).

The audio and vision entries of the registry specify the transformer
backbone only; their frontends are stubs fed precomputed frame or patch
embeddings.  These helpers draw them from ``numpy.random.default_rng(seed)``
exactly as the reference does, in float64, then cast to the config's
``param_dtype``, so one seed gives the reference's bytes.

seamless-m4t-medium's encoder reads ``synth_frame_embeds`` (its
``frontend_tokens`` frames); llava-next's anyres tiling (2 x 2 tiles and a
base of 336 px / 14: 5 x 576 = 2880 patch tokens) is ``vision_tokens``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


def vision_tokens(cfg: ModelConfig) -> int:
    return cfg.frontend_tokens


def _as_param(a: np.ndarray, cfg: ModelConfig, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device=device, dtype=getattr(torch, cfg.param_dtype))


def synth_patch_embeds(cfg: ModelConfig, batch: int, seed: int = 0,
                       device="cuda") -> torch.Tensor:
    """Deterministic stand-in for the vision tower's output ``[B, P, D]``."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((batch, cfg.frontend_tokens, cfg.d_model)) * 0.02
    return _as_param(p, cfg, device)


def synth_frame_embeds(cfg: ModelConfig, batch: int, n_frames: int, seed: int = 0,
                       device="cuda") -> torch.Tensor:
    """Deterministic stand-in for the speech encoder frontend ``[B, T, D]``."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((batch, n_frames, cfg.d_model)) * 0.02
    return _as_param(f, cfg, device)
