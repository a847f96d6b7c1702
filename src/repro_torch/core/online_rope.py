"""Online RoPE — Section IV-B2 of the HSA paper (Eq. 5-6).

The decode loop keeps the current ``(sin m theta, cos m theta)`` in a small
angle memory and advances it with the angle-addition identities (Eq. 6)
instead of gathering a table row per token.  f32 repeated rotation drifts,
so `advance` resyncs exactly every `RESYNC_PERIOD` tokens.  Rotation uses the
interleaved-pair convention (x[0::2], x[1::2]).

The position is an int32 tensor on the device, as the reference's is a
traced scalar: a decode step never reads it on the host, so the step can be
captured once and replayed.  It is a scalar for a batch that shares one
position, or a ``[B]`` vector with one position per lane (a scheduler's
slot class, the reference's vmapped per-slot scalar): ``sin``/``cos`` are
then ``[B, d/2]`` and each lane resyncs at its own multiples of
`RESYNC_PERIOD`.
"""

from __future__ import annotations

import dataclasses

import torch

RESYNC_PERIOD = 64


def rope_thetas(head_dim: int, base: float = 10000.0, device=None) -> torch.Tensor:
    """theta_i = base^(-2(i-1)/d), i in [1, d/2]  (Eq. 5)."""
    i = torch.arange(head_dim // 2, dtype=torch.float32, device=device)
    return torch.pow(torch.tensor(base, dtype=torch.float32, device=device),
                     -2.0 * i / head_dim)


def rope_table(positions: torch.Tensor, thetas: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of shape ``positions.shape + [d/2]``."""
    ang = positions.to(torch.float32)[..., None] * thetas
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotate ``x[..., d]`` pairwise; ``sin/cos`` broadcast, trailing dim d/2."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class OnlineRopeState:
    """The angle memory for the current absolute position ``pos``."""

    sin: torch.Tensor   # f32 [d/2], or [B, d/2] per lane
    cos: torch.Tensor   # f32 [d/2], or [B, d/2] per lane
    pos: torch.Tensor   # i32 scalar, or [B] per lane, on the device


def init_state(head_dim: int, base: float = 10000.0, pos: int = 0,
               device=None) -> OnlineRopeState:
    thetas = rope_thetas(head_dim, base, device)
    p = torch.tensor(pos, dtype=torch.int32, device=device)
    sin, cos = rope_table(p, thetas)
    return OnlineRopeState(sin=sin, cos=cos, pos=p)


def update(state: OnlineRopeState, thetas: torch.Tensor) -> OnlineRopeState:
    """"Update" mode: advance one token via the trig identities (Eq. 6)."""
    st, ct = torch.sin(thetas), torch.cos(thetas)
    return OnlineRopeState(sin=state.sin * ct + state.cos * st,
                           cos=state.cos * ct - state.sin * st,
                           pos=state.pos + 1)


def advance(state: OnlineRopeState, thetas: torch.Tensor,
            resync_period: int = RESYNC_PERIOD) -> OnlineRopeState:
    """`update`, with an exact resync whenever the new position is a
    multiple of ``resync_period``: both are computed and selected on the
    device, as the reference's ``jnp.where`` does (per lane for a ``[B]``
    position)."""
    nxt = update(state, thetas)
    need = (nxt.pos % resync_period == 0)[..., None]
    exact_sin, exact_cos = rope_table(nxt.pos, thetas)
    return OnlineRopeState(sin=torch.where(need, exact_sin, nxt.sin),
                           cos=torch.where(need, exact_cos, nxt.cos), pos=nxt.pos)


def lane_angles(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """``sin``/``cos`` shaped to broadcast against an ``ndim``-d tensor whose
    leading axis is the batch: a shared ``[d/2]`` row as it is, per-lane
    ``[B, d/2]`` rows as ``[B, 1, ..., 1, d/2]``."""
    if t.ndim == 1:
        return t
    return t.reshape(t.shape[0], *([1] * (ndim - 2)), t.shape[-1])
