"""Online RoPE — Section IV-B2 of the HSA paper (Eq. 5-6).

The decode loop keeps the current ``(sin m theta, cos m theta)`` in a small
angle memory and advances it with the angle-addition identities (Eq. 6)
instead of gathering a table row per token.  f32 repeated rotation drifts,
so `advance` resyncs exactly every `RESYNC_PERIOD` tokens.  Rotation uses the
interleaved-pair convention (x[0::2], x[1::2]).
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

    sin: torch.Tensor   # f32 [d/2]
    cos: torch.Tensor   # f32 [d/2]
    pos: int


def init_state(head_dim: int, base: float = 10000.0, pos: int = 0,
               device=None) -> OnlineRopeState:
    thetas = rope_thetas(head_dim, base, device)
    sin, cos = rope_table(torch.tensor(pos, device=device), thetas)
    return OnlineRopeState(sin=sin, cos=cos, pos=int(pos))


def update(state: OnlineRopeState, thetas: torch.Tensor) -> OnlineRopeState:
    """"Update" mode: advance one token via the trig identities (Eq. 6)."""
    st, ct = torch.sin(thetas), torch.cos(thetas)
    return OnlineRopeState(sin=state.sin * ct + state.cos * st,
                           cos=state.cos * ct - state.sin * st,
                           pos=state.pos + 1)


def advance(state: OnlineRopeState, thetas: torch.Tensor,
            resync_period: int = RESYNC_PERIOD) -> OnlineRopeState:
    """`update`, with an exact resync whenever the new position is a
    multiple of ``resync_period`` (the position is a host integer here, so
    the branch costs no device work)."""
    nxt = update(state, thetas)
    if nxt.pos % resync_period == 0:
        sin, cos = rope_table(torch.tensor(nxt.pos, device=thetas.device), thetas)
        return OnlineRopeState(sin=sin, cos=cos, pos=nxt.pos)
    return nxt
