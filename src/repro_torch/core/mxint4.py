"""MXINT4 weight quantization — Section III of the HSA paper (Eq. 1).

Weights are ``W[K, N]`` (``y = x @ W``); groups are 16 consecutive output
channels at a fixed input channel, with a shared power-of-two shift

    S_g = clip(floor(log2(max |W_g|)), -9, +5)            (Eq. 1)

Packed layout (identical bytes to the JAX reference, tested):

  * mantissas: int8 ``[K, N // 2]``, two int4 per byte, low nibble = even
    output channel;
  * shifts: uint8 ``[K, N // 32]``, codes ``S_g + 9`` as two unsigned nibbles
    per byte, low nibble = even group.

A weight dequantizes as ``m * 2^(S_g - 2)``, exact in bf16 and f32.
Rounding is half-to-even (``torch.round``), as in ``jnp.round``.
"""

from __future__ import annotations

import dataclasses

import torch

GROUP_SIZE = 16          # paper: group of 16 along the output channel
SHIFT_MIN = -9           # paper: shift constrained to [-9, +5]
SHIFT_MAX = 5
MANT_MIN = -8            # int4 two's complement
MANT_MAX = 7
MANT_SHIFT = 2           # max|W_g| in [2^S, 2^(S+1)) -> |w| / 2^(S-2) in [4, 8)
EXP_BIAS = 9             # shift codes stored as unsigned nibble: code = S_g + 9


@dataclasses.dataclass(frozen=True)
class MXINT4Weight:
    """A weight in MXINT4: ``packed`` int8 ``[K, N//2]``, ``exps_packed``
    uint8 ``[K, N//32]``, logical ``shape`` ``(K, N)``."""

    packed: torch.Tensor
    exps_packed: torch.Tensor
    shape: tuple[int, int]

    @property
    def exps(self) -> torch.Tensor:
        """Unpacked int8 shift exponents ``[K, N // GROUP_SIZE]`` in [-9, +5]."""
        return (unpack_uint4(self.exps_packed).to(torch.int16)
                - EXP_BIAS).to(torch.int8)


@dataclasses.dataclass(frozen=True)
class Int8Weight:
    """Per-tensor symmetric INT8 weight (the prefill format)."""

    values: torch.Tensor   # int8 [K, N]
    scale: torch.Tensor    # f32 scalar


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for x > 0, exact for powers of two (frexp)."""
    _, exp = torch.frexp(x)            # x = mant * 2^exp, mant in [0.5, 1)
    return exp - 1


def group_shift_exponents(w: torch.Tensor, group_size: int = GROUP_SIZE
                          ) -> torch.Tensor:
    """Eq. (1): S_g = clip(floor(log2 max|W_g|), -9, +5), groups along axis 1."""
    k, n = w.shape
    if n % group_size != 0:
        raise ValueError(f"N={n} not divisible by group {group_size}")
    gmax = w.abs().reshape(k, n // group_size, group_size).amax(dim=-1)
    # Zero groups park at SHIFT_MIN (their mantissas are exactly zero).
    safe = torch.where(gmax > 0, gmax, torch.full_like(gmax, 2.0 ** SHIFT_MIN))
    exps = _floor_log2(safe.to(torch.float32))
    return exps.clamp(SHIFT_MIN, SHIFT_MAX).to(torch.int8)


def _interleave(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """[..., K, H] + [..., K, H] -> [..., K, 2H] with lo at even and hi at
    odd columns."""
    return torch.stack([lo, hi], dim=-1).reshape(*lo.shape[:-1], -1)


def pack_int4(mant: torch.Tensor) -> torch.Tensor:
    """Pack int4 mantissas ``[K, N]`` (int8 values) -> int8 bytes ``[K, N//2]``."""
    if mant.shape[1] % 2 != 0:
        raise ValueError(f"mantissa width {mant.shape[1]} must be even to "
                         "pack nibble pairs")
    m16 = mant.to(torch.int16)          # widen: no int8 shift overflow
    byte = (m16[:, 0::2] & 0x0F) | ((m16[:, 1::2] & 0x0F) << 4)
    return byte.to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Unpack int8 bytes ``[..., K, N//2]`` -> sign-extended int8 mantissas
    ``[..., K, N]``."""
    p16 = packed.to(torch.int16)        # sign-extended byte value
    lo = ((p16 & 0x0F) ^ 0x08) - 0x08   # sign-extend the low nibble
    hi = p16 >> 4                       # arithmetic shift: signed high nibble
    return _interleave(lo, hi).to(torch.int8)


def pack_uint4(codes: torch.Tensor) -> torch.Tensor:
    """Pack unsigned nibble codes (0..15) ``[K, G]`` -> uint8 ``[K, G//2]``."""
    if codes.shape[1] % 2 != 0:
        raise ValueError(f"packed width {codes.shape[1]} must be even to "
                         "pack nibble pairs")
    c16 = codes.to(torch.int16)
    return ((c16[:, 0::2] & 0x0F) | ((c16[:, 1::2] & 0x0F) << 4)).to(torch.uint8)


def unpack_uint4(packed: torch.Tensor) -> torch.Tensor:
    """Unpack uint8 ``[..., K, G//2]`` -> unsigned nibble codes uint8
    ``[..., K, G]``."""
    p16 = packed.to(torch.int16)
    return _interleave(p16 & 0x0F, (p16 >> 4) & 0x0F).to(torch.uint8)


def quantize_mxint4(w: torch.Tensor, group_size: int = GROUP_SIZE
                    ) -> MXINT4Weight:
    """PTQ a weight matrix ``W[K, N]`` to MXINT4 (Section III)."""
    w = w.to(torch.float32)
    exps = group_shift_exponents(w, group_size)
    scale = torch.exp2(exps.to(torch.float32) - MANT_SHIFT)
    scale_full = scale.repeat_interleave(group_size, dim=1)
    mant = torch.round(w / scale_full).clamp(MANT_MIN, MANT_MAX).to(torch.int8)
    codes = (exps.to(torch.int32) + EXP_BIAS).to(torch.uint8)
    return MXINT4Weight(packed=pack_int4(mant), exps_packed=pack_uint4(codes),
                        shape=tuple(w.shape))


def dequantize_mxint4(q: MXINT4Weight, dtype=torch.bfloat16,
                      group_size: int = GROUP_SIZE) -> torch.Tensor:
    """Reference dequantization: ``w = m * 2^(S_g - 2)`` (exact in bf16)."""
    return dequantize_stacked(q.packed, q.exps_packed, dtype, group_size)


def dequantize_stacked(packed: torch.Tensor, exps_packed: torch.Tensor,
                       dtype=torch.float32, group_size: int = GROUP_SIZE) -> torch.Tensor:
    """`dequantize_mxint4` of weights stacked on leading axes: ``packed``
    ``[..., K, N//2]`` and ``exps_packed`` ``[..., K, N//32]`` ->
    ``[..., K, N]`` (MoE expert stacks, the reference's
    ``deploy.dequantize_stacked``)."""
    mant = unpack_int4(packed).to(torch.float32)
    exps = unpack_uint4(exps_packed).to(torch.float32) - EXP_BIAS
    scale = torch.exp2(exps - MANT_SHIFT)
    return (mant * scale.repeat_interleave(group_size, dim=-1)).to(dtype)


def _absmax_scale(x: torch.Tensor, dims=None) -> torch.Tensor:
    """``absmax * f32(1/127)``.  The reference writes ``absmax / 127.0``, but
    under ``jit`` XLA multiplies by the rounded reciprocal, and its deployed
    bytes and prefill activations come from that compiled form (an exact
    division differs in the last bit for some inputs;
    tests/test_torch_mxint4.py holds one)."""
    absmax = x.to(torch.float32).abs().amax() if dims is None else \
        x.to(torch.float32).abs().amax(dim=dims)
    return torch.where(absmax > 0, absmax * (1.0 / 127.0), torch.ones_like(absmax))


def _round_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # Divide in f32 as jnp does: a bf16 tensor over a 0-dim f32 tensor would
    # stay bf16 under torch's promotion rules.
    return torch.round(x.to(torch.float32) / scale).clamp(-127, 127).to(torch.int8)


def quantize_int8_tensor(w: torch.Tensor) -> Int8Weight:
    """Per-tensor symmetric INT8 (absmax / 127, see `_absmax_scale`)."""
    scale = _absmax_scale(w)
    return Int8Weight(values=_round_int8(w, scale), scale=scale)


def quantize_act_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic activation quantization: ONE absmax over the whole tensor
    (every token of every sequence), as the reference does."""
    scale = _absmax_scale(x)
    return _round_int8(x, scale), scale


def quantize_act_int8_lanes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic activation quantization with one absmax per lane (the leading
    axis): lane b's rows ``x[b]`` take the scale ``[B]`` of their own, as
    each slot of the reference's vmapped pool step does, so a lane's bytes
    never depend on what the other lanes hold."""
    scale = _absmax_scale(x, tuple(range(1, x.ndim)))
    return _round_int8(x, scale.reshape(-1, *([1] * (x.ndim - 1)))), scale
