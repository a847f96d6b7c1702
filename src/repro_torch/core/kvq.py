"""Quantized KV-cache codecs: the cache side of the paper's external-memory
argument.

Once decode weights stream at MXINT4, the per-token memory traffic of the
MVM phase is dominated by KV-cache reads: an f32 GQA cache costs ``4*d``
bytes per row, every step.  Two row-local encodings cut that stream:

``int8_tok``
    Per-row symmetric int8: each cache row (the last axis) stores an int8
    vector plus one f32 ``absmax/127`` scale.  Bytes/row: ``d + 4``.

``mxint4_blk``
    The weight path's MXINT4 element format on cache rows: groups of
    GROUP_SIZE = 16 along the last axis share a power-of-two scale
    ``2^(e - 2)``; mantissas are 4-bit two's complement, packed two per int8,
    low nibble first; exponents stay one int8 per group (unpacked, unlike
    the weights' packed shift codes).  Bytes/row: ``d/2 + d/16``.  A leaf
    whose last dim is not a multiple of 16 falls back to ``int8_tok``.

An encoded leaf is a plain dict (``{"q","s"}`` or ``{"m","e"}``).  The
encoded bytes are identical to the JAX package's.  Its ``absmax / 127.0``
takes two forms there: eager JAX divides (the prefill/decode boundary,
`lm.quantize_cache`, runs eagerly) and XLA compiles the division into a
multiply by f32(1/127) (every appended decode row, inside the jitted decode
loop).  The two differ in the last bit for some rows, so `encode` takes
``reciprocal`` to pick the form, and each caller passes the one its
reference site produces.  Rounding is half to even on both sides.
"""

from __future__ import annotations

import torch

from repro_torch.core import mxint4 as mx

FORMATS = ("int8_tok", "mxint4_blk")

# Legacy whole-cache int8 (`layers.to_cache_dtype`): one static power-of-two
# scale and no per-row metadata.
KV8_SCALE = 32.0


def is_format(fmt) -> bool:
    """True when ``fmt`` is a quantized-cache format name (not a dtype)."""
    return isinstance(fmt, str) and fmt in FORMATS


def check_format(fmt) -> str:
    if not is_format(fmt):
        raise ValueError(f"unknown cache format {fmt!r}; expected one of "
                         f"{FORMATS} or a torch dtype")
    return fmt


def effective_format(fmt: str, d: int) -> str:
    """Per-leaf format after the fallback: mxint4_blk needs whole 16-element
    groups and an even mantissa count in the last dim."""
    check_format(fmt)
    if fmt == "mxint4_blk" and (d % mx.GROUP_SIZE != 0 or d % 2 != 0):
        return "int8_tok"
    return fmt


def leaf_format(leaf) -> str | None:
    """Format of an encoded leaf dict, or None for a plain tensor."""
    if not isinstance(leaf, dict):
        return None
    keys = set(leaf)
    if keys == {"q", "s"}:
        return "int8_tok"
    if keys == {"m", "e"}:
        return "mxint4_blk"
    return None


def decoded_dim(leaf) -> int:
    """Last (feature) dim of a cache leaf after decoding."""
    fmt = leaf_format(leaf)
    if fmt == "int8_tok":
        return leaf["q"].shape[-1]
    if fmt == "mxint4_blk":
        return leaf["m"].shape[-1] * 2
    return leaf.shape[-1]


def nbytes_per_row(fmt, d: int) -> float:
    """Modeled cache bytes for one d-element row.  ``fmt`` is a format name
    or a torch dtype."""
    if is_format(fmt):
        if effective_format(fmt, d) == "mxint4_blk":
            return d / 2 + d / mx.GROUP_SIZE
        return d + 4.0
    return d * torch.empty((), dtype=fmt).element_size()


# -- int8_tok ----------------------------------------------------------------

def _encode_int8_tok(x: torch.Tensor, reciprocal: bool) -> dict:
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    # A tensor divisor: on the card, torch turns division by a Python scalar
    # into a multiply by its reciprocal.
    scaled = (absmax * (1.0 / 127.0) if reciprocal
              else absmax / torch.full_like(absmax, 127.0))
    scale = torch.where(absmax > 0, scaled, torch.ones_like(absmax))
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def _decode_int8_tok(leaf: dict) -> torch.Tensor:
    return leaf["q"].to(torch.float32) * leaf["s"]


# -- mxint4_blk --------------------------------------------------------------

def _encode_mxint4_blk(x: torch.Tensor) -> dict:
    xf = x.to(torch.float32)
    d = xf.shape[-1]
    g = xf.reshape(*xf.shape[:-1], d // mx.GROUP_SIZE, mx.GROUP_SIZE)
    gmax = g.abs().amax(dim=-1)
    safe = torch.where(gmax > 0, gmax, torch.full_like(gmax, 2.0 ** mx.SHIFT_MIN))
    _, e = torch.frexp(safe)
    exps = (e - 1).clamp(mx.SHIFT_MIN, mx.SHIFT_MAX).to(torch.int8)
    scale = torch.exp2(exps.to(torch.float32) - mx.MANT_SHIFT)
    mant = torch.round(g / scale[..., None]).clamp(mx.MANT_MIN, mx.MANT_MAX)
    flat = mant.to(torch.int16).reshape(*xf.shape[:-1], d)
    packed = (flat[..., 0::2] & 0x0F) | ((flat[..., 1::2] & 0x0F) << 4)
    return {"m": packed.to(torch.uint8).view(torch.int8), "e": exps}


def _decode_mxint4_blk(leaf: dict) -> torch.Tensor:
    m, e = leaf["m"].to(torch.int16), leaf["e"]
    lo = ((m & 0x0F) ^ 0x08) - 0x08            # sign-extended low nibble
    hi = m >> 4                                # arithmetic: signed high nibble
    mant = torch.stack([lo, hi], dim=-1).reshape(*m.shape[:-1], 2 * m.shape[-1])
    scale = torch.exp2(e.to(torch.float32) - mx.MANT_SHIFT)
    g = mant.to(torch.float32).reshape(*m.shape[:-1], e.shape[-1], mx.GROUP_SIZE)
    return (g * scale[..., None]).reshape(mant.shape)


# -- public API --------------------------------------------------------------

def encode(x, fmt: str, *, reciprocal: bool = False) -> dict:
    """Encode a cache leaf (last axis = feature dim) into format ``fmt``.

    ``reciprocal`` picks the int8_tok scale form: False divides by 127 (eager
    JAX), True multiplies by f32(1/127) (the reference under jit).  An
    already-encoded dict passes through."""
    if isinstance(x, dict):
        return x
    if effective_format(fmt, x.shape[-1]) == "mxint4_blk":
        return _encode_mxint4_blk(x)
    return _encode_int8_tok(x, reciprocal)


def encode_like(x: torch.Tensor, leaf, *, reciprocal: bool = False) -> dict:
    """Encode ``x`` into the format of an existing encoded leaf (the append
    path: new K/V rows must match the resident store)."""
    fmt = leaf_format(leaf)
    if fmt is None:
        raise TypeError(f"encode_like target is not an encoded cache leaf: "
                        f"{type(leaf).__name__}")
    return encode(x, fmt, reciprocal=reciprocal)


def decode(leaf) -> torch.Tensor:
    """Encoded leaf dict (or plain tensor) -> f32 tensor.  Plain int8 takes
    the legacy static-scale path (`KV8_SCALE`); other dtypes upcast."""
    fmt = leaf_format(leaf)
    if fmt == "int8_tok":
        return _decode_int8_tok(leaf)
    if fmt == "mxint4_blk":
        return _decode_mxint4_blk(leaf)
    if leaf.dtype == torch.int8:
        return leaf.to(torch.float32) / KV8_SCALE
    return leaf.to(torch.float32)


def zeros(shape: tuple, fmt: str, device=None) -> dict:
    """Zero-initialized encoded leaf, bit-identical to ``encode(zeros)``."""
    d = shape[-1]
    lead = tuple(shape[:-1])
    if effective_format(fmt, d) == "mxint4_blk":
        return {"m": torch.zeros(lead + (d // 2,), dtype=torch.int8, device=device),
                "e": torch.full(lead + (d // mx.GROUP_SIZE,), mx.SHIFT_MIN,
                                dtype=torch.int8, device=device)}
    return {"q": torch.zeros(tuple(shape), dtype=torch.int8, device=device),
            "s": torch.ones(lead + (1,), dtype=torch.float32, device=device)}
