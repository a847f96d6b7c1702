"""repro_torch quantizers against the JAX reference: identical bytes.

Inputs are made with numpy from a seed and fed to both sides.  Packed
mantissas, packed shift codes, INT8 values and scales must match exactly
(ROADMAP rule: integer results and packed bytes are bit-identical).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mxint4 as J
from repro_torch.core import mxint4 as T


def _random(rng):
    return (rng.normal(size=(64, 96)) * 0.1).astype(np.float32)


def _zero_groups(rng):
    w = _random(rng)
    w[:, :16] = 0.0                     # whole groups of zeros
    w[7] = 0.0                          # a whole row
    return w


def _clip_edge(rng):
    """Group maxima that land on the mantissa clip edge, on exact powers of
    two, on round-half ties, and beyond the [-9, +5] shift clamp."""
    w = _random(rng)
    w[0, :16] = 7.75 * 2.0 ** -3        # (7.5, 8) * scale -> clips to 7
    w[1, :16] = -8.0 * 2.0 ** -4        # exactly -8 units: the negative edge
    w[2, :16] = np.float32(2.0 ** -2)   # exact power of two
    w[3, 16:32] = np.arange(16) * 0.5 * 2.0 ** -5 + 0.25 * 2.0 ** -5
    w[3, 16] = 2.0 ** -1                # sets the group shift; others tie at .5
    w[4, :16] = 1e3                     # shift clamped at +5
    w[5, :16] = 1e-6                    # shift clamped at -9
    w[6, 32:48] = -rng.uniform(3.0, 4.0, 16)
    return w.astype(np.float32)


CASES = {"random": _random, "zero_groups": _zero_groups, "clip_edge": _clip_edge}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_mxint4_bytes_match(case, dtype):
    w = CASES[case](np.random.default_rng(len(case)))
    jw = jnp.asarray(w).astype(dtype)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    qj, qt = J.quantize_mxint4(jw), T.quantize_mxint4(tw)
    np.testing.assert_array_equal(np.asarray(qj.packed), qt.packed.numpy())
    np.testing.assert_array_equal(np.asarray(qj.exps_packed), qt.exps_packed.numpy())
    assert qt.packed.dtype == torch.int8 and qt.exps_packed.dtype == torch.uint8
    np.testing.assert_array_equal(np.asarray(qj.exps), qt.exps.numpy())
    np.testing.assert_array_equal(
        np.asarray(J.dequantize_mxint4(qj, dtype=jnp.float32)),
        T.dequantize_mxint4(qt, dtype=torch.float32).numpy())


def test_nibble_packing_round_trips_like_jax():
    rng = np.random.default_rng(3)
    mant = rng.integers(-8, 8, size=(8, 32)).astype(np.int8)
    codes = rng.integers(0, 16, size=(8, 32)).astype(np.uint8)
    pj, pt = J.pack_int4(jnp.asarray(mant)), T.pack_int4(torch.from_numpy(mant))
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    np.testing.assert_array_equal(T.unpack_int4(pt).numpy(), mant)
    np.testing.assert_array_equal(np.asarray(J.unpack_int4(pj)),
                                  T.unpack_int4(pt).numpy())
    uj, ut = J.pack_uint4(jnp.asarray(codes)), T.pack_uint4(torch.from_numpy(codes))
    np.testing.assert_array_equal(np.asarray(uj), ut.numpy())
    np.testing.assert_array_equal(T.unpack_uint4(ut).numpy(), codes)


@pytest.mark.parametrize("case", sorted(CASES))
def test_quantize_int8_tensor_matches(case):
    w = CASES[case](np.random.default_rng(11))
    qj, qt = J.quantize_int8_tensor(jnp.asarray(w)), T.quantize_int8_tensor(torch.from_numpy(w))
    np.testing.assert_array_equal(np.asarray(qj.values), qt.values.numpy())
    assert np.float32(qj.scale) == qt.scale.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_act_int8_one_absmax_over_whole_tensor(dtype):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 7, 64)) * 3.0).astype(np.float32)
    x[1, 3, 5] = 40.0          # one outlier token sets the scale for all
    x[0, 0, :4] = [0.5, 1.5, -2.5, 2.5]
    # Under jit, as the engine runs it: XLA turns `absmax / 127` into a
    # multiply by the reciprocal, and the port follows that compiled form.
    xj, sj = jax.jit(J.quantize_act_int8)(jnp.asarray(x).astype(dtype))
    xt, st = T.quantize_act_int8(torch.from_numpy(x).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(np.asarray(xj), xt.numpy())
    assert np.float32(sj) == st.numpy()
    assert st.numel() == 1


def test_int8_scale_is_the_compiled_reciprocal_form():
    """A weight whose absmax / 127 rounds differently from absmax * f32(1/127):
    the reference's jitted quantizer gives the latter, and so does the port."""
    w = np.zeros((4, 32), np.float32)
    w[1, 3] = np.float32(0.15403861)
    want = np.float32(w.max()) * np.float32(1.0 / 127.0)
    assert want != np.float32(w.max()) / np.float32(127.0)
    assert np.float32(J.quantize_int8_tensor(jnp.asarray(w)).scale) == want
    assert T.quantize_int8_tensor(torch.from_numpy(w)).scale.numpy() == want


def test_all_zero_activation_keeps_unit_scale():
    xq, s = T.quantize_act_int8(torch.zeros(2, 3, 8))
    assert float(s) == 1.0 and not xq.any()
