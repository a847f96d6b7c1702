"""The port's KV-cache codecs (`repro_torch.core.kvq`) against `repro.core.kvq`.

Encoded bytes must be identical.  int8_tok's ``absmax / 127.0`` has two forms
in the reference: eager JAX divides, and XLA compiles the division into a
multiply by f32(1/127) under jit.  The engine encodes in both places (the
prefill cache eagerly in `_encode_cache`, every appended decode row inside
the jitted decode loop), so the tests pin which form each place produces and
hold the port to the same one there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import kvq as Jkvq
from repro.models import layers as JL
from repro.models import lm as Jlm
from repro_torch.core import kvq as Tkvq
from repro_torch.models import layers as TL
from repro_torch.models import lm as Tlm

_jit_encode = jax.jit(Jkvq.encode, static_argnums=1)


def _rows(case: str, seed: int = 0) -> np.ndarray:
    """Cache-shaped rows [B, C, KV, d] with per-row magnitudes over 3 decades."""
    rng = np.random.default_rng(seed)
    d = 24 if case == "ragged_d" else 64
    x = rng.normal(size=(2, 40, 2, d)).astype(np.float32)
    x *= rng.uniform(0.01, 10.0, size=(2, 40, 2, 1)).astype(np.float32)
    if case == "zero_rows":
        x[0, :7] = 0.0
        x[1, 3, 1, :16] = 0.0           # one zero mxint4 group inside a row
    return x


def _assert_same_leaf(got: dict, want: dict):
    assert set(got) == set(want)
    for name in want:
        w = np.asarray(want[name])
        g = got[name].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("form", ["eager", "jit"])
@pytest.mark.parametrize("case", ["random", "zero_rows", "ragged_d"])
@pytest.mark.parametrize("fmt", Tkvq.FORMATS)
def test_encode_bytes_identical_to_jax(fmt, case, form):
    x = _rows(case)
    want = (Jkvq.encode(jnp.asarray(x), fmt) if form == "eager"
            else _jit_encode(jnp.asarray(x), fmt))
    got = Tkvq.encode(torch.from_numpy(x), fmt, reciprocal=form == "jit")
    _assert_same_leaf(got, want)
    if case == "ragged_d":              # 24 is no multiple of 16
        assert Tkvq.leaf_format(got) == "int8_tok"
    np.testing.assert_array_equal(Tkvq.decode(got).numpy(),
                                  np.asarray(Jkvq.decode(want)))


def test_int8_tok_scale_forms_are_division_eager_and_reciprocal_jitted():
    """The two forms differ in the last bit on some rows; eager JAX gives the
    division, jitted JAX the reciprocal multiply, and the port gives each."""
    x = _rows("random", seed=3).reshape(-1, 64)
    eager = np.asarray(Jkvq.encode(jnp.asarray(x), "int8_tok")["s"])
    jitted = np.asarray(_jit_encode(jnp.asarray(x), "int8_tok")["s"])
    absmax = np.abs(x).max(-1, keepdims=True)
    assert np.array_equal(eager, absmax / np.float32(127.0))
    assert np.array_equal(jitted, absmax * np.float32(1.0 / 127.0))
    assert (eager != jitted).any(), "pick inputs where the forms differ"
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(Tkvq.encode(xt, "int8_tok")["s"].numpy(), eager)
    np.testing.assert_array_equal(
        Tkvq.encode(xt, "int8_tok", reciprocal=True)["s"].numpy(), jitted)


CFG = get_config("qwen3-8b").reduced()


def _disagreeing_rows(seed: int = 5) -> np.ndarray:
    """K rows ``[B, S, KV, hd]`` whose int8_tok scale differs between the two
    forms in at least one row, so the site tests below can tell them apart."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 16, CFG.n_kv_heads, CFG.head_dim_)).astype(np.float32)
    x *= rng.uniform(0.01, 10.0, size=x.shape[:-1] + (1,)).astype(np.float32)
    absmax = np.abs(x).max(-1, keepdims=True)
    assert (absmax / np.float32(127.0) != absmax * np.float32(1 / 127.0)).any()
    return x


@pytest.mark.parametrize("fmt", Tkvq.FORMATS)
def test_prefill_boundary_site_is_eager(fmt):
    """`lm.quantize_cache`, as the JAX engine's `_encode_cache` runs it (no
    jit), against the port's `quantize_cache`."""
    k = _disagreeing_rows()
    v = k[:, ::-1].copy()
    jcache = {"pos": jnp.int32(16), "blocks": {
        "k": jnp.asarray(k)[None], "v": jnp.asarray(v)[None]}}
    want = Jlm.quantize_cache(jcache, CFG, fmt)["blocks"]
    tcache = {"pos": 16, "blocks": [{"k": torch.from_numpy(k),
                                     "v": torch.from_numpy(v)}]}
    got = Tlm.quantize_cache(tcache, CFG, fmt)["blocks"][0]
    for name in ("k", "v"):
        _assert_same_leaf(got[name], {n: a[0] for n, a in want[name].items()})


@pytest.mark.parametrize("fmt", Tkvq.FORMATS)
def test_decode_append_site_is_jitted(fmt):
    """`layers.cache_update` as the jitted decode loop runs it, against the
    port's in-place `cache_update`, row by row into a zero cache."""
    rows = _disagreeing_rows()
    shape = (2, 20, CFG.n_kv_heads, CFG.head_dim_)
    upd = jax.jit(JL.cache_update)
    jleaf = JL.make_cache_leaf(shape, fmt)
    tleaf = TL.make_cache_leaf(shape, fmt)
    _assert_same_leaf(tleaf, jleaf)
    for pos in range(rows.shape[1]):
        row = rows[:, pos:pos + 1]
        jleaf = upd(jleaf, jnp.asarray(row), jnp.int32(pos))
        out = TL.cache_update(tleaf, torch.from_numpy(row), torch.tensor(pos, dtype=torch.int32))
        assert out is tleaf             # written in place
    _assert_same_leaf(tleaf, jleaf)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_plain_cache_leaves_match_jax(dtype):
    """f32 and legacy int8 (static scale 32) leaves: encode, append, decode."""
    x = _rows("random", seed=9)[:, :5] * 0.1
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = JL.to_cache_dtype(jnp.asarray(x), jd)
    got = TL.to_cache_dtype(torch.from_numpy(x), td)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(TL.from_cache_dtype(got).numpy(),
                                  np.asarray(JL.from_cache_dtype(want)))
    leaf = TL.make_cache_leaf((2, 8, 2, 64), td)
    TL.cache_update(leaf, torch.from_numpy(x[:, :1]), torch.tensor(3, dtype=torch.int32))
    jleaf = JL.cache_update(JL.make_cache_leaf((2, 8, 2, 64), jd),
                            jnp.asarray(x[:, :1]), 3)
    np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))


@pytest.mark.parametrize("d", [64, 24, 128])
@pytest.mark.parametrize("fmt", Tkvq.FORMATS)
def test_zeros_and_sizes_match_jax(fmt, d):
    shape = (2, 5, 3, d)
    _assert_same_leaf(Tkvq.zeros(shape, fmt), Jkvq.zeros(shape, fmt))
    _assert_same_leaf(Tkvq.zeros(shape, fmt), Jkvq.encode(jnp.zeros(shape), fmt))
    assert Tkvq.effective_format(fmt, d) == Jkvq.effective_format(fmt, d)
    assert Tkvq.nbytes_per_row(fmt, d) == Jkvq.nbytes_per_row(fmt, d)
    assert Tkvq.decoded_dim(Tkvq.zeros(shape, fmt)) == d
    assert Tkvq.nbytes_per_row(torch.float32, d) == Jkvq.nbytes_per_row(jnp.float32, d)


def test_format_checks():
    assert Tkvq.is_format("int8_tok") and not Tkvq.is_format(torch.float32)
    assert Tkvq.leaf_format(torch.zeros(2)) is None
    with pytest.raises(ValueError, match="unknown cache format"):
        Tkvq.check_format("fp8")
    with pytest.raises(TypeError):
        Tkvq.encode_like(torch.zeros(2, 16), torch.zeros(2, 16))
    enc = Tkvq.encode(torch.ones(1, 32), "mxint4_blk")
    assert Tkvq.encode(enc, "int8_tok") is enc       # encoded leaves pass through
