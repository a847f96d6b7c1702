"""The port's plain kernel versions against the JAX Pallas kernels.

The Pallas side runs as tests/test_kernels.py runs it on the CPU
(``impl="pallas", interpret=True``), at that file's shapes; the port side is
the plain PyTorch version each Hopper kernel is held against on the card.
Tolerances follow the reference's kernel tests: 1e-5 for MXINT4 and for the
W8A8 epilogue (the integer part exact), 1e-4 for retention.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mxint4 as Jmx
from repro.core import retention as Jret
from repro.kernels import ops as Jops
from repro.kernels import ref as Jref
from repro_torch.core import mxint4 as Tmx
from repro_torch.core import retention as Tret
from repro_torch.kernels import ops as Tops


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (1, 64, 96, 8, 32, 32),
    (5, 64, 96, 8, 32, 32),
    (16, 128, 256, 8, 64, 64),
    (8, 256, 64, 8, 64, 128),
    (3, 32, 32, 8, 32, 32),
])
def test_mxint4_plain_matches_pallas(m, k, n, bm, bn, bk):
    rng = np.random.default_rng(m * 1000 + n)
    w = (rng.normal(size=(k, n)) * 0.1).astype(np.float32)
    xj, xt = _pair(rng.normal(size=(2, m, k)).astype(np.float32))
    osj, ost = _pair(rng.normal(size=(n,)).astype(np.float32))
    rsj, rst = _pair(rng.normal(size=(2, m)).astype(np.float32))
    bj, bt = _pair(rng.normal(size=(n,)).astype(np.float32))
    qj = Jmx.quantize_mxint4(jnp.asarray(w))
    qt = Tmx.quantize_mxint4(torch.from_numpy(w))
    want = Jops.mxint4_matmul(xj, qj, osj, rsj, bj, impl="pallas", interpret=True,
                              block_m=bm, block_n=bn, block_k=bk)
    got = Tops.mxint4_matmul(xt, qt, ost, rst, bt, impl="ref")
    assert got.shape == (2, m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    plain = Tops.mxint4_matmul(xt, qt, impl="ref")
    want_plain = Jops.mxint4_matmul(xj, qj, impl="pallas", interpret=True,
                                    block_m=bm, block_n=bn, block_k=bk)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want_plain),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (5, 64, 96, 8, 32, 32),
    (16, 128, 64, 8, 64, 64),
    (1, 32, 32, 8, 32, 32),
])
def test_w8a8_plain_matches_pallas(m, k, n, bm, bn, bk):
    rng = np.random.default_rng(m + k + n)
    xj, xt = _pair(rng.integers(-127, 128, (m, k)).astype(np.int8))
    wj, wt = _pair(rng.integers(-127, 128, (k, n)).astype(np.int8))
    rsj, rst = _pair(rng.normal(size=(m,)).astype(np.float32))
    bj, bt = _pair(rng.normal(size=(n,)).astype(np.float32))
    want = Jops.w8a8_matmul(xj, wj, jnp.float32(0.01), rsj, bj, impl="pallas",
                            interpret=True, block_m=bm, block_n=bn, block_k=bk)
    got = Tops.w8a8_matmul(xt, wt, torch.tensor(0.01), rst, bt, impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # The integer part is exact: unit scale, no epilogue.
    acc_j = Jops.w8a8_matmul(xj, wj, jnp.float32(1.0), impl="pallas",
                             interpret=True, block_m=bm, block_n=bn, block_k=bk)
    acc_t = Tops.w8a8_matmul(xt, wt, 1.0, impl="ref")
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))


@pytest.mark.parametrize("b,h,s,dk,dv,chunk", [
    (1, 2, 32, 16, 16, 8),
    (2, 3, 64, 16, 24, 16),
    (2, 1, 128, 32, 64, 32),
])
@pytest.mark.parametrize("warm", [False, True])
def test_retention_plain_matches_pallas(b, h, s, dk, dv, chunk, warm):
    rng = np.random.default_rng(s + dv)
    qj, qt = _pair(rng.normal(size=(b, h, s, dk)).astype(np.float32) * 0.3)
    kj, kt = _pair(rng.normal(size=(b, h, s, dk)).astype(np.float32) * 0.3)
    vj, vt = _pair(rng.normal(size=(b, h, s, dv)).astype(np.float32) * 0.3)
    gj, gt = Jret.head_decays(h), Tret.head_decays(h)
    if warm:
        # The Pallas kernel owns a zero state; warm callers use the oracle.
        sj, st = _pair(rng.normal(size=(b, h, dk, dv)).astype(np.float32) * 0.3)
        y_want, s_want = Jref.retention_chunkwise_ref(qj, kj, vj, gj, chunk=chunk,
                                                      state=sj)
    else:
        st = None
        y_want, s_want = Jops.retention_chunkwise(qj, kj, vj, gj, chunk=chunk,
                                                  impl="pallas", interpret=True)
    y, s_out = Tops.retention_chunkwise(qt, kt, vt, gt, chunk=chunk, state=st,
                                        impl="ref")
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s_out.numpy(), np.asarray(s_want), rtol=1e-4, atol=1e-4)


def test_retention_forms_agree():
    """Chunkwise == parallel == recurrent in the port, as in the reference."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 4, 64, d)).astype(np.float32) * 0.3)
               for d in (16, 16, 32))
    g = Tret.head_decays(4)
    y_c, s_c = Tret.retention_chunkwise(q, k, v, g, chunk=16)
    y_r, s_r = Tret.retention_recurrent(q, k, v, g)
    torch.testing.assert_close(y_c, Tret.retention_parallel(q, k, v, g),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(y_c, y_r, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s_c, s_r, rtol=1e-4, atol=1e-4)


def test_fused_rmsnorm_and_rope_match_reference():
    from repro.core import fused_rmsnorm as Jfr
    from repro.core import online_rope as Jrope
    from repro_torch.core import fused_rmsnorm as Tfr
    from repro_torch.core import online_rope as Trope
    rng = np.random.default_rng(4)
    yj, yt = _pair(rng.normal(size=(2, 5, 64)).astype(np.float32))
    gj, gt = _pair(rng.normal(size=(64,)).astype(np.float32))
    for a, b in zip(Jfr.fused_rmsnorm_emit(yj, gj), Tfr.fused_rmsnorm_emit(yt, gt)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(Tfr.rmsnorm(yt, gt).numpy(),
                               np.asarray(Jfr.rmsnorm(yj, gj)), rtol=1e-6, atol=1e-6)
    thj, tht = Jrope.rope_thetas(32), Trope.rope_thetas(32)
    np.testing.assert_allclose(tht.numpy(), np.asarray(thj), rtol=1e-6)
    sj, st = Jrope.init_state(32, pos=3), Trope.init_state(32, pos=3)
    for _ in range(70):            # crosses the resync at position 64
        sj, st = Jrope.advance(sj, thj), Trope.advance(st, tht)
    assert st.pos == int(sj.pos) == 73
    np.testing.assert_allclose(st.sin.numpy(), np.asarray(sj.sin), atol=2e-5)
    np.testing.assert_allclose(st.cos.numpy(), np.asarray(sj.cos), atol=2e-5)
    np.testing.assert_allclose(Trope.apply_rope(yt[..., :32], st.sin, st.cos).numpy(),
                               np.asarray(Jrope.embed(sj, yj[..., :32])), atol=1e-4)
