"""Chunkwise retention's planner and layout check: the parts of a launch that
plain Python decides, tested here on the CPU (the kernel itself runs only on
the card, tests/test_torch_cuda.py), and the plain version on the strided
views the model hands over, against the Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import retention as Jret
from repro.kernels import ops as Jops
from repro_torch.core import retention as Tret
from repro_torch.kernels import hopper
from repro_torch.kernels import ops as Tops

MAIN = (2, 8, 512, 256, 512, 128)      # B, H, S, dk, dv, chunk of retnet-1.3b prefill
# (B, H, S, dk, dv, chunk) of every retention case of tests/test_torch_cuda.py:
# ragged tiles, a single chunk, and many chunks (16 of 128, 64 of 16).
CARD_SHAPES = [MAIN, (1, 2, 32, 16, 16, 8), (2, 3, 64, 16, 24, 16),
               (2, 1, 128, 32, 64, 32), (1, 4, 96, 40, 72, 96),
               (2, 8, 128, 256, 512, 128), (1, 2, 128, 64, 128, 128),
               (2, 4, 256, 64, 128, 64), (1, 3, 256, 48, 200, 64),
               (1, 8, 2048, 256, 512, 128), (1, 2, 1024, 16, 24, 16)]


def _views(b, h, s, dk, dv, seed=0):
    """q, k, v as the model hands them over: [B, H, S, d] transposes of
    [B, S, H, d] tensors."""
    rng = np.random.default_rng(seed)
    arrs = [(rng.normal(size=(b, s, h, d)) * 0.3).astype(np.float32)
            for d in (dk, dk, dv)]
    return arrs, [torch.from_numpy(a).transpose(1, 2) for a in arrs]


def test_plan_at_the_retnet_prefill_shape():
    b, h, s, dk, dv, c = MAIN
    plan = hopper.retention_plan(b * h, s, dk, dv, c)
    assert plan == dict(n_chunks=4, ldp=128, p_floats=16 * 4 * 128 * 128,
                        s_floats=16 * 3 * 256 * 512)
    # The per-chunk states and scores fit in the 50 MB L2 at this shape...
    assert 4 * (plan["p_floats"] + plan["s_floats"]) < 50e6
    # ...and grow linearly in S past it: 142.6 MB at S 2048.
    long = hopper.retention_plan(b * h, 2048, dk, dv, c)
    assert 4 * (long["p_floats"] + long["s_floats"]) == 16 * (2048 * 128 + 15 * dk * dv) * 4


@pytest.mark.parametrize("b,h,s,dk,dv,c", CARD_SHAPES)
def test_plan_covers_the_card_test_shapes(b, h, s, dk, dv, c):
    plan = hopper.retention_plan(b * h, s, dk, dv, c)
    n = s // c
    assert plan["n_chunks"] == n
    assert plan["ldp"] % 4 == 0 and c <= plan["ldp"] < c + 4
    # One row of scores per position, one state per chunk after the first.
    assert plan["p_floats"] == b * h * n * c * plan["ldp"]
    assert plan["s_floats"] == b * h * (n - 1) * dk * dv


@pytest.mark.parametrize("s,dk,dv,c,match", [
    (512, 256, 512, 256, "chunk"), (512, 512, 512, 128, "dk"), (100, 16, 16, 32, "divisible"),
    (64, 18, 16, 16, "multiples of 4"), (64, 16, 18, 16, "multiples of 4"),
    (64, 16, 16, 0, "chunk"),
])
def test_plan_raises_on_shapes_the_kernel_does_not_take(s, dk, dv, c, match):
    with pytest.raises(ValueError, match=match):
        hopper.retention_plan(4, s, dk, dv, c)


@pytest.mark.parametrize("b,h,s,dk,dv,c", CARD_SHAPES)
def test_model_views_pass_with_their_own_pointers_and_strides(b, h, s, dk, dv, c):
    """The kernel gets the views' own pointers and strides (the layout check
    copies nothing and needs no contiguous input), and y's strides in its
    [B, S, H, dv] buffer, so the model's transpose back is contiguous."""
    _, (q, k, v) = _views(b, h, s, dk, dv)
    assert not q.is_contiguous() or h == 1
    gamma = Tret.head_decays(h)
    plan, ptrs, dims = hopper.retention_dims(q, k, v, gamma, None, c)
    assert ptrs == (q.data_ptr(), k.data_ptr(), v.data_ptr(), gamma.data_ptr(), None)
    assert dims[:7] == (b, h, s, dk, dv, c, plan["ldp"])
    for i, t in enumerate((q, k, v)):
        want = tuple(st if n > 1 else 0 for st, n in zip(t.stride()[:3], t.shape[:3]))
        assert dims[7 + 3 * i:10 + 3 * i] == want
    # A dimension of length 1 is never stepped: its stride goes in as 0.
    assert dims[7:10] == (s * h * dk if b > 1 else 0, dk if h > 1 else 0, h * dk)
    assert dims[16:19] == (s * h * dv, dv, h * dv)
    y_buf = torch.empty(b, s, h, dv)
    y = y_buf.permute(0, 2, 1, 3)
    assert y.stride()[:3] == dims[16:19] and y.transpose(1, 2).is_contiguous()
    assert len(dims) == 19
    # Contiguous [B, H, S, d] inputs pass too, with their own strides.
    qc = q.contiguous()
    state = torch.zeros(b, h, dk, dv)
    _, ptrs_c, dims_c = hopper.retention_dims(qc, k, v, gamma, state, c)
    assert ptrs_c[0] == qc.data_ptr() and ptrs_c[4] == state.data_ptr()
    assert dims_c[7:10] == tuple(st if n > 1 else 0
                                 for st, n in zip(qc.stride()[:3], qc.shape[:3]))


@pytest.mark.parametrize("how", ["last_stride", "row_stride", "head_stride", "base",
                                 "dtype", "chunk", "dk", "state_layout"])
def test_layout_check_raises(how):
    b, h, s, dk, dv, c = 1, 2, 64, 16, 16, 16
    base = torch.zeros(b * h * s * dk * 2 + 8)
    q = base[:b * h * s * dk].view(b, h, s, dk)
    v = torch.zeros(b, h, s, dv)
    state = None
    err = ValueError
    if how == "last_stride":
        q = base[:b * h * s * dk * 2].view(b, h, s, dk, 2)[..., 0]
    elif how == "row_stride":            # rows 18 floats apart
        q = base.as_strided((b, h, s, dk), (h * s * 18, s * 18, 18, 1))
    elif how == "head_stride":           # heads 1026 floats apart
        q = base.as_strided((b, h, s, dk), (2 * 1026, 1026, 16, 1))
    elif how == "base":
        q = base[1:1 + b * h * s * dk].view(b, h, s, dk)
    elif how == "dtype":
        q, err = q.double(), TypeError
    elif how == "chunk":
        c = 2 * hopper.RET_MAX_CHUNK
        q, v = torch.zeros(b, h, 2 * c, dk), torch.zeros(b, h, 2 * c, dv)
    elif how == "dk":
        q = torch.zeros(b, h, s, 2 * hopper.RET_MAX_DK)
    else:
        state = torch.zeros(b, h, dv, dk).transpose(2, 3)
    with pytest.raises(err):
        hopper.retention_dims(q, q, v, Tret.head_decays(h), state, c)


@pytest.mark.parametrize("b,h,s,dk,dv,chunk", [
    (1, 2, 32, 16, 16, 8),
    (2, 3, 64, 16, 24, 16),
    (2, 1, 128, 32, 64, 32),
])
def test_plain_version_on_model_views_matches_pallas(b, h, s, dk, dv, chunk):
    """ops.retention_chunkwise(impl="ref") on the views the kernel takes gives
    what the reference's Pallas kernel (interpret mode) gives on the same
    values, [B, H, S, d] contiguous, at the retention tolerance."""
    arrs, (qt, kt, vt) = _views(b, h, s, dk, dv, seed=s + dv)
    qj, kj, vj = (jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 1, 3))) for a in arrs)
    y_want, s_want = Jops.retention_chunkwise(qj, kj, vj, Jret.head_decays(h), chunk=chunk,
                                              impl="pallas", interpret=True)
    y, s_out = Tops.retention_chunkwise(qt, kt, vt, Tret.head_decays(h), chunk=chunk,
                                        impl="ref")
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s_out.numpy(), np.asarray(s_want), rtol=1e-4, atol=1e-4)
