"""Hopper kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card with ``nvcc`` (the kernels build at
first use) and skips elsewhere.  The module imports neither jax nor the JAX
package, so it runs on a machine without them:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import mxint4 as mx
from repro_torch.core import retention as ret
from repro_torch.kernels import hopper, ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 plain versions in f32


def _gen(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).cuda()


@pytest.mark.parametrize("m,k,n", [
    (2, 2048, 2048), (2, 2048, 4096), (2, 4096, 2048), (2, 2048, 32768),
    (1, 64, 96), (5, 64, 96), (16, 128, 256), (3, 32, 32), (2, 128, 192),
    (9, 1000, 224),
])
def test_mxint4_matmul_kernel(m, k, n):
    rng = _gen(m * 7 + n)
    x = _t(rng.normal(size=(m, k)).astype(np.float32))
    q = mx.quantize_mxint4(_t((rng.normal(size=(k, n)) * 0.05).astype(np.float32)))
    os_ = _t(rng.normal(size=(n,)).astype(np.float32))
    rs = _t(rng.normal(size=(m,)).astype(np.float32))
    b = _t(rng.normal(size=(n,)).astype(np.float32))
    got = ops.mxint4_matmul(x, q, os_, rs, b, impl="kernel")
    want = ref.mxint4_matmul_ref(x, q, os_, rs, b)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    again = ops.mxint4_matmul(x, q, os_, rs, b, impl="kernel")
    assert torch.equal(got, again), "split-K reduction must be deterministic"


@pytest.mark.parametrize("m,k,n", [
    (1024, 2048, 2048), (1024, 4096, 2048), (2, 2048, 32768),
    (5, 64, 96), (16, 128, 64), (1, 32, 32), (130, 48, 208),
])
def test_w8a8_matmul_kernel(m, k, n):
    rng = _gen(m + k + n)
    xq = _t(rng.integers(-127, 128, (m, k)).astype(np.int8))
    wq = _t(rng.integers(-127, 128, (k, n)).astype(np.int8))
    rs = _t(rng.normal(size=(m,)).astype(np.float32))
    b = _t(rng.normal(size=(n,)).astype(np.float32))
    got = ops.w8a8_matmul(xq, wq, 0.01, rs, b, impl="kernel")
    want = ref.w8a8_matmul_ref(xq, wq, 0.01, rs, b)
    torch.testing.assert_close(got, want, rtol=0, atol=0)   # exact integers
    acc = ops.w8a8_matmul(xq, wq, 1.0, impl="kernel")
    exact = (xq.double() @ wq.double()).float()
    assert torch.equal(acc, exact)


@pytest.mark.parametrize("b,h,s,dk,dv,chunk,warm", [
    (2, 8, 512, 256, 512, 128, False), (2, 8, 512, 256, 512, 128, True),
    (1, 2, 32, 16, 16, 8, False), (2, 3, 64, 16, 24, 16, True),
    (2, 1, 128, 32, 64, 32, False), (1, 4, 96, 40, 72, 96, True),
])
def test_retention_chunkwise_kernel(b, h, s, dk, dv, chunk, warm):
    rng = _gen(s + dk + dv)
    q, k = (_t((rng.normal(size=(b, h, s, dk)) * 0.3 / np.sqrt(dk) ** 0.5)
               .astype(np.float32)) for _ in range(2))
    v = _t(rng.normal(size=(b, h, s, dv)).astype(np.float32))
    st = (_t(rng.normal(size=(b, h, dk, dv)).astype(np.float32) * 0.1)
          if warm else None)
    gamma = ret.head_decays(h, device="cuda")
    y, s_out = ops.retention_chunkwise(q, k, v, gamma, chunk=chunk, state=st,
                                       impl="kernel")
    y_ref, s_ref = ref.retention_chunkwise_ref(q, k, v, gamma, chunk=chunk,
                                               state=st)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s_out, s_ref, rtol=1e-4, atol=1e-4)


def test_launch_counters_count_kernel_launches_only():
    hopper.reset_launches()
    x = torch.randn(2, 64, device="cuda")
    q = mx.quantize_mxint4(torch.randn(64, 64, device="cuda") * 0.1)
    ops.mxint4_matmul(x, q, impl="kernel")
    ops.mxint4_matmul(x, q, impl="ref")
    assert hopper.LAUNCHES["mxint4_matmul"] == 1


def test_kernel_impl_on_cpu_raises():
    with pytest.raises(ValueError):
        ops.w8a8_matmul(torch.zeros(2, 16, dtype=torch.int8),
                        torch.zeros(16, 16, dtype=torch.int8), 1.0,
                        impl="kernel")
