"""Hopper kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card with ``nvcc`` (the kernels build at
first use) and skips elsewhere.  The module imports neither jax nor the JAX
package, so it runs on a machine without them:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.core import kvq
from repro_torch.core import mxint4 as mx
from repro_torch.core import retention as ret
from repro_torch.kernels import hopper, ops, ref
from repro_torch.models import deploy, layers

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


def _kv(n: int) -> torch.Tensor:
    """kv_len as the kernels read it: an int32 scalar on the card."""
    return torch.tensor(n, dtype=torch.int32, device="cuda")


def _expert_stacks(rng, e, k, n):
    if e * k * n > 1 << 28:       # ds3's 256 experts: drawn on the card, from rng's seed
        g = torch.Generator(device="cuda")
        g.manual_seed(int(rng.integers(1 << 31)))
        w = torch.randn(e, k, n, generator=g, device="cuda") * k ** -0.5
    else:
        w = _t((rng.normal(size=(e, k, n)) / np.sqrt(k)).astype(np.float32))
    return deploy.quantize_stacked(w)


# (A, E, K, N): olmoe's decode (A = B 2 x top 8) and verify (A = 2 x 5 x 8)
# at its wg / wi (2048 -> 1024) and wo (1024 -> 2048), the reduced widths,
# ragged K (100; 98, no multiple of 4: x's rows padded for the kernel's
# tiles) and N not a multiple of the 512-column tile, and the ds3_mtp head
# step's (B 2 x top 8 of 256 experts, 7168 -> 2048 and 2048 -> 7168).
EXPERT_SHAPES = [(16, 64, 2048, 1024), (16, 64, 1024, 2048), (80, 64, 2048, 1024),
                 (80, 64, 1024, 2048), (4, 4, 128, 64), (4, 4, 64, 128), (3, 8, 100, 96),
                 (1, 2, 32, 32), (16, 256, 7168, 2048), (16, 256, 2048, 7168),
                 (5, 4, 98, 64)]


@pytest.mark.parametrize("routing", ["random", "one_expert", "distinct"])
@pytest.mark.parametrize("a,e,k,n", EXPERT_SHAPES)
def test_mxint4_expert_matmul_kernel(a, e, k, n, routing):
    """Row a times expert ids[a] against the plain version (gather,
    dequantize, bmm) at 1e-5; a relaunch bit-equal; one launch counted."""
    rng = _gen(a + e + k + n)
    packed, exps = _expert_stacks(rng, e, k, n)
    x = _t(rng.normal(size=(a, k)).astype(np.float32))
    ids = _expert_ids(routing, rng, a, e)
    before = hopper.LAUNCHES["mxint4_expert_matmul"]
    got = ops.mxint4_expert_matmul(x, packed, exps, ids, impl="kernel")
    assert hopper.LAUNCHES["mxint4_expert_matmul"] == before + 1
    want = ref.mxint4_expert_matmul_ref(x, packed, exps, ids)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, ops.mxint4_expert_matmul(x, packed, exps, ids, impl="kernel"))
    # A row of an expert equals the dense GEMV's product with that expert.
    q = mx.MXINT4Weight(packed[int(ids[0])], exps[int(ids[0])], (k, n))
    torch.testing.assert_close(got[:1], ref.mxint4_matmul_ref(x[:1], q), rtol=1e-5,
                               atol=1e-5)


def test_mxint4_expert_matmul_graph_replays_any_routing():
    """One captured launch, its ids rewritten in place between replays: each
    replay equals an eager launch with those ids (nothing of the routing is
    read on the host or baked into the graph)."""
    rng = _gen(5)
    packed, exps = _expert_stacks(rng, 64, 2048, 1024)
    x = _t(rng.normal(size=(16, 2048)).astype(np.float32))
    ids = _t(rng.integers(0, 64, 16).astype(np.int64))
    ops.mxint4_expert_matmul(x, packed, exps, ids, impl="kernel")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with hopper.captured_launches() as rec, torch.cuda.graph(graph):
        out = ops.mxint4_expert_matmul(x, packed, exps, ids, impl="kernel")
    assert rec["mxint4_expert_matmul"] == 1
    for seed in range(4):
        ids.copy_(_t(_gen(seed).integers(0, 64, 16).astype(np.int64)))
        graph.replay()
        eager = ops.mxint4_expert_matmul(x, packed, exps, ids, impl="kernel")
        torch.cuda.synchronize()
        assert torch.equal(out, eager), f"routing {seed}"


def _expert_ids(routing, rng, a, e):
    ids = {"random": rng.integers(0, e, a), "one_expert": np.full(a, e - 1),
           "distinct": np.arange(a) % e}[routing]
    return _t(ids.astype(np.int64))


@pytest.mark.parametrize("routing", ["random", "one_expert", "distinct"])
@pytest.mark.parametrize("k,n", [(2048, 1024), (1024, 2048)])
def test_mxint4_expert_matmul_rows_are_isolated(k, n, routing):
    """Every row of an A 16 and an A 80 launch is bit-equal to that row
    launched alone (A 1), and to that row in a launch whose other rows all
    move to other experts: a row's bits do not depend on the rest of the
    launch (the scheduler's lane-isolation gates rest on it)."""
    rng = _gen(k + n + len(routing))
    e = 64
    packed, exps = _expert_stacks(rng, e, k, n)
    for a in (16, 80):
        x = _t(rng.normal(size=(a, k)).astype(np.float32))
        ids = _expert_ids(routing, rng, a, e)
        got = ops.mxint4_expert_matmul(x, packed, exps, ids, impl="kernel")
        for i in range(a):
            alone = ops.mxint4_expert_matmul(x[i:i + 1], packed, exps, ids[i:i + 1],
                                             impl="kernel")
            assert torch.equal(got[i], alone[0]), f"A {a}, row {i} against alone"
            # Every other row to another expert (some join row i's).
            moved = (ids + 1 + torch.arange(a, device="cuda") % (e - 1)) % e
            moved[i] = ids[i]
            with_others = ops.mxint4_expert_matmul(x, packed, exps, moved, impl="kernel")
            assert torch.equal(got[i], with_others[i]), f"A {a}, row {i}, others moved"


@pytest.mark.parametrize("a,e,k,n", [(16, 64, 2048, 1024), (80, 64, 1024, 2048),
                                     (3, 8, 100, 96)])
def test_mxint4_expert_matmul_bad_id_reads_nan(a, e, k, n):
    """An id of -1 or E makes its row NaN and leaves every other row exact:
    bit-equal to the same launch with those rows routed to valid experts,
    and within 1e-5 of the plain version."""
    rng = _gen(a + k)
    packed, exps = _expert_stacks(rng, e, k, n)
    x = _t(rng.normal(size=(a, k)).astype(np.float32))
    ids = _t(rng.integers(0, e, a).astype(np.int64))
    bad = ids.clone()
    bad[0], bad[a - 1] = -1, e
    got = ops.mxint4_expert_matmul(x, packed, exps, bad, impl="kernel")
    assert torch.isnan(got[0]).all() and torch.isnan(got[a - 1]).all()
    good = ops.mxint4_expert_matmul(x, packed, exps, ids, impl="kernel")
    rest = slice(1, a - 1)
    assert torch.equal(got[rest], good[rest])
    torch.testing.assert_close(got[rest], ref.mxint4_expert_matmul_ref(x, packed, exps, ids)[rest],
                               rtol=1e-5, atol=1e-5)


def test_mxint4_expert_matmul_rejects_what_it_does_not_take():
    packed, exps = _expert_stacks(_gen(1), 4, 64, 64)
    x = torch.zeros(3, 64, device="cuda")
    ids = torch.zeros(3, dtype=torch.int64, device="cuda")
    with pytest.raises(TypeError, match="int64"):
        hopper.mxint4_expert_matmul(x, packed, exps, ids.int())
    with pytest.raises(ValueError, match="shape"):
        hopper.mxint4_expert_matmul(torch.zeros(3, 32, device="cuda"), packed, exps, ids)
    with pytest.raises(ValueError, match="contiguous"):
        hopper.mxint4_expert_matmul(x, packed.transpose(1, 2).contiguous().transpose(1, 2),
                                    exps, ids)


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


# Every linear shape (K, N) of the retnet-1.3b and qwen3-8b main paths.
MAIN_SHAPES = [(2048, 2048), (2048, 4096), (4096, 2048), (2048, 32768),
               (4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096),
               (4096, 152064)]


@functools.lru_cache(maxsize=2)
def _mx_weight(k, n):
    g = torch.Generator(device="cuda")
    g.manual_seed(k * 7 + n)
    return mx.quantize_mxint4(torch.randn(k, n, generator=g, device="cuda") * k ** -0.5)


@pytest.mark.parametrize("k,n", MAIN_SHAPES)
@pytest.mark.parametrize("m", [1, 2, 3, 4, 8, 9])
def test_mxint4_matmul_kernel_main_shapes(k, n, m):
    """Each row tile (1, 2, 4, 8; 9 rows take two) at every main-path shape:
    within 1e-5 of the plain version, relaunches bit-equal."""
    q = _mx_weight(k, n)
    g = torch.Generator(device="cuda")
    g.manual_seed(m)
    x = torch.randn(m, k, generator=g, device="cuda")
    os_ = torch.rand(n, generator=g, device="cuda") + 0.5
    rs = torch.rand(m, generator=g, device="cuda") + 0.5
    b = torch.randn(n, generator=g, device="cuda")
    got = ops.mxint4_matmul(x, q, os_, rs, b, impl="kernel")
    torch.testing.assert_close(got, ref.mxint4_matmul_ref(x, q, os_, rs, b),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got, ops.mxint4_matmul(x, q, os_, rs, b, impl="kernel"))


def _w8(rng, k, n):
    """A random int8 weight [K, N] stored K-major, as deploy stores it."""
    return deploy.k_major(_t(rng.integers(-127, 128, (k, n)).astype(np.int8)))


@pytest.mark.parametrize("m,k,n", [
    (1024, 2048, 2048), (1024, 4096, 2048), (2, 2048, 32768),
    (5, 64, 96), (16, 128, 64), (1, 32, 32), (130, 48, 208),
])
def test_w8a8_matmul_kernel(m, k, n):
    rng = _gen(m + k + n)
    xq = _t(rng.integers(-127, 128, (m, k)).astype(np.int8))
    wq = _w8(rng, k, n)
    rs = _t(rng.normal(size=(m,)).astype(np.float32))
    b = _t(rng.normal(size=(n,)).astype(np.float32))
    got = ops.w8a8_matmul(xq, wq, 0.01, rs, b, impl="kernel")
    want = ref.w8a8_matmul_ref(xq, wq, 0.01, rs, b)
    torch.testing.assert_close(got, want, rtol=0, atol=0)   # exact integers
    acc = ops.w8a8_matmul(xq, wq, 1.0, impl="kernel")
    exact = (xq.double() @ wq.double()).float()
    assert torch.equal(acc, exact)


@pytest.mark.parametrize("m,k,n", (
    [(1024, k, n) for k, n in MAIN_SHAPES[:-1]]
    + [(m, 4096, 4096) for m in (1, 2, 17, 64, 65, 1000)]
    + [(2, 4096, 152064), (17, 4096, 208), (1000, 48, 4096), (65, 48, 208)]
    # chunked admission: chunk linears at M = B x c, and MLA's per-chunk
    # re-expansion of the whole latent (M = B x capacity, K = kv_lora_rank)
    + [(64, 4096, 12288), (8, 2048, 4096), (1064, 512, 16384)]))
def test_w8a8_matmul_kernel_shapes(m, k, n):
    """Every main-path shape at M = 1024, the small-M tiles and their edge
    (64 / 65 rows), the M = 2 lm_head, N ragged against the tile (208) and K
    shorter than one stage (48): bit-exact, relaunches bit-equal."""
    g = torch.Generator(device="cuda")
    g.manual_seed(m + k + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda").to(torch.int8)
    wq = deploy.k_major(torch.randint(-127, 128, (k, n), generator=g,
                                      device="cuda").to(torch.int8))
    sc = torch.tensor(1e-4, device="cuda")
    rs = torch.rand(m, generator=g, device="cuda") + 0.5
    b = torch.randn(n, generator=g, device="cuda")
    got = ops.w8a8_matmul(xq, wq, sc, rs, b, impl="kernel")
    torch.testing.assert_close(got, ref.w8a8_matmul_ref(xq, wq, sc, rs, b),
                               rtol=0, atol=0)
    assert torch.equal(got, ops.w8a8_matmul(xq, wq, sc, rs, b, impl="kernel"))


@pytest.mark.parametrize("m,k,n", [(2, 3200, 132), (1024, 3200, 132), (10, 3200, 132),
                                   (2, 100, 3200), (1024, 100, 3200), (64, 256, 24),
                                   (64, 8, 256), (10, 37, 45)])
def test_w8a8_matmul_kernel_padded_shapes(m, k, n):
    """K or N not a multiple of 16 (hymba's x_proj N 132 and dt_proj K 100,
    the reduced SSM configs' N 24 and K 8): the kernel runs on the
    zero-padded buffers deploy holds, exact against the unpadded plain
    product."""
    g = torch.Generator(device="cuda")
    g.manual_seed(m * 3 + k + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda").to(torch.int8)
    w8 = torch.randint(-127, 128, (k, n), generator=g, device="cuda").to(torch.int8)
    wq = deploy.k_major(w8)
    b = deploy.padded_vector(torch.randn(n, generator=g, device="cuda"))
    rs = torch.rand(m, generator=g, device="cuda") + 0.5
    sc = torch.tensor(1e-4, device="cuda")
    got = ops.w8a8_matmul(xq, wq, sc, rs, b, n=n, impl="kernel")
    want = ref.w8a8_matmul_ref(xq, w8, sc, rs, b[:n])
    assert got.shape == (m, n) and wq.shape == (ops.up16(k), ops.up16(n))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert torch.equal(got, ops.w8a8_matmul(xq, wq, sc, rs, b, n=n, impl="kernel"))


def test_w8a8_matmul_kernel_rejects_row_major_weight():
    xq = torch.zeros(64, 256, dtype=torch.int8, device="cuda")
    wq = torch.zeros(256, 128, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="K-major"):
        ops.w8a8_matmul(xq, wq, 1.0, impl="kernel")
    assert ops.w8a8_matmul(xq, deploy.k_major(wq), 1.0, impl="kernel").shape == (64, 128)


# (B, H, S, dk, dv, chunk, warm) of every retention case: the retnet-1.3b
# prefill shape, ragged tiles (s = chunk = 96 among them), a single chunk,
# four chunks of 64, and many chunks (16 of 128 at the retnet-1.3b head
# shape, 64 of 16), whose incoming states all pass through the scratch.
RETENTION_CASES = [
    (2, 8, 512, 256, 512, 128, False), (2, 8, 512, 256, 512, 128, True),
    (1, 2, 32, 16, 16, 8, False), (2, 3, 64, 16, 24, 16, True),
    (2, 1, 128, 32, 64, 32, False), (1, 4, 96, 40, 72, 96, True),
    (2, 8, 128, 256, 512, 128, False), (1, 2, 128, 64, 128, 128, True),
    (2, 4, 256, 64, 128, 64, False), (1, 3, 256, 48, 200, 64, True),
    (1, 8, 2048, 256, 512, 128, False), (1, 8, 2048, 256, 512, 128, True),
    (1, 2, 1024, 16, 24, 16, False), (1, 2, 1024, 16, 24, 16, True),
    # chunked admission at the retnet-1.3b head shape: one chunk of each
    # size of the ladder below 128, from a warm state
    (2, 8, 32, 256, 512, 32, True), (2, 8, 16, 256, 512, 16, True),
    (2, 8, 4, 256, 512, 4, True), (2, 8, 2, 256, 512, 2, True),
    (2, 8, 1, 256, 512, 1, True),
]


@pytest.mark.parametrize("b,h,s,dk,dv,chunk,warm", RETENTION_CASES)
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


def _retention_inputs(b, h, s, dk, dv, warm, model_layout):
    """Seeded q, k, v (and a warm state); with ``model_layout`` the [B, H, S, d]
    views the model hands over: transposes of [B, S, H, d] tensors."""
    rng = _gen(s + dk + dv)
    shape = (lambda d: (b, s, h, d)) if model_layout else (lambda d: (b, h, s, d))
    q, k = (_t((rng.normal(size=shape(dk)) * dk ** -0.5).astype(np.float32))
            for _ in range(2))
    v = _t(rng.normal(size=shape(dv)).astype(np.float32))
    if model_layout:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    st = (_t(rng.normal(size=(b, h, dk, dv)).astype(np.float32) * 0.1)
          if warm else None)
    return q, k, v, st


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("b,h,s,dk,dv,chunk", [(2, 8, 512, 256, 512, 128),
                                               (2, 3, 64, 16, 24, 16)])
def test_retention_chunkwise_kernel_model_layout(b, h, s, dk, dv, chunk, warm):
    """The model's transpose(1, 2) views go in as they are, and y comes back
    as a view whose transpose back is contiguous."""
    q, k, v, st = _retention_inputs(b, h, s, dk, dv, warm, True)
    assert not q.is_contiguous()
    gamma = ret.head_decays(h, device="cuda")
    y, s_out = ops.retention_chunkwise(q, k, v, gamma, chunk=chunk, state=st,
                                       impl="kernel")
    assert y.transpose(1, 2).is_contiguous()
    y_ref, s_ref = ref.retention_chunkwise_ref(q.contiguous(), k.contiguous(),
                                               v.contiguous(), gamma, chunk=chunk,
                                               state=st)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s_out, s_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("model_layout", [False, True])
@pytest.mark.parametrize("b,h,s,dk,dv,chunk,warm", RETENTION_CASES)
def test_retention_chunkwise_kernel_relaunch_bit_equal(b, h, s, dk, dv, chunk, warm,
                                                       model_layout):
    q, k, v, st = _retention_inputs(b, h, s, dk, dv, warm, model_layout)
    gamma = ret.head_decays(h, device="cuda")
    first = ops.retention_chunkwise(q, k, v, gamma, chunk=chunk, state=st, impl="kernel")
    for _ in range(2):
        again = ops.retention_chunkwise(q, k, v, gamma, chunk=chunk, state=st,
                                        impl="kernel")
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


# (B, H, S, dk, dv, chunk, warm, final-state cotangent) of the backward
# kernel: retnet-1.3b's training shape (zero state, no cotangent of the
# final state), the warm tail of a 200-token sequence (72 rows from the
# state the whole chunks carried), ragged tiles and chunks below 64, the
# reduced model's widths, and many chunks; then the edges of the kernel's
# tiles: dk and dv that are not multiples of 32 or 64, chunks that are not
# multiples of 16 (24, 120), one chunk with both a warm state and a
# final-state cotangent, and one head pair at the full per-head width.
RETENTION_BWD_CASES = [
    (2, 8, 512, 256, 512, 128, False, False), (2, 8, 72, 256, 512, 72, True, False),
    (2, 8, 128, 256, 512, 128, True, True), (1, 2, 32, 16, 16, 8, True, True),
    (2, 3, 64, 16, 24, 16, False, True), (1, 4, 96, 40, 72, 96, True, False),
    (1, 3, 256, 48, 200, 64, True, True), (2, 4, 128, 32, 64, 128, False, False),
    (2, 4, 72, 32, 64, 72, True, False), (1, 2, 1024, 16, 24, 16, True, True),
    (1, 2, 13, 8, 12, 13, True, True),
    (1, 2, 96, 36, 100, 24, True, True), (2, 2, 240, 36, 100, 120, False, True),
    (1, 2, 360, 100, 36, 120, True, False), (1, 2, 120, 36, 100, 120, True, True),
    (1, 2, 256, 256, 512, 128, True, True),
]


def _bwd_inputs(b, h, s, dk, dv, warm, final):
    q, k, v, st = _retention_inputs(b, h, s, dk, dv, warm, True)
    rng = _gen(s + dk + dv + 1)
    dy = _t(rng.normal(size=(b, h, s, dv)).astype(np.float32))
    ds = _t(rng.normal(size=(b, h, dk, dv)).astype(np.float32) * 0.1) if final else None
    return q, k, v, st, dy, ds


def _rel_err(got, want):
    return ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()


@pytest.mark.parametrize("b,h,s,dk,dv,chunk,warm,final", RETENTION_BWD_CASES)
def test_retention_chunkwise_bwd_kernel(b, h, s, dk, dv, chunk, warm, final):
    """dq, dk, dv (and a warm state's cotangent) against autograd of the
    plain version at 1e-4 of max|plain|, one count per call, and a relaunch
    bit-equal (no atomics)."""
    q, k, v, st, dy, ds = _bwd_inputs(b, h, s, dk, dv, warm, final)
    gamma = ret.head_decays(h, device="cuda")
    before = hopper.LAUNCHES["retention_chunkwise_bwd"]
    got = hopper.retention_chunkwise_bwd(q, k, v, gamma, st, dy, ds, chunk, need_dstate=warm)
    assert hopper.LAUNCHES["retention_chunkwise_bwd"] == before + 1
    want = ref.retention_chunkwise_bwd_ref(q, k, v, gamma, st, dy, ds, chunk)
    for name, g, w in zip(("dq", "dk", "dv", "dstate"), got, want):
        if w is None:
            assert g is None, name
            continue
        assert _rel_err(g, w) < 1e-4, (name, _rel_err(g, w))
    again = hopper.retention_chunkwise_bwd(q, k, v, gamma, st, dy, ds, chunk, need_dstate=warm)
    for g, a in zip(got, again):
        assert g is None or torch.equal(g, a)


@pytest.mark.parametrize("s", [512, 200, 64])
def test_retention_under_grad_runs_both_kernels(s):
    """Under grad on CUDA tensors the op runs the forward kernel and, in
    backward, the backward kernel (no plain fallback), and its gradients
    match autograd of the plain version; with grad off the output is the
    plain kernel call's, bit for bit.  The model's two-part split (whole
    chunks, then the tail from the carried state) passes the tail's state
    cotangent back into the head."""
    b, h, dk, dv = 2, 4, 32, 64
    q0, k0, v0, _ = _retention_inputs(b, h, s, dk, dv, False, True)
    gamma = ret.head_decays(h, device="cuda")
    dy = _t(_gen(s).normal(size=(b, h, s, dv)).astype(np.float32))

    def run(impl):
        q, k, v = (t.detach().clone().requires_grad_(True) for t in (q0, k0, v0))
        whole, ys, state = s - s % 128, [], None
        for lo, hi in ((0, whole), (whole, s)):
            if hi > lo:
                y, state = ops.retention_chunkwise(q[:, :, lo:hi], k[:, :, lo:hi],
                                                   v[:, :, lo:hi], gamma, chunk=min(128, hi - lo),
                                                   state=state, impl=impl)
                ys.append(y)
        torch.cat(ys, dim=2).backward(dy)
        return torch.cat(ys, dim=2).detach(), [t.grad for t in (q, k, v)]

    hopper.reset_launches()
    y, grads = run("kernel")
    parts = int(s >= 128) + int(s % 128 > 0)
    assert hopper.LAUNCHES["retention_chunkwise"] == parts
    assert hopper.LAUNCHES["retention_chunkwise_bwd"] == parts
    y_r, grads_r = run("ref")
    assert _rel_err(y, y_r) < 1e-4
    for g, w in zip(grads, grads_r):
        assert g is not None and _rel_err(g, w) < 1e-4
    with torch.no_grad():
        plain = ops.retention_chunkwise(q0[:, :, :128], k0[:, :, :128], v0[:, :, :128], gamma,
                                        chunk=min(128, s), impl="kernel")[0]
    q, k, v = (t.detach().requires_grad_(True) for t in (q0, k0, v0))
    graded = ops.retention_chunkwise(q[:, :, :128], k[:, :, :128], v[:, :, :128], gamma,
                                     chunk=min(128, s), impl="kernel")[0]
    assert torch.equal(plain, graded.detach())


@pytest.mark.parametrize("how", ["last_stride", "row_stride", "base", "chunk", "dk"])
def test_retention_chunkwise_kernel_rejects_misaligned_views(how):
    b, h, s, dk, dv = 1, 2, 64, 16, 16
    base = torch.randn(b * h * s * dk * 2 + 8, device="cuda")
    q = base[:b * h * s * dk].view(b, h, s, dk)
    chunk = 16
    if how == "last_stride":
        q = base[:b * h * s * dk * 2].view(b, h, s, dk, 2)[..., 0]
    elif how == "row_stride":       # rows 18 floats apart: not 16-byte aligned
        q = base.as_strided((b, h, s, dk), (h * s * 18, s * 18, 18, 1))
    elif how == "base":
        q = base[1:1 + b * h * s * dk].view(b, h, s, dk)
    elif how == "chunk":
        chunk = 2 * hopper.RET_MAX_CHUNK
        q = torch.randn(b, h, 2 * chunk, dk, device="cuda")
    else:
        q = torch.randn(b, h, s, 2 * hopper.RET_MAX_DK, device="cuda")
    k = q
    v = torch.randn(*q.shape[:3], dv, device="cuda")
    before = hopper.LAUNCHES["retention_chunkwise"]
    with pytest.raises(ValueError):
        ops.retention_chunkwise(q, k, v, ret.head_decays(h, device="cuda"), chunk=chunk,
                                impl="kernel")
    assert hopper.LAUNCHES["retention_chunkwise"] == before


def _cache_leaf(x: torch.Tensor, fmt: str):
    if fmt in kvq.FORMATS:
        return kvq.encode(x, fmt)
    return layers.to_cache_dtype(x, getattr(torch, fmt))


@pytest.mark.parametrize("fmt", ["float32", "bfloat16", "int8", "int8_tok",
                                 "mxint4_blk"])
@pytest.mark.parametrize("b,kv,g,d,c,kv_len", [
    (2, 8, 4, 128, 544, 528), (2, 8, 4, 128, 544, 1), (2, 8, 4, 128, 544, 544),
    (1, 2, 1, 64, 200, 1), (1, 2, 1, 64, 200, 200), (3, 1, 8, 128, 200, 77),
    (2, 2, 4, 32, 200, 200), (1, 4, 8, 64, 33, 33),
])
def test_flash_decode_kernel(fmt, b, kv, g, d, c, kv_len):
    """Each cache format, C not a multiple of the 32-row tile, kv_len 1 and C,
    G in {1, 4, 8}: kernel vs plain on the same encoded bytes, at the
    reference's decode tolerance; two launches bit-equal."""
    rng = _gen(b * 1000 + c + kv_len + g)
    q = _t(rng.normal(size=(b, kv, g, d)).astype(np.float32))
    k = _cache_leaf(_t(rng.normal(size=(b, c, kv, d)).astype(np.float32)), fmt)
    v = _cache_leaf(_t(rng.normal(size=(b, c, kv, d)).astype(np.float32)), fmt)
    n = _kv(kv_len)
    got = ops.flash_decode(q, k, v, n, impl="kernel")
    want = ref.flash_decode_ref(q, k, v, n)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)
    again = ops.flash_decode(q, k, v, n, impl="kernel")
    assert torch.equal(got, again), "split merge must be deterministic"


def test_flash_decode_kernel_mixed_formats_and_scale():
    rng = _gen(5)
    q = _t(rng.normal(size=(2, 2, 4, 64)).astype(np.float32))
    k = kvq.encode(_t(rng.normal(size=(2, 96, 2, 64)).astype(np.float32)), "mxint4_blk")
    v = _t(rng.normal(size=(2, 96, 2, 64)).astype(np.float32))
    for scale in (None, 0.05):
        got = ops.flash_decode(q, k, v, _kv(70), scale=scale, impl="kernel")
        want = ref.flash_decode_ref(q, k, v, _kv(70), scale=scale)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)


def _flash_decode_case(seed, fmts, b, kv, g, d, c, kv_len, scale=None, dv=None):
    """Kernel vs plain on the same encoded bytes at the reference's decode
    tolerance, and a relaunch bit-equal to the first."""
    rng = _gen(seed)
    dv = d if dv is None else dv
    q = _t(rng.normal(size=(b, kv, g, d)).astype(np.float32))
    k = _cache_leaf(_t(rng.normal(size=(b, c, kv, d)).astype(np.float32)), fmts[0])
    v = _cache_leaf(_t(rng.normal(size=(b, c, kv, dv)).astype(np.float32)), fmts[1])
    n = _kv(kv_len)
    got = ops.flash_decode(q, k, v, n, scale=scale, impl="kernel")
    want = ref.flash_decode_ref(q, k, v, n, scale=scale)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)
    again = ops.flash_decode(q, k, v, n, scale=scale, impl="kernel")
    assert torch.equal(got, again), "split merge must be deterministic"


ALL_FORMATS = ["float32", "bfloat16", "int8", "int8_tok", "mxint4_blk"]
MAIN_FORMATS = ["float32", "int8_tok", "mxint4_blk"]


@pytest.mark.parametrize("fmt", MAIN_FORMATS)
@pytest.mark.parametrize("kv_len", [1, 16, 17, 257, 528, 544])
def test_flash_decode_kernel_olmoe_shape(fmt, kv_len):
    """olmoe-1b-7b's decode: 16 heads over 16 KV heads (G 1: three of the
    kernel's four group rows idle), d 128, C 544."""
    _flash_decode_case(kv_len, (fmt, fmt), 2, 16, 1, 128, 544, kv_len)


@pytest.mark.parametrize("fmt", MAIN_FORMATS)
@pytest.mark.parametrize("c,kv_len", [(1536, 1536), (1536, 1535), (1536, 1),
                                      (544, 1), (544, 17), (544, 257), (544, 544)])
def test_flash_decode_kernel_seamless_shapes(fmt, c, kv_len):
    """seamless-m4t-medium's decode: 16 heads over 16 KV heads (G 1) of 64;
    the cross-attention reads its full 1536-frame cache (``kv_len`` = C),
    the self-attention a 544-slot cache."""
    _flash_decode_case(c + kv_len, (fmt, fmt), 2, 16, 1, 64, c, kv_len)


@pytest.mark.parametrize("fmt", MAIN_FORMATS)
@pytest.mark.parametrize("kv_len", [1, 5, 64, 511, 1023, 1024])
def test_flash_decode_kernel_hymba_ring_shape(fmt, kv_len):
    """hymba-1.5b's decode attention: 25 heads over 5 KV heads (G 5: two
    group chunks, the second holding one head), head dim 64, its
    1024-slot ring, ``kv_len = min(pos + 1, 1024)``."""
    _flash_decode_case(kv_len, (fmt, fmt), 2, 5, 5, 64, 1024, kv_len)


@pytest.mark.parametrize("fmt", ALL_FORMATS)
@pytest.mark.parametrize("kv_len", [31, 32, 33, 127, 129, 513])
def test_flash_decode_kernel_qwen3_lengths(fmt, kv_len):
    """qwen3-8b's decode shape (B 2, KV 8, G 4, d 128, C 544) at kv_len on
    both sides of a 16-row tile and of a split boundary."""
    _flash_decode_case(kv_len, (fmt, fmt), 2, 8, 4, 128, 544, kv_len)


@pytest.mark.parametrize("scale", [None, 0.07])
@pytest.mark.parametrize("v_fmt", MAIN_FORMATS)
@pytest.mark.parametrize("k_fmt", MAIN_FORMATS)
def test_flash_decode_kernel_mixed_main_formats(k_fmt, v_fmt, scale):
    """Each main-path format on each side, with the score scale given or
    sqrt(d)."""
    _flash_decode_case(17, (k_fmt, v_fmt), 2, 8, 4, 128, 544, 300, scale=scale)


@pytest.mark.parametrize("fmt", ALL_FORMATS)
@pytest.mark.parametrize("b,kv,g,d,c,kv_len", [
    (1, 2, 1, 256, 300, 300), (2, 2, 16, 256, 200, 177), (1, 3, 16, 128, 100, 100),
])
def test_flash_decode_kernel_limits(fmt, b, kv, g, d, c, kv_len):
    """G in {1, 16} and d = dv = 256, the kernel's limits: two 128-wide slots
    per row, and G in chunks of query heads."""
    _flash_decode_case(g * d + kv_len, (fmt, fmt), b, kv, g, d, c, kv_len)


def test_flash_decode_kernel_head_dims_differ():
    _flash_decode_case(3, ("int8_tok", "float32"), 2, 2, 4, 64, 80, 80, dv=192)


@pytest.mark.parametrize("fmt,part", [("float32", None), ("bfloat16", None),
                                      ("int8_tok", "q"), ("mxint4_blk", "m"),
                                      ("mxint4_blk", "e")])
def test_flash_decode_kernel_rejects_misaligned_views(fmt, part):
    """An operand whose base is off its chunk alignment raises: the kernel
    has no scalar path."""
    b, c, kv, d = 1, 40, 2, 64
    q = torch.randn(b, kv, 4, d, device="cuda")
    leaf = _cache_leaf(torch.randn(b, c, kv, d, device="cuda"), fmt)
    if part is None:
        buf = torch.empty(leaf.numel() + 8, dtype=leaf.dtype, device="cuda")
        bad = buf[1:leaf.numel() + 1].view(leaf.shape)
        bad.copy_(leaf)
    else:
        arr = leaf[part]
        buf = torch.empty(arr.numel() + 8, dtype=arr.dtype, device="cuda")
        shifted = buf[1:arr.numel() + 1].view(arr.shape)
        shifted.copy_(arr)
        bad = dict(leaf, **{part: shifted})
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_decode(q, bad, leaf, _kv(c), impl="kernel")


def _mla_inputs(seed, fmt, b, h, r, dr, c, q_std=None):
    """MLA-mode operands.  The absorbed query q_nope . wk_b of a unit-variance
    q_nope (deepseek-v3's nope width 128) against a unit-RMS latent of width
    r has std sqrt(128 / r) per element, so that the latent term has the
    nope term's variance, as the model's 1 / sqrt(dn + dr) scale assumes:
    q is drawn at that std (capped at 1) unless ``q_std`` is given."""
    rng = _gen(seed)
    q_std = min(1.0, (128 / r) ** 0.5) if q_std is None else q_std
    q = _t((rng.normal(size=(b, h, r)) * q_std).astype(np.float32))
    q2 = _t(rng.normal(size=(b, h, dr)).astype(np.float32))
    lat = _cache_leaf(_t(rng.normal(size=(b, c, r)).astype(np.float32)), fmt)
    rope = _cache_leaf(_t(rng.normal(size=(b, c, dr)).astype(np.float32)), fmt)
    return q, q2, lat, rope


def _mla_case(seed, fmt, b, h, r, dr, c, kv_len, scale=0.0722):
    """Flash-decode's MLA mode against its plain version on the same encoded
    bytes, the latent leaf as K and V, at the reference's decode tolerance;
    a relaunch bit-equal to the first."""
    q, q2, lat, rope = _mla_inputs(seed, fmt, b, h, r, dr, c)
    n = _kv(kv_len)
    got = ops.flash_decode(q, lat, lat, n, q2=q2, k2=rope, scale=scale, impl="kernel")
    want = ref.flash_decode_ref(q, lat, lat, n, q2=q2, k2=rope, scale=scale)
    assert got.shape == (b, h, r) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)
    again = ops.flash_decode(q, lat, lat, n, q2=q2, k2=rope, scale=scale, impl="kernel")
    assert torch.equal(got, again), "the cluster merge must be deterministic"


@pytest.mark.parametrize("fmt", ALL_FORMATS)
@pytest.mark.parametrize("kv_len", [1, 33, 257, 300, 528, 544])
def test_flash_decode_mla_kernel_main_shape(fmt, kv_len):
    """deepseek-v3's decode (B 2, H 128, latent 512, rope 64, C 544) at
    kv_len 1, C, a split boundary and lengths off the 32-row tile."""
    _mla_case(kv_len, fmt, 2, 128, 512, 64, 544, kv_len)


@pytest.mark.parametrize("fmt", ALL_FORMATS)
@pytest.mark.parametrize("kv_len", [1, 13, 24])
def test_flash_decode_mla_kernel_reduced_shape(fmt, kv_len):
    """The reduced cut (H 4, latent 32, rope 16, C 24): mxint4_blk's rope rows
    are 8 bytes with 1-byte exponent rows, copied in narrow chunks."""
    _mla_case(kv_len + 100, fmt, 2, 4, 32, 16, 24, kv_len, scale=0.144)


@pytest.mark.parametrize("fmt", MAIN_FORMATS)
@pytest.mark.parametrize("b,h,r,dr,c,kv_len", [
    (1, 20, 256, 64, 300, 300), (3, 17, 128, 32, 100, 61), (1, 128, 512, 64, 1000, 999),
    (2, 1, 64, 16, 64, 64), (1, 8, 384, 128, 70, 65),
    (2, 24, 512, 64, 544, 528), (2, 33, 512, 64, 544, 300), (2, 100, 512, 64, 544, 257),
    (4, 128, 512, 64, 544, 528), (6, 128, 512, 64, 544, 97), (4, 40, 512, 128, 200, 200),
])
def test_flash_decode_mla_kernel_other_shapes(fmt, b, h, r, dr, c, kv_len):
    """Head counts off the 16-head group (1, 17, 20, 24, 33, 100), latent
    widths of 64 to 512 (384: twelve of the 16 warps' 32-column groups), the
    widest rope, a long cache, and batches of 4 and 6 whose 32 and 48
    clusters take 3 and 2 splits."""
    _mla_case(h * r + kv_len, fmt, b, h, r, dr, c, kv_len)


@pytest.mark.parametrize("fmt", ALL_FORMATS)
def test_flash_decode_mla_kernel_takes_the_widest_rows(fmt):
    """Latent 512 with the widest rope in every format: the launch lays out
    its own shared memory and takes these rows within the card's."""
    _mla_case(17, fmt, 1, 16, 512, 128, 100, 100)


@pytest.mark.parametrize("fmt", MAIN_FORMATS)
@pytest.mark.parametrize("kv_len", [31, 32, 63, 64, 65, 95, 96, 97, 191, 192, 193, 512])
def test_flash_decode_mla_kernel_tile_and_split_edges(fmt, kv_len):
    """kv_len at and around the 32-row tile and the splits' edges at the main
    shape (1 to 6 splits of whole tiles), a partial last tile's rows zeroed."""
    _mla_case(kv_len + 7, fmt, 2, 128, 512, 64, 544, kv_len)


def _mla_wide_case(q, q2, lat, rope, kv_len, scale):
    """A case whose cache values span many decades: the kernel against a
    float64 evaluation of the decoded cache at the decode tolerance in units
    of the latent's largest value, and a relaunch bit-equal to the first.
    (The outputs reach that value, so an absolute 2e-6 is below f32's
    resolution there; the plain f32 version errs 3-4x more than the kernel
    against float64 on these inputs.)"""
    got = ops.flash_decode(q, lat, lat, _kv(kv_len), q2=q2, k2=rope, scale=scale,
                           impl="kernel")
    again = ops.flash_decode(q, lat, lat, _kv(kv_len), q2=q2, k2=rope, scale=scale,
                             impl="kernel")
    assert torch.equal(got, again), "the cluster merge must be deterministic"
    ld, rd = (kvq.decode(x)[:, :kv_len].double() for x in (lat, rope))
    s = (torch.einsum("bhr,bcr->bhc", q.double(), ld)
         + torch.einsum("bhr,bcr->bhc", q2.double(), rd)) * scale
    want = torch.einsum("bhc,bcr->bhr", torch.softmax(s, dim=-1), ld)
    unit = ld.abs().max()
    torch.testing.assert_close(got.double() / unit, want / unit, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("kv_len", [1, 97, 528])
def test_flash_decode_mla_kernel_int8_tok_scales_span_six_decades(kv_len):
    """int8_tok rows whose scales run from 1e-3 to 1e3 (latent and rope rows
    apart): the kernel scales each stream's scores by its rows' scales and
    folds the latent's into P.  The score scale keeps the largest scores
    near 3."""
    b, h, r, dr, c = 2, 128, 512, 64, 544
    rng = _gen(kv_len + 31)
    q, q2, _, _ = _mla_inputs(kv_len, "float32", b, h, r, dr, c)

    def leaf(width):
        mag = 10.0 ** rng.uniform(-3, 3, size=(b, c, 1)) * 127 / 3
        return kvq.encode(_t((rng.normal(size=(b, c, width)) * mag).astype(np.float32)),
                          "int8_tok")

    lat, rope = leaf(r), leaf(dr)
    s_all = torch.cat([lat["s"].flatten(), rope["s"].flatten()])
    assert s_all.min() < 2e-3 and s_all.max() > 5e2
    _mla_wide_case(q, q2, lat, rope, kv_len, 6e-6)


@pytest.mark.parametrize("kv_len", [1, 97, 528])
def test_flash_decode_mla_kernel_mxint4_exponents_at_their_extremes(kv_len):
    """mxint4_blk groups whose shared exponents sit at -9 and 5, the ends of
    their range (groups scaled 2^-12 .. 2^7 clamp there), mixed in every
    row of the latent and the rope."""
    b, h, r, dr, c = 2, 128, 512, 64, 544
    rng = _gen(kv_len + 37)
    q, q2, _, _ = _mla_inputs(kv_len, "float32", b, h, r, dr, c)

    def leaf(width):
        scale = 2.0 ** rng.choice([-12, -9, 5, 7], size=(b, c, width // 16, 1))
        x = rng.normal(size=(b, c, width // 16, 16)) * scale
        return kvq.encode(_t(x.reshape(b, c, width).astype(np.float32)), "mxint4_blk")

    lat, rope = leaf(r), leaf(dr)
    for e in (lat["e"], rope["e"]):
        assert int(e.min()) == -9 and int(e.max()) == 5
    _mla_wide_case(q, q2, lat, rope, kv_len, 0.0722 / 8)


@pytest.mark.parametrize("kv_len", [33, 300, 528])
def test_flash_decode_mla_kernel_unit_queries_against_float64(kv_len):
    """With q ~ N(0, 1) at the main shape the scores span about +-7, and the
    plain f32 version's own error against float64 nears the 2e-6 atol; the
    kernel, whose per-lane sums and reduction tree are shorter, is held to
    the float64 evaluation at the same tolerance."""
    q, q2, lat, rope = _mla_inputs(kv_len, "float32", 2, 128, 512, 64, 544, q_std=1.0)
    scale = 0.0722
    got = ops.flash_decode(q, lat, lat, _kv(kv_len), q2=q2, k2=rope, scale=scale,
                           impl="kernel")
    qd, q2d, ld, rd = (t.double() for t in (q, q2, lat[:, :kv_len], rope[:, :kv_len]))
    s = (torch.einsum("bhr,bcr->bhc", qd, ld) + torch.einsum("bhr,bcr->bhc", q2d, rd)) * scale
    want = torch.einsum("bhc,bcr->bhr", torch.softmax(s, dim=-1), ld)
    torch.testing.assert_close(got.double(), want, rtol=2e-5, atol=2e-6)


def test_flash_decode_mla_kernel_needs_v_to_be_k():
    """The kernel reads each latent row once for K and V: a distinct v leaf
    raises (the plain version takes it, as the reference does)."""
    q, q2, lat, rope = _mla_inputs(1, "int8_tok", 2, 16, 64, 16, 40)
    other = {n: t.clone() for n, t in lat.items()}
    with pytest.raises(ValueError, match="same leaf"):
        ops.flash_decode(q, lat, other, _kv(40), q2=q2, k2=rope, scale=0.1, impl="kernel")
    got = ops.flash_decode(q, lat, other, _kv(40), q2=q2, k2=rope, scale=0.1, impl="ref")
    want = ops.flash_decode(q, lat, lat, _kv(40), q2=q2, k2=rope, scale=0.1, impl="kernel")
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)


def test_flash_decode_mla_kernel_rejects_mixed_formats():
    q, q2, lat, _ = _mla_inputs(2, "int8_tok", 1, 16, 64, 16, 40)
    rope = torch.randn(1, 40, 16, device="cuda")
    with pytest.raises(ValueError, match="one format"):
        ops.flash_decode(q, lat, lat, _kv(40), q2=q2, k2=rope, scale=0.1, impl="kernel")


@pytest.mark.parametrize("fmt,stream,part", [
    ("float32", "lat", None), ("bfloat16", "lat", None), ("int8_tok", "lat", "q"),
    ("mxint4_blk", "lat", "m"), ("mxint4_blk", "lat", "e"), ("float32", "rope", None),
])
def test_flash_decode_mla_kernel_rejects_misaligned_views(fmt, stream, part):
    """A stream whose base is off its rows' copy width raises."""
    q, q2, lat, rope = _mla_inputs(3, fmt, 1, 16, 512, 64, 40)
    leaf = lat if stream == "lat" else rope
    arr = leaf if part is None else leaf[part]
    buf = torch.empty(arr.numel() + 8, dtype=arr.dtype, device="cuda")
    shifted = buf[1:arr.numel() + 1].view(arr.shape)
    shifted.copy_(arr)
    bad = shifted if part is None else dict(leaf, **{part: shifted})
    lat, rope = (bad, rope) if stream == "lat" else (lat, bad)
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_decode(q, lat, lat, _kv(40), q2=q2, k2=rope, scale=0.1, impl="kernel")


@pytest.mark.parametrize("r,dr", [(516, 64), (512, 6), (512, 132), (2, 16)])
def test_flash_decode_mla_kernel_rejects_widths_it_does_not_take(r, dr):
    """Latent widths past 4 slots or not whole float4s, rope rows too narrow
    or too wide, raise before any launch."""
    q, q2, lat, rope = _mla_inputs(4, "float32", 1, 4, r, dr, 40)
    with pytest.raises(ValueError, match="MLA"):
        ops.flash_decode(q, lat, lat, _kv(40), q2=q2, k2=rope, scale=0.1, impl="kernel")


# The shapes the served models normalise (PERF.md), the old checks' small
# ones, and edge widths: D = 1, 3, 4095 and M = 1.
RMS_SHAPES = [
    (1024, 4096, torch.float32), (1024, 4096, torch.bfloat16),
    (1024, 2048, torch.float32), (1024, 2048, torch.bfloat16),
    (1024, 7168, torch.float32), (1024, 7168, torch.bfloat16),
    (1024, 1536, torch.float32), (1024, 1536, torch.bfloat16),
    (32768, 128, torch.float32), (32768, 128, torch.bfloat16),
    (16384, 4096, torch.bfloat16), (1000, 4096, torch.float32), (2, 4096, torch.bfloat16),
    (7, 96, torch.float32), (13, 100, torch.bfloat16), (5, 3, torch.float32),
    (1, 4096, torch.bfloat16), (3, 1, torch.float32), (9, 4095, torch.bfloat16),
    (9, 4095, torch.float32),
]


def _rms_input(m, d, dtype, seed=None):
    return _t(_gen(m + d if seed is None else seed).normal(size=(m, d)).astype(np.float32)
              ).to(dtype)


@pytest.mark.parametrize("m,d,dtype", RMS_SHAPES)
def test_rmsnorm_stats_kernel(m, d, dtype):
    y = _rms_input(m, d, dtype)
    got = ops.rmsnorm_stats(y, impl="kernel")
    want = ref.rmsnorm_stats_ref(y)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m,d,dtype", RMS_SHAPES)
def test_rmsnorm_stats_kernel_against_float64(m, d, dtype):
    """At unit scale the f32 sums stay within the plain version's tolerance
    of a float64 evaluation of the same (bf16 or f32) inputs."""
    y = _rms_input(m, d, dtype)
    want = torch.rsqrt(y.double().square().mean(dim=-1) + 1e-6)
    torch.testing.assert_close(ops.rmsnorm_stats(y, impl="kernel").double(), want,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m,d,dtype", RMS_SHAPES)
def test_rmsnorm_stats_kernel_relaunch_bit_equal(m, d, dtype):
    y = _rms_input(m, d, dtype)
    assert torch.equal(ops.rmsnorm_stats(y, impl="kernel"), ops.rmsnorm_stats(y, impl="kernel"))


@pytest.mark.parametrize("m,d,dtype,loads", [
    (1024, 4096, torch.bfloat16, 2), (1024, 7168, torch.float32, 2),
    (32768, 128, torch.bfloat16, 2), (9, 4095, torch.bfloat16, 2), (2, 4096, torch.bfloat16, 1),
    (1, 4096, torch.bfloat16, 1), (33, 100, torch.float32, 1),
])
def test_rmsnorm_stats_kernel_every_load_count(m, d, dtype, loads):
    """Both counts of loads per thread the kernel builds, each where the
    planner picks it: two for many rows, or for rows of 2-byte loads past
    one round of 1024 threads ([9, 4095] bf16), one for few rows."""
    y = _rms_input(m, d, dtype)
    w = hopper.rms_width(y.data_ptr(), y.stride(0) * y.element_size(), y.element_size())
    assert hopper.rmsnorm_stats_plan(m, d, y.element_size(), hopper._sms(y.device),
                                     w)["loads"] == loads
    torch.testing.assert_close(ops.rmsnorm_stats(y, impl="kernel"),
                               ref.rmsnorm_stats_ref(y), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scale", [1e30, 1e15, 1e-15, 1e-30])
def test_rmsnorm_stats_kernel_extreme_rows(scale, dtype):
    """Rows near 1e+-30 (their squares overflow to inf or underflow to 0
    in f32, as in the plain version), near 1e+-15 (squares near 1e+-30,
    still normal), and an all-zero row, whose sigma^{-1} is rsqrt(eps)."""
    y = _rms_input(6, 4096, torch.float32, seed=5) * scale
    y[3] = 0.0
    y = y.to(dtype)
    got = ops.rmsnorm_stats(y, impl="kernel")
    torch.testing.assert_close(got, ref.rmsnorm_stats_ref(y), rtol=1e-6, atol=1e-6)
    assert got[3].item() == pytest.approx(1e3, rel=1e-6)
    if 1e-20 < scale < 1e20:
        want = torch.rsqrt(y.double().square().mean(dim=-1) + 1e-6)
        torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=0.0)


def test_rmsnorm_stats_kernel_unaligned_rows():
    """A view starting 4 bytes in takes the narrower loads."""
    base = _t(_gen(3).normal(size=(9 * 64 + 1,)).astype(np.float32))
    y = base[1:].view(9, 64)
    torch.testing.assert_close(ops.rmsnorm_stats(y, impl="kernel"),
                               ref.rmsnorm_stats_ref(y), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype,offset,stride,d", [
    (torch.bfloat16, 1, 4096, 4096), (torch.bfloat16, 2, 4100, 4096),
    (torch.bfloat16, 4, 4104, 4100), (torch.bfloat16, 0, 4097, 4097),
    (torch.float32, 1, 4096, 4096), (torch.float32, 2, 4098, 4095),
    (torch.float32, 0, 132, 100), (torch.float32, 4, 136, 99),
])
def test_rmsnorm_stats_kernel_strided_views(dtype, offset, stride, d):
    """Views at 2-, 4-, 8- and 16-byte alignment, rows padded past D, D
    not a whole number of loads: each read in place, one kernel per call."""
    m = 37
    buf = _rms_input(1, offset + m * stride, dtype)[0]
    y = buf[offset:offset + m * stride].view(m, stride)[:, :d]
    assert y.stride() == (stride, 1)
    torch.testing.assert_close(ops.rmsnorm_stats(y, impl="kernel"),
                               ref.rmsnorm_stats_ref(y), rtol=1e-6, atol=1e-6)
    assert _kernels_of(lambda: ops.rmsnorm_stats(y, impl="kernel")) == 1


def test_rmsnorm_stats_kernel_reads_a_strided_view_in_place():
    """The q-half of a [M, 2D] projection: one kernel per call, no copy."""
    x = _rms_input(1024, 8192, torch.bfloat16)
    y = x[:, :4096]
    launched = _kernel_names(lambda: ops.rmsnorm_stats(y, impl="kernel"))
    assert len(launched) == 1 and "rmsnorm_stats_kernel" in launched[0], launched
    torch.testing.assert_close(ops.rmsnorm_stats(y, impl="kernel"),
                               ref.rmsnorm_stats_ref(y), rtol=1e-6, atol=1e-6)


def test_rmsnorm_stats_kernel_rejects_other_layouts():
    """Rows whose elements are not adjacent, or leading dims that do not
    flatten to one stride, raise instead of being copied."""
    x = _rms_input(64, 128, torch.float32)
    with pytest.raises(ValueError, match="adjacent"):
        hopper.rmsnorm_stats(x.t(), 1e-6)
    with pytest.raises(ValueError, match="stride"):
        ops.rmsnorm_stats(x.t(), impl="kernel")
    z = _rms_input(8, 4 * 128, torch.float32).view(8, 4, 128).transpose(0, 1)
    with pytest.raises(ValueError, match="stride"):
        ops.rmsnorm_stats(z, impl="kernel")
    with pytest.raises(TypeError):
        ops.rmsnorm_stats(x.half(), impl="kernel")


def _kernel_names(fn) -> list:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def _kernels_of(fn) -> int:
    return len(_kernel_names(fn))


def test_launch_counters_count_kernel_launches_only():
    hopper.reset_launches()
    x = torch.randn(2, 64, device="cuda")
    q = mx.quantize_mxint4(torch.randn(64, 64, device="cuda") * 0.1)
    ops.mxint4_matmul(x, q, impl="kernel")
    ops.mxint4_matmul(x, q, impl="ref")
    assert hopper.LAUNCHES["mxint4_matmul"] == 1
    qd = torch.randn(1, 2, 4, 32, device="cuda")
    kc = torch.randn(1, 40, 2, 32, device="cuda")
    ops.flash_decode(qd, kc, kc, _kv(40), impl="kernel")
    ops.flash_decode(qd, kc, kc, _kv(40))                 # auto: the kernel
    ops.flash_decode(qd, kc, kc, _kv(40), impl="ref")
    ops.rmsnorm_stats(x, impl="kernel")
    ops.rmsnorm_stats(x, impl="ref")
    assert hopper.LAUNCHES["flash_decode"] == 2
    q, q2, lat, rope = _mla_inputs(0, "float32", 1, 4, 32, 16, 24)
    ops.flash_decode(q, lat, lat, _kv(20), q2=q2, k2=rope, scale=0.1, impl="kernel")
    ops.flash_decode(q, lat, lat, _kv(20), q2=q2, k2=rope, scale=0.1, impl="ref")
    assert hopper.LAUNCHES["flash_decode_mla"] == 1
    assert hopper.LAUNCHES["flash_decode"] == 2
    assert hopper.LAUNCHES["rmsnorm_stats"] == 1
    assert hopper.LAUNCHES["w8a8_matmul"] == hopper.LAUNCHES["retention_chunkwise"] == 0


def test_kernel_impl_on_cpu_raises():
    with pytest.raises(ValueError):
        ops.w8a8_matmul(torch.zeros(2, 16, dtype=torch.int8),
                        torch.zeros(16, 16, dtype=torch.int8), 1.0,
                        impl="kernel")


# -- kv_len in device memory: one launch, and one captured graph, per capacity --------

DEVICE_LENS = [1, 15, 16, 17, 543, 544]           # C 544: tile edges, C - 1, C


@pytest.mark.parametrize("fmt", ALL_FORMATS)
@pytest.mark.parametrize("kv_len", DEVICE_LENS)
def test_flash_decode_kernel_device_kv_len(fmt, kv_len):
    """qwen3-8b's decode shape at C 544, whose plan (17 splits of 32 rows) no
    longer depends on kv_len: at kv_len 1 .. 17 every split but the first
    streams nothing and merges as an empty partial."""
    _flash_decode_case(kv_len + 3, (fmt, fmt), 2, 8, 4, 128, 544, kv_len)


@pytest.mark.parametrize("fmt", ALL_FORMATS)
@pytest.mark.parametrize("kv_len", DEVICE_LENS)
def test_flash_decode_mla_kernel_device_kv_len(fmt, kv_len):
    """deepseek-v3's decode at C 544 (6 splits a cluster): at kv_len <= 96
    the later splits stream nothing but still join the cluster's merge."""
    _mla_case(kv_len + 5, fmt, 2, 128, 512, 64, 544, kv_len)


def hopper_fmt(fmt: str) -> str:
    """A torch dtype name as `hopper.CACHE_FORMATS` names the format."""
    return {"float32": "f32", "bfloat16": "bf16"}.get(fmt, fmt)


@pytest.mark.parametrize("fmt", ALL_FORMATS)
def test_flash_decode_kernel_one_row_of_a_long_cache_is_that_row(fmt):
    """kv_len 1 of 544 rows: the softmax of one score is 1, so the output is
    the first V row, decoded, exactly; 16 of the 17 splits were empty."""
    rng = _gen(41)
    q = _t(rng.normal(size=(2, 8, 4, 128)).astype(np.float32))
    k, v = (_cache_leaf(_t(rng.normal(size=(2, 544, 8, 128)).astype(np.float32)), fmt)
            for _ in range(2))
    plan = hopper.flash_decode_plan(2, 8, 4, 128, 128, 544, hopper_fmt(fmt), hopper_fmt(fmt))
    assert plan["splits"] == 17
    got = ops.flash_decode(q, k, v, _kv(1), impl="kernel")
    want = kvq.decode(v)[:, 0][:, :, None].expand(2, 8, 4, 128)
    assert torch.equal(got, want)


def _replayed_against_eager(run, lens):
    """One graph of ``run(kv_len)`` captured at the first length, replayed
    while kv_len is advanced in device memory, against a launch at each
    length: bit-equal."""
    kv_len = _kv(lens[0])
    run(kv_len)                                         # build and plan first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with hopper.captured_launches() as recorded, torch.cuda.graph(graph):
        out = run(kv_len)
    assert sum(recorded.values()) == 1
    for n in lens:
        kv_len.fill_(n)
        graph.replay()
        eager = run(_kv(n))
        torch.cuda.synchronize()
        assert torch.equal(out, eager), f"kv_len {n}: replay differs from a launch"


@pytest.mark.parametrize("fmt", MAIN_FORMATS)
def test_flash_decode_kernel_graph_replays_at_every_kv_len(fmt):
    rng = _gen(43)
    q = _t(rng.normal(size=(2, 8, 4, 128)).astype(np.float32))
    k, v = (_cache_leaf(_t(rng.normal(size=(2, 544, 8, 128)).astype(np.float32)), fmt)
            for _ in range(2))
    _replayed_against_eager(lambda n: ops.flash_decode(q, k, v, n, impl="kernel"),
                            [513, 1, 16, 17, 300, 543, 544])


@pytest.mark.parametrize("fmt", MAIN_FORMATS)
def test_flash_decode_mla_kernel_graph_replays_at_every_kv_len(fmt):
    q, q2, lat, rope = _mla_inputs(47, fmt, 2, 128, 512, 64, 544)
    _replayed_against_eager(
        lambda n: ops.flash_decode(q, lat, lat, n, q2=q2, k2=rope, scale=0.0722,
                                   impl="kernel"),
        [513, 1, 32, 33, 97, 543, 544])


# -- per-lane kv_len: a slot class whose lanes sit at different positions ------------

LANE_LENS = [(1, 528), (528, 300), (544, 17), (33, 32)]


@pytest.mark.parametrize("fmt", ALL_FORMATS)
@pytest.mark.parametrize("lens", LANE_LENS, ids=str)
def test_flash_decode_kernel_per_lane_kv_len(fmt, lens):
    """qwen3-8b's decode shape with one kv_len per lane against the plain
    version; an all-equal vector bit-identical to the scalar."""
    rng = _gen(sum(lens))
    q = _t(rng.normal(size=(2, 8, 4, 128)).astype(np.float32))
    k, v = (_cache_leaf(_t(rng.normal(size=(2, 544, 8, 128)).astype(np.float32)), fmt)
            for _ in range(2))
    n = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = ops.flash_decode(q, k, v, n, impl="kernel")
    torch.testing.assert_close(got, ref.flash_decode_ref(q, k, v, n), rtol=2e-5, atol=2e-6)
    for i, length in enumerate(lens):
        lane = ops.flash_decode(q, k, v, _kv(length), impl="kernel")[i]
        torch.testing.assert_close(got[i], lane, rtol=2e-5, atol=2e-6)
    same = torch.tensor([lens[0]] * 2, dtype=torch.int32, device="cuda")
    assert torch.equal(ops.flash_decode(q, k, v, same, impl="kernel"),
                       ops.flash_decode(q, k, v, _kv(lens[0]), impl="kernel"))


@pytest.mark.parametrize("fmt", ALL_FORMATS)
@pytest.mark.parametrize("lens", LANE_LENS, ids=str)
def test_flash_decode_mla_kernel_per_lane_kv_len(fmt, lens):
    q, q2, lat, rope = _mla_inputs(sum(lens) + 1, fmt, 2, 128, 512, 64, 544)
    run = lambda n: ops.flash_decode(q, lat, lat, n, q2=q2, k2=rope, scale=0.0722,  # noqa: E731
                                     impl="kernel")
    n = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = run(n)
    want = ref.flash_decode_ref(q, lat, lat, n, q2=q2, k2=rope, scale=0.0722)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)
    same = torch.tensor([lens[1]] * 2, dtype=torch.int32, device="cuda")
    assert torch.equal(run(same), run(_kv(lens[1])))


@pytest.mark.parametrize("mla", [False, True], ids=["gqa", "mla"])
def test_flash_decode_graph_replays_at_every_per_lane_kv_len(mla):
    """One graph captured on a [2] kv_len, replayed while both lanes' lengths
    move apart in device memory, against a launch at each pair."""
    if mla:
        q, q2, lat, rope = _mla_inputs(51, "float32", 2, 128, 512, 64, 544)
        run = lambda n: ops.flash_decode(q, lat, lat, n, q2=q2, k2=rope,  # noqa: E731
                                         scale=0.0722, impl="kernel")
    else:
        rng = _gen(53)
        q = _t(rng.normal(size=(2, 8, 4, 128)).astype(np.float32))
        k, v = (_t(rng.normal(size=(2, 544, 8, 128)).astype(np.float32)) for _ in range(2))
        run = lambda n: ops.flash_decode(q, k, v, n, impl="kernel")  # noqa: E731
    kv_len = torch.tensor([5, 300], dtype=torch.int32, device="cuda")
    run(kv_len)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with hopper.captured_launches() as recorded, torch.cuda.graph(graph):
        out = run(kv_len)
    assert sum(recorded.values()) == 1
    for pair in ((1, 544), (528, 300), (17, 16), (544, 544)):
        kv_len.copy_(torch.tensor(pair, dtype=torch.int32))
        graph.replay()
        eager = run(torch.tensor(pair, dtype=torch.int32, device="cuda"))
        torch.cuda.synchronize()
        assert torch.equal(out, eager), f"kv_len {pair}: replay differs from a launch"


@pytest.mark.parametrize("arch,fmt", [("retnet-1.3b", None), ("qwen3-8b", None),
                                      ("qwen3-8b", "int8_tok"), ("qwen3-8b", "mxint4_blk"),
                                      ("ds3_dense", None), ("ds3_dense", "mxint4_blk"),
                                      ("falcon-mamba-7b", None), ("hymba-1.5b", None),
                                      ("hymba-1.5b", "mxint4_blk"), ("olmoe-1b-7b", None),
                                      ("olmoe-1b-7b", "mxint4_blk"), ("ds3_moe", None)])
def test_class_step_replays_match_its_eager_body(arch, fmt):
    """Reduced models on the card: a scheduler's class step (captured at pool
    build) replayed with its two lanes at different positions gives its
    eager body's tokens and store bit for bit, with the launches its capture
    recorded; then the scheduler drains."""
    from repro_torch.serving import engine as E
    from repro_torch.serving import Request, RequestScheduler
    from repro_torch.serving.engine import EngineSpec, InferenceEngine
    from repro_torch.serving.sampling import GenerationConfig
    eng = InferenceEngine.from_config(_reduced(arch), EngineSpec(), device="cuda")
    sched = RequestScheduler(eng, classes=[(2, 40)],
                             gen=GenerationConfig(max_new_tokens=6, cache_format=fmt),
                             chunk_size=8)
    step = sched.pool.steps[40]
    assert step.graph is not None and step.capture_s > 0
    assert int(step.store["pos"].abs().sum()) == 0            # put back cold
    for uid, s in enumerate((7, 19)):
        sched.submit(Request(uid=uid, prompt=list(range(1 + uid, 1 + uid + s))))
    while sched.stats["admitted"] < 2:
        sched.step()
    pos = step.store["pos"].tolist()
    assert pos[0] != pos[1]
    with torch.inference_mode():                  # the store is an inference tensor tree
        cold, tok0 = E._clone(step.store), step.tok.clone()
        hopper.reset_launches()
        step.run()
        replayed = dict(hopper.LAUNCHES)
        got, got_tok, got_fed = E._clone(step.store), step.tok.clone(), step.fed.clone()
        E._write_back(step.store, cold)
        step.tok.copy_(tok0)
        step.body()
    assert _tree_equal(step.store, got) and torch.equal(step.tok, got_tok)
    assert torch.equal(step.fed, got_fed) and torch.equal(got_fed, tok0)
    assert replayed == {k: step.launches.get(k, 0) for k in replayed}
    assert replayed["mxint4_matmul"] > 0
    res = sched.run()
    assert sorted(res) == [0, 1] and all(len(r.tokens) == 6 for r in res.values())


# -- the shared-prefix cache on the card -------------------------------------------


def _leaves(tree) -> list:
    from repro_torch.serving.engine import tree_items
    return [t for _, t in tree_items(tree)]


def _ptrs(tree) -> set:
    return {t.untyped_storage().data_ptr() for t in _leaves(tree)}


def _held(pc, n):
    """A page's rows (or a snapshot's cache), wherever it resides."""
    if pc.mode == "paged":
        return n.rows if n.rows is not None else n.host_rows
    return n.cache if n.cache is not None else n.host_cache


def _page_copies(pc) -> dict:
    """Every page (or snapshot) -> a copy of its tensors."""
    from repro_torch.serving.engine import _clone
    return {n: _clone(_held(pc, n)) for n in pc._index.nodes()}


def _unchanged(pc, copies: dict) -> bool:
    return all(_tree_equal(_held(pc, n), c) for n, c in copies.items())


def _registered_prefix(arch, fmt, **kw):
    """A reduced model on the card and a `PrefixCache` holding one 19-token
    prompt's chunked-prefill cache (in ``fmt``) as pages of 8."""
    from repro_torch.serving import PrefixCache
    from repro_torch.serving.engine import EngineSpec, InferenceEngine
    eng = InferenceEngine.from_config(_reduced(arch), EngineSpec(), device="cuda")
    p = list(range(3, 22))
    _, cache = eng.prefill_chunked(torch.tensor([p], device="cuda"), cache_len=32,
                                   chunk_size=8, cache_dtype=fmt or torch.float32)
    pc = PrefixCache(eng.cfg, fmt or torch.float32, enabled=True, page_size=8,
                     device="cuda", **kw)
    assert pc.register(p, cache, 32) == (3 if pc.mode == "paged" else 1)
    return p, cache, pc


@pytest.mark.parametrize("arch,fmt", [("qwen3-8b", None), ("qwen3-8b", "int8_tok"),
                                      ("ds3_dense", "mxint4_blk"), ("retnet-1.3b", None)])
def test_prefix_pages_are_clones_not_views(arch, fmt):
    """Page rows (and a snapshot) on CUDA tensors own their storage: none is
    a view of the prefill cache they were cut from, and overwriting that
    cache afterwards leaves them as they were."""
    _, cache, pc = _registered_prefix(arch, fmt)
    copies = _page_copies(pc)
    src = _ptrs(cache)
    for n in pc._index.nodes():
        assert all(t.is_cuda for t in _leaves(_held(pc, n)))
        assert not (_ptrs(_held(pc, n)) & src)
    with torch.inference_mode():
        for t in _leaves(cache["blocks"]):
            t.fill_(3)
    assert _unchanged(pc, copies)


@pytest.mark.parametrize("arch,fmt", [("qwen3-8b", None), ("qwen3-8b", "mxint4_blk"),
                                      ("retnet-1.3b", None)])
def test_spilled_pages_are_pinned_and_fetch_back_bit_exact(arch, fmt):
    p, _, pc = _registered_prefix(arch, fmt, device_pages=0)
    copies = _page_copies(pc)
    pc.maintain()
    assert pc.device_resident_pages == 0 and pc.stats["page_spills"] == pc.n_pages
    for n in pc._index.nodes():
        assert all(t.device.type == "cpu" and t.is_pinned() for t in _leaves(_held(pc, n)))
    hit, _ = pc.lookup(p + [5, 6], 32, slot=0)
    assert hit == len(p) and pc.stats["page_fetches"] == pc.n_pages
    assert all(t.is_cuda for n in pc._index.nodes() for t in _leaves(_held(pc, n)))
    assert _unchanged(pc, copies)


@pytest.mark.parametrize("arch,fmt", [("qwen3-8b", None), ("qwen3-8b", "int8_tok"),
                                      ("ds3_dense", None), ("retnet-1.3b", None)])
def test_adopted_lane_replays_leave_every_page_unchanged(arch, fmt):
    """Reduced models on the card: a scheduler registers a donor prompt, then
    admits two extensions by adopting the donor's pages (or snapshot) into a
    class store that is a captured graph's static buffer; after the drain's
    replays every page is bit for bit as registered, shares no storage with
    the store, no lease is held, and the tokens are those of the same
    requests without the prefix cache."""
    from repro_torch.serving import Request, RequestScheduler
    from repro_torch.serving.engine import EngineSpec, InferenceEngine
    from repro_torch.serving.sampling import GenerationConfig
    eng = InferenceEngine.from_config(_reduced(arch), EngineSpec(), device="cuda")
    donor = list(range(5, 37))
    reqs = [donor] + [donor + list(range(40 + 8 * i, 48 + 8 * i)) for i in range(2)]

    def drain(prefix_cache):
        sched = RequestScheduler(eng, classes=[(2, 56)],
                                 gen=GenerationConfig(max_new_tokens=6, cache_format=fmt),
                                 chunk_size=16, prefix_cache=prefix_cache)
        assert sched.pool.steps[56].graph is not None
        sched.submit(Request(uid=0, prompt=reqs[0]))
        sched.run()
        copies = _page_copies(sched.pool.prefix)
        for uid in (1, 2):
            sched.submit(Request(uid=uid, prompt=reqs[uid]))
        res = sched.run()
        return {u: f.tokens for u, f in res.items()}, sched, copies

    cold, _, _ = drain(False)
    warm, sched, copies = drain(True)
    pc = sched.pool.prefix
    assert warm == cold
    assert pc.stats["prefix_hits"] == 2 and pc.stats["prefix_hit_tokens"] == 64
    assert pc.leased_slots == 0 and all(n.refs == 0 for n in pc._index.nodes())
    assert sched.pool.steps[56].replays > 6 and copies
    assert _unchanged(pc, copies)
    store = _ptrs(sched.pool.get_store(56))
    assert all(not (_ptrs(_held(pc, n)) & store) for n in pc._index.nodes())


# -- the engine's captured decode step --------------------------------------------


def _eager_generate(eng, prompts, gen):
    """The decode loop as `decode_step` in a Python loop (no graph): tokens,
    lengths and the final cache."""
    from repro_torch.serving.sampling import sample
    logits, cache = eng.prefill(prompts, cache_len=prompts.shape[1] + gen.max_new_tokens)
    cache = eng._encode_cache(cache, gen)
    b, n = prompts.shape[0], gen.max_new_tokens
    out = torch.full((b, n), gen.pad_token_id, dtype=torch.long, device="cuda")
    lengths = torch.zeros(b, dtype=torch.int32, device="cuda")
    tok = sample(logits, gen.sampling)
    for i in range(n):
        out[:, i] = tok
        lengths += 1
        logits, cache = eng.decode_step(tok[:, None], cache)
        tok = sample(logits, gen.sampling)
    return out, lengths, cache


def _tree_equal(a, b) -> bool:
    import dataclasses
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return all(_tree_equal(x, y) for x, y in zip(a, b))
    return all(_tree_equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


@pytest.mark.parametrize("arch,fmt", [("retnet-1.3b", None), ("qwen3-8b", None),
                                      ("qwen3-8b", "int8_tok"), ("qwen3-8b", "mxint4_blk"),
                                      ("ds3_dense", None), ("ds3_dense", "mxint4_blk"),
                                      ("falcon-mamba-7b", None), ("hymba-1.5b", None),
                                      ("hymba-1.5b", "int8_tok"), ("hymba-1.5b", "mxint4_blk"),
                                      ("olmoe-1b-7b", None), ("olmoe-1b-7b", "int8_tok"),
                                      ("olmoe-1b-7b", "mxint4_blk"), ("ds3_moe", None),
                                      ("starcoder2-15b", None), ("starcoder2-15b", "int8_tok"),
                                      ("starcoder2-15b", "mxint4_blk")])
def test_generate_replays_match_the_eager_loop(arch, fmt):
    """Reduced models on the card: `generate` (one captured step, replayed)
    gives the eager loop's tokens, lengths and final cache bit for bit, a
    second generate does not capture again, and the launch counts are the
    replays'."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.serving.engine import EngineSpec, InferenceEngine
    from repro_torch.serving.sampling import GenerationConfig
    cfg = _reduced(arch)
    eng = InferenceEngine.from_config(cfg, EngineSpec(), device="cuda")
    s = 40 if cfg.sliding_window else 16          # hymba: past its window of 32
    prompts = torch.randint(1, cfg.vocab_size, (2, s), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(5))
    gen = GenerationConfig(max_new_tokens=10, cache_format=fmt)
    first = eng.generate(prompts, gen)
    assert first.capture_s > 0
    hopper.reset_launches()
    res = eng.generate(prompts, gen)
    assert res.capture_s == 0.0 and res.decode_steps == 10
    replayed = dict(hopper.LAUNCHES)
    out, lengths, cache = _eager_generate(eng, prompts, gen)
    assert torch.equal(res.tokens, out) and torch.equal(res.tokens, first.tokens)
    assert torch.equal(res.lengths, lengths)
    (sg,) = eng._graphs.values()
    assert _tree_equal(sg.state.cache, cache)
    for name in ("mxint4_matmul", "flash_decode", "flash_decode_mla", "mxint4_expert_matmul"):
        assert replayed[name] == 10 * sg.launches[name]      # decode launches only
    assert sg.launches["mxint4_matmul"] > 0
    assert sg.launches["mxint4_expert_matmul"] == 3 * _moe_layers(cfg)


@pytest.mark.parametrize("fmt", [None, "int8_tok", "mxint4_blk"])
def test_seamless_generate_replays_match_the_eager_loop(fmt):
    """Reduced seamless-m4t-medium on the card: `generate` with its frames
    (`extras`) replays one captured step that reads the cross caches at
    their capacity, and gives the eager loop's tokens, lengths and final
    cache, the cross leaves included, bit for bit; a replay launches 2
    flash-decodes a decoder layer."""
    from repro_torch import configs
    from repro_torch.models import frontends
    from repro_torch.serving.engine import EngineSpec, InferenceEngine
    from repro_torch.serving.sampling import GenerationConfig, sample
    cfg = configs.get_config("seamless-m4t-medium").reduced()
    eng = InferenceEngine.from_config(cfg, EngineSpec(), device="cuda")
    prompts = torch.randint(1, cfg.vocab_size, (2, 16), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(5))
    extras = {"src_embeds": frontends.synth_frame_embeds(cfg, 2, cfg.frontend_tokens, seed=6)}
    gen = GenerationConfig(max_new_tokens=10, cache_format=fmt)
    first = eng.generate(prompts, gen, extras=extras)
    assert first.capture_s > 0
    res = eng.generate(prompts, gen, extras=extras)
    assert res.capture_s == 0.0 and torch.equal(res.tokens, first.tokens)
    logits, cache = eng.prefill(prompts, cache_len=26, extras=extras)
    cache = eng._encode_cache(cache, gen)
    tok, out = sample(logits, gen.sampling), []
    for _ in range(10):
        out.append(tok)
        logits, cache = eng.decode_step(tok[:, None], cache)
        tok = sample(logits, gen.sampling)
    assert torch.equal(res.tokens, torch.stack(out, dim=1))
    (sg,) = eng._graphs.values()
    assert _tree_equal(sg.state.cache, cache)
    assert sg.launches["flash_decode"] == 2 * cfg.n_layers
    assert sg.launches["mxint4_matmul"] == 8 * cfg.n_layers + 1


def test_sampled_generate_replays_draw_fresh_numbers_and_repeat_with_the_seed():
    from repro_torch.serving.engine import EngineSpec, InferenceEngine
    from repro_torch.serving.sampling import GenerationConfig, SamplingParams
    eng = InferenceEngine.from_config("qwen3-8b", EngineSpec(reduced=True), device="cuda")
    prompts = torch.randint(1, 512, (2, 16), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(6))
    gen = GenerationConfig(max_new_tokens=12, sampling=SamplingParams(temperature=1.0,
                                                                       top_k=8))
    logits, _ = eng.prefill(prompts)
    runs = [eng.generate(prompts, gen, generator=torch.Generator(device="cuda").manual_seed(9))
            for _ in range(2)]
    assert torch.equal(runs[0].tokens, runs[1].tokens)
    assert runs[1].capture_s == 0.0
    other = eng.generate(prompts, gen, generator=torch.Generator(device="cuda").manual_seed(10))
    assert not torch.equal(other.tokens, runs[0].tokens)
    allowed = torch.topk(logits, 8, dim=-1).indices
    assert all(int(t) in allowed[i].tolist() for i, t in enumerate(runs[0].tokens[:, 0]))


def _reduced(arch):
    """A reduced config: ``ds3_dense`` is deepseek-v3 cut to its dense head,
    ``ds3_moe`` deepseek-v3 with its MoE layers (3 dense, 2 MoE)."""
    import dataclasses

    from repro_torch import configs
    if arch == "ds3_dense":
        cfg = configs.get_config("deepseek-v3-671b").reduced()
        return dataclasses.replace(cfg, n_layers=cfg.first_dense_layers)
    if arch == "ds3_moe":
        return configs.get_config("deepseek-v3-671b").reduced()
    return configs.get_config(arch).reduced()


@pytest.mark.parametrize("arch,fmt", [("retnet-1.3b", None), ("qwen3-8b", None),
                                      ("qwen3-8b", "int8_tok"), ("qwen3-8b", "mxint4_blk"),
                                      ("ds3_dense", None), ("ds3_dense", "int8_tok"),
                                      ("falcon-mamba-7b", None), ("hymba-1.5b", "int8_tok"),
                                      ("olmoe-1b-7b", None), ("ds3_moe", "int8_tok")])
def test_resume_after_chunked_prefill_replays_match_the_eager_loop(arch, fmt):
    """Reduced models on the card: a chunked admission (23 = 4 x 5 + 2 + 1,
    into a cache in ``fmt``), then `resume_generate` through the graph keyed
    on the cache's layout, against `decode_step` in a Python loop from the
    same cache: tokens, the next pending token and the final cache (read
    from the caller's) bit for bit; a monolithic prefill's cache of the same
    layout replays the same graph."""
    from repro_torch.serving import engine as E
    from repro_torch.serving.engine import EngineSpec, InferenceEngine
    from repro_torch.serving.sampling import GenerationConfig
    eng = InferenceEngine.from_config(_reduced(arch), EngineSpec(), device="cuda")
    prompts = torch.randint(1, 512, (2, 23), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(7))
    gen = GenerationConfig(max_new_tokens=8, cache_format=fmt)
    hopper.reset_launches()
    logits, cache = eng.prefill_chunked(prompts, cache_len=31, chunk_size=4,
                                        cache_dtype=fmt or torch.float32)
    assert hopper.LAUNCHES["w8a8_matmul"] > 0
    if arch == "retnet-1.3b":
        assert hopper.LAUNCHES["retention_chunkwise"] == 7 * eng.cfg.n_layers
    eager_cache = E._clone(cache)
    res = eng.resume_generate(logits.argmax(-1), cache, gen)
    assert res.capture_s > 0 and res.decode_steps == 8 and res.prefill_s == 0.0
    tok = logits.argmax(-1)
    out = []
    for _ in range(8):
        out.append(tok)
        lg, eager_cache = eng.decode_step(tok[:, None], eager_cache)
        tok = lg.argmax(-1)
    assert torch.equal(res.tokens, torch.stack(out, dim=1))
    assert torch.equal(res.next_token, tok)
    assert _tree_equal(cache, eager_cache)
    lm_, mono = eng.prefill(prompts, cache_len=31)
    again = eng.resume_generate(lm_.argmax(-1), eng._encode_cache(mono, gen), gen)
    assert again.capture_s == 0.0 and len(eng._graphs) == 1


def test_top_p_generate_through_the_graph_stays_in_the_nucleus():
    from repro_torch.serving.engine import EngineSpec, InferenceEngine
    from repro_torch.serving.sampling import GenerationConfig, SamplingParams, _top_p_mask
    eng = InferenceEngine.from_config("retnet-1.3b", EngineSpec(reduced=True), device="cuda")
    prompts = torch.randint(1, 512, (2, 16), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(8))
    gen = GenerationConfig(max_new_tokens=10, sampling=SamplingParams(temperature=1.0,
                                                                       top_p=0.5))
    runs = [eng.generate(prompts, gen, generator=torch.Generator(device="cuda").manual_seed(3))
            for _ in range(2)]
    assert torch.equal(runs[0].tokens, runs[1].tokens) and runs[1].capture_s == 0.0
    logits, cache = eng.prefill(prompts, cache_len=26)
    for i in range(10):
        kept = torch.isfinite(_top_p_mask(logits.float(), 0.5))
        assert bool(kept.gather(1, runs[0].tokens[:, i:i + 1]).all())
        logits, cache = eng.decode_step(runs[0].tokens[:, i:i + 1], cache)


@pytest.mark.parametrize("arch", ["retnet-1.3b", "qwen3-8b", "ds3_dense", "olmoe-1b-7b",
                                  "falcon-mamba-7b",
                                  "hymba-1.5b"])
def test_resume_twice_on_the_card_equals_one_resume(arch):
    """`resume_generate` of 4 tokens, then of 4 more from the cache it left
    and its ``next_token``, against one resume of 8 from the same cache:
    tokens and final caches bit for bit (each resume's graph copies its
    final cache back into the caller's)."""
    from repro_torch.serving import engine as E
    from repro_torch.serving.engine import EngineSpec, InferenceEngine
    from repro_torch.serving.sampling import GenerationConfig
    eng = InferenceEngine.from_config(_reduced(arch), EngineSpec(), device="cuda")
    prompts = torch.randint(1, 512, (2, 23), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(9))
    logits, cache = eng.prefill_chunked(prompts, cache_len=31, chunk_size=4)
    halves = E._clone(cache)
    whole = eng.resume_generate(logits.argmax(-1), cache, GenerationConfig(max_new_tokens=8))
    half = GenerationConfig(max_new_tokens=4)
    first = eng.resume_generate(logits.argmax(-1), halves, half)
    second = eng.resume_generate(first.next_token, halves, half)
    assert torch.equal(torch.cat([first.tokens, second.tokens], dim=1), whole.tokens)
    assert torch.equal(second.next_token, whole.next_token)
    assert int(halves["pos"]) == 31
    assert _tree_equal(halves, cache)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("s", [130, 500])
def test_retention_apply_runs_every_length_through_the_kernel(s, warm):
    """Reduced retnet-1.3b's retention at lengths that are not whole
    128-chunks, from a zero or a warm state: two launches (the whole chunks,
    then the tail from the carried state), against the plain path on the
    same weights and inputs."""
    from repro_torch.models import retnet as R
    from repro_torch.serving.engine import EngineSpec, InferenceEngine
    eng = InferenceEngine.from_config(_reduced("retnet-1.3b"), EngineSpec(), device="cuda")
    plain = InferenceEngine(eng.cfg, eng.model, EngineSpec(kernel_impl="ref"))
    cfg, p = eng.cfg, eng.model.blocks[0].ret
    rng = _gen(s + warm)
    d, h = cfg.d_model, cfg.n_heads
    x = _t(rng.normal(size=(2, s, d)).astype(np.float32))
    sig = _t((rng.random((2, s)) + 0.5).astype(np.float32))
    cache = ({"s": _t((rng.normal(size=(2, h, d // h, 2 * d // h)) * 0.1)
                      .astype(np.float32))} if warm else None)
    hopper.reset_launches()
    out, st = R.retention_apply(p, x, sig, eng.hsa, "prefill", cfg, cache=cache)
    assert hopper.LAUNCHES["retention_chunkwise"] == 2
    out_r, st_r = R.retention_apply(p, x, sig, plain.hsa, "prefill", cfg, cache=cache)
    # The state at f32 summation order; the output also passes W8A8's
    # dynamic int8 rounding of y on its way through wo (one step, 2e-2).
    for got, want, tol in ((st["s"], st_r["s"], 1e-4), (out, out_r, 2e-2)):
        err = ((got - want).abs().max() / want.abs().max()).item()
        assert err < tol, err


# -- speculative decode on the card --------------------------------------------------


def _moe_layers(cfg) -> int:
    return cfg.n_layers - cfg.first_dense_layers if cfg.family == "moe" else 0


def _w8a8_launches(cfg) -> int:
    """W8A8 launches of one verify step on a reduced model: every linear of
    every layer (MLA's wk_b / wv_b re-expansion included; a MoE layer's
    router and shared expert, its routed experts going through their GEMV)
    and the LM head; a LayerNorm model's MLP is ungated, two linears."""
    attn = 7 if cfg.family == "retnet" else 6 if cfg.attn_type == "mla" else 4
    mlp = 2 if cfg.norm_type == "layernorm" else 3
    per_layer = (7 if cfg.family == "retnet" else 4 if cfg.family == "ssm" else
                 11 if cfg.family == "hybrid" else attn + mlp)
    moe = _moe_layers(cfg)
    per_moe = attn + 1 + (3 if cfg.n_shared_experts else 0)
    return per_layer * (cfg.n_layers - moe) + per_moe * moe + 1


@pytest.mark.parametrize("arch,fmt", [("retnet-1.3b", None), ("qwen3-8b", None),
                                      ("qwen3-8b", "int8_tok"), ("ds3_dense", None),
                                      ("ds3_dense", "mxint4_blk"), ("falcon-mamba-7b", None),
                                      ("hymba-1.5b", None), ("hymba-1.5b", "mxint4_blk"),
                                      ("olmoe-1b-7b", None), ("olmoe-1b-7b", "int8_tok"),
                                      ("ds3_moe", None), ("starcoder2-15b", None)])
def test_speculative_generate_replays_match_the_eager_step(arch, fmt):
    """Reduced models on the card, default deployment: `generate` with
    speculative decode (each verify step one replay of a captured graph, W8A8
    inside it) against the same loop with the eager step from the same
    prefill: tokens, lengths, verify steps, accepted drafts, history and
    final cache bit for bit; a replay launches W8A8 once per linear and the
    LM head (and the routed experts' GEMV three times a MoE layer, as the
    verify dispatch never dequantizes a whole stack), and a second generate
    does not capture again."""
    from repro_torch.serving.engine import EngineSpec, InferenceEngine
    from repro_torch.serving.sampling import GenerationConfig, SpeculativeConfig, sample
    cfg = _reduced(arch)
    eng = InferenceEngine.from_config(cfg, EngineSpec(), device="cuda")
    periodic = torch.tensor([5, 9, 13] * 6, device="cuda")
    prompts = torch.stack([periodic, torch.randint(1, cfg.vocab_size, (18,), device="cuda",
                                                   generator=torch.Generator(
                                                       device="cuda").manual_seed(6))])
    n, k, s = 12, 3, prompts.shape[1]
    gen = GenerationConfig(max_new_tokens=n, cache_format=fmt,
                           speculative=SpeculativeConfig(k=k))
    first = eng.generate(prompts, gen)
    assert first.capture_s > 0
    hopper.reset_launches()
    res = eng.generate(prompts, gen)
    replayed = dict(hopper.LAUNCHES)
    assert res.capture_s == 0.0 and torch.equal(res.tokens, first.tokens)
    (sg,) = eng._graphs.values()
    assert sg.launches == {**dict.fromkeys(hopper.COUNTERS, 0),
                           "w8a8_matmul": _w8a8_launches(eng.cfg),
                           "mxint4_expert_matmul": 3 * _moe_layers(eng.cfg)}
    # The prefill runs the same linears once more, at M = B x S.
    assert replayed["w8a8_matmul"] == (res.verify_steps + 1) * sg.launches["w8a8_matmul"]
    with torch.inference_mode():
        logits, cache, hist, hidden = eng._spec_prefill(prompts, gen)
        st, _ = eng._spec_loop(sample(logits, gen.sampling), cache, hist, s, hidden, gen, None,
                               graph=False)
    g = sg.state
    assert torch.equal(res.tokens, st.out[:, :n]) and torch.equal(res.lengths, st.lengths)
    assert (res.verify_steps, res.accepted_drafts) == (int(st.steps), int(st.accepted))
    for f in ("out", "hist", "hist_len", "i"):
        assert torch.equal(getattr(g, f), getattr(st, f)), f
    assert _tree_equal(g.cache, st.cache)


@pytest.mark.parametrize("arch", ["ds3_dense", "ds3_moe"])
def test_mtp_speculative_generate_replays_match_the_eager_step(arch):
    """Reduced deepseek-v3 with its MTP head (the 3-layer cut, and with its
    MoE layers), default deployment: speculative `generate` with the MTP
    drafter, each verify step one replay (the block's W8A8 and k chained
    head steps), against the eager step from the same prefill: tokens,
    lengths, verify steps, accepted drafts, the drafter's ``h`` and the
    final cache bit for bit.  A replay launches the verify's W8A8 and, k
    times, a head step's: MXINT4 for every head linear with an MXINT4 copy
    and the LM head, W8A8 for the others (the router, N 4, and ``wkv_a``,
    N 48, at these widths), the expert GEMV three times.  One head step on
    the card against the plain path within 1e-3 of max|value|."""
    from repro_torch.models import lm
    from repro_torch.models.modules import Linear
    from repro_torch.serving.engine import EngineSpec, InferenceEngine
    from repro_torch.serving.sampling import GenerationConfig, SpeculativeConfig, sample
    cfg = _reduced(arch)
    eng = InferenceEngine.from_config(cfg, EngineSpec(), device="cuda")
    assert cfg.mtp and eng.model.mtp is not None
    prompts = torch.randint(1, cfg.vocab_size, (2, 18), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(12))
    n, k, s = 10, 3, prompts.shape[1]
    gen = GenerationConfig(max_new_tokens=n,
                           speculative=SpeculativeConfig(k=k, drafter="mtp"))
    first = eng.generate(prompts, gen)
    hopper.reset_launches()
    res = eng.generate(prompts, gen)
    assert first.capture_s > 0 and res.capture_s == 0.0
    assert torch.equal(res.tokens, first.tokens)
    replayed = dict(hopper.LAUNCHES)
    head = [m for m in eng.model.mtp.modules() if isinstance(m, Linear)]
    mx_head = sum(m.mx_packed is not None for m in head) + 1          # and the LM head
    (sg,) = eng._graphs.values()
    assert sg.launches == {**dict.fromkeys(hopper.COUNTERS, 0),
                           "w8a8_matmul": _w8a8_launches(cfg) + k * (len(head) + 1 - mx_head),
                           "mxint4_matmul": k * mx_head,
                           "mxint4_expert_matmul": 3 * (_moe_layers(cfg) + k)}
    for name, c in sg.launches.items():
        prefill = _w8a8_launches(cfg) if name == "w8a8_matmul" else 0
        assert replayed[name] == prefill + res.verify_steps * c, name
    with torch.inference_mode():
        logits, cache, hist, hidden = eng._spec_prefill(prompts, gen)
        tok = sample(logits, gen.sampling)
        st, _ = eng._spec_loop(tok, cache, hist, s, hidden, gen, None, graph=False)
        plain = InferenceEngine(cfg, eng.model, EngineSpec(kernel_impl="ref"))
        got = lm.mtp_decode_step(eng.model, hidden, tok, cfg, eng.hsa)
        want = lm.mtp_decode_step(eng.model, hidden, tok, cfg, plain.hsa)
    g = sg.state
    assert torch.equal(res.tokens, st.out[:, :n]) and torch.equal(res.lengths, st.lengths)
    assert (res.verify_steps, res.accepted_drafts) == (int(st.steps), int(st.accepted))
    for f in ("out", "h", "hist", "i"):
        assert torch.equal(getattr(g, f), getattr(st, f)), f
    assert _tree_equal(g.cache, st.cache)
    for a, b in zip(got, want):
        assert ((a - b).abs().max() / b.abs().max()).item() < 1e-3


@pytest.mark.parametrize("arch,fmt", [("retnet-1.3b", None), ("qwen3-8b", "int8_tok"),
                                      ("ds3_dense", None), ("falcon-mamba-7b", None),
                                      ("hymba-1.5b", "int8_tok"), ("olmoe-1b-7b", None),
                                      ("ds3_moe", "int8_tok")])
def test_spec_class_step_replays_match_its_eager_body(arch, fmt):
    """A speculative scheduler's class step (captured at pool build, per-lane
    W8A8 scales) replayed with its two lanes at different positions gives its
    eager body's blocks, counts, tokens, histories and store bit for bit;
    then the scheduler drains."""
    from repro_torch.serving import engine as E
    from repro_torch.serving import Request, RequestScheduler
    from repro_torch.serving.engine import EngineSpec, InferenceEngine
    from repro_torch.serving.sampling import GenerationConfig, SpeculativeConfig
    eng = InferenceEngine.from_config(_reduced(arch), EngineSpec(), device="cuda")
    sched = RequestScheduler(eng, classes=[(2, 44)], chunk_size=8,
                             gen=GenerationConfig(max_new_tokens=6, cache_format=fmt,
                                                  speculative=SpeculativeConfig(k=3)))
    step = sched.pool.steps[44]
    assert step.graph is not None and step.launches["w8a8_matmul"] == _w8a8_launches(eng.cfg)
    for uid, p in enumerate(([5, 9, 13] * 3, list(range(2, 21)))):
        sched.submit(Request(uid=uid, prompt=p))
    while sched.stats["admitted"] < 2:
        sched.step()
    assert step.store["pos"][0] != step.store["pos"][1]
    with torch.inference_mode():
        bufs = (step.tok, step.hist, step.hist_len, step.result)
        cold, before = E._clone(step.store), [t.clone() for t in bufs]
        step.run()
        got, got_bufs = E._clone(step.store), [t.clone() for t in bufs]
        E._write_back(step.store, cold)
        for t, b in zip(bufs, before):
            t.copy_(b)
        step.body()
    assert _tree_equal(step.store, got)
    assert all(torch.equal(a, b) for a, b in zip(bufs, got_bufs))
    res = sched.run()
    assert sorted(res) == [0, 1] and all(len(r.tokens) == 6 for r in res.values())


def test_w8a8_in_a_graph_matches_an_eager_launch_at_m10():
    """The verify shape (M = 2 x 5): a captured W8A8 launch replayed on new
    inputs equals an eager launch, bit for bit."""
    rng = _gen(10)
    k, n = 256, 384
    w = deploy.k_major(_t(rng.integers(-127, 128, (k, n)).astype(np.int8)))
    x = _t(rng.integers(-127, 128, (10, k)).astype(np.int8))
    os_, rs, b = (_t(rng.normal(size=(size,)).astype(np.float32)) for size in (n, 10, n))
    ops.w8a8_matmul(x, w, os_, rs, b, impl="kernel")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with hopper.captured_launches() as recorded, torch.cuda.graph(graph):
        out = ops.w8a8_matmul(x, w, os_, rs, b, impl="kernel")
    assert recorded["w8a8_matmul"] == 1
    for seed in (11, 12):
        x.copy_(_t(_gen(seed).integers(-127, 128, (10, k)).astype(np.int8)))
        graph.replay()
        eager = ops.w8a8_matmul(x, w, os_, rs, b, impl="kernel")
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert torch.equal(eager, ref.w8a8_matmul_ref(x, w, os_, rs, b))


def test_per_lane_activation_scale_matches_lane_by_lane_launches():
    """Each lane's rows quantized with its own absmax (`quantize_act_int8_lanes`)
    give that lane's int32 accumulations of a lane-by-lane launch, and the
    lane's scale folded into ``row_scale`` gives the lane-alone epilogue."""
    from repro_torch.core import quantized_linear as ql
    rng = _gen(13)
    k, n = 512, 256
    x = _t(rng.normal(size=(2, 5, k)).astype(np.float32))
    x[1] *= 40.0                                 # a co-tenant with a larger absmax
    w = mx.quantize_int8_tensor(_t((rng.normal(size=(k, n)) * 0.05).astype(np.float32)))
    w8 = mx.Int8Weight(deploy.k_major(w.values), w.scale)
    xq, scale = mx.quantize_act_int8_lanes(x)
    ones_n, ones_m = torch.ones(n, device="cuda"), torch.ones(10, device="cuda")
    acc = ops.w8a8_matmul(xq, w8.values, ones_n, ones_m[:10], impl="kernel")
    sig = _t(rng.uniform(0.5, 1.5, (2, 5)).astype(np.float32))
    params = ql.QuantizedLinearParams(w=None, w8=w8, mx=None, bias=None)
    lane_out = ql.apply(params, x, "prefill", row_scale=sig, impl="kernel", lane_act=True)
    for b in range(2):
        xb, sb = mx.quantize_act_int8(x[b])
        assert torch.equal(xb, xq[b]) and torch.equal(sb, scale[b])
        alone = ops.w8a8_matmul(xb, w8.values, ones_n, ones_m[:5], impl="kernel")
        assert torch.equal(acc[b], alone)
        want = ref.w8a8_matmul_ref(xb, w8.values, w8.scale, scale[b] * sig[b])
        assert torch.equal(lane_out[b], want)


@pytest.mark.parametrize("collect", [False, True], ids=["chunked", "snapshots"])
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_mamba_apply_on_the_card_matches_the_cpu(arch, collect):
    """The selective scan (plain PyTorch: no kernel) on the card against the
    CPU on the same fp weights and inputs, 1e-4 of max|value|: 37 tokens in
    chunks of 16, or one pass with the state after every token."""
    import copy

    from repro_torch.models import ssm as S
    from repro_torch.serving.engine import EngineSpec, InferenceEngine
    cpu = InferenceEngine.from_config(_reduced(arch), EngineSpec(quantize=False), device="cpu")
    card = InferenceEngine.from_config(cpu.cfg, EngineSpec(quantize=False),
                                       model=copy.deepcopy(cpu.model).to("cuda"),
                                       device="cuda")
    rng = _gen(3)
    x = rng.normal(size=(2, 37, cpu.cfg.d_model)).astype(np.float32)
    sig = (rng.random((2, 37)) + 0.5).astype(np.float32)
    got_y, got_c = S.mamba_apply(card.model.blocks[0].mamba, _t(x), _t(sig), card.hsa,
                                 "prefill", card.cfg, collect_states=collect)
    want_y, want_c = S.mamba_apply(cpu.model.blocks[0].mamba, torch.from_numpy(x),
                                   torch.from_numpy(sig), cpu.hsa, "prefill", cpu.cfg,
                                   collect_states=collect)
    for got, want in [(got_y, want_y)] + [(got_c[n], want_c[n]) for n in want_c]:
        err = ((got.cpu() - want).abs().max() / want.abs().max()).item()
        assert err < 1e-4, err
