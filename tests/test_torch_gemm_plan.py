"""The GEMM kernels' planners, the K-major INT8 weight layout and the build
hash: the parts of the W8A8 and MXINT4 launches that plain Python decides,
so they are tested here on the CPU (the kernels themselves run only on the
card, tests/test_torch_cuda.py).

The layout tests carry a reduced retnet-1.3b through the reference's deploy
and the bridge: the port holds every ``w8_vals`` K-major with the
reference's values byte for byte.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import deploy as Jdeploy
from repro.models import lm as Jlm
from repro_torch import bridge
from repro_torch.kernels import hopper, ops
from repro_torch.models import deploy as Tdeploy

SMS = 132   # the H100 SXM's SMs
# (M, K, N) of every W8A8 launch on the retnet-1.3b and qwen3-8b prefill
# paths (B = 2 x 512 tokens; the lm_head runs on the last token of each).
W8A8_MAIN = ([(1024, k, n) for k, n in ((2048, 2048), (2048, 4096), (4096, 2048),
                                          (4096, 4096), (4096, 1024), (4096, 12288),
                                          (12288, 4096))]
             + [(2, 2048, 32768), (2, 4096, 152064)])
# and of every MXINT4 launch of their decode steps (M = 2 sequences).
MXINT4_MAIN = [(2, k, n) for _, k, n in W8A8_MAIN]
EDGES = [(1, 32, 32), (17, 48, 208), (64, 4096, 4096), (65, 4096, 4096),
         (1000, 48, 4096), (130, 48, 208), (9, 1000, 224), (3, 32, 32)]


@pytest.mark.parametrize("m,k,n", W8A8_MAIN + EDGES)
def test_w8a8_plan_covers_the_shape(m, k, n):
    p = hopper.w8a8_plan(m, n, SMS)
    bm, bn, stages = hopper.W8A8_TILES[p["cfg"]]
    assert (p["bm"], p["bn"], p["stages"]) == (bm, bn, stages)
    assert p["cfg"] in hopper.W8A8_ORDER[m <= hopper.W8A8_SMALL_M]
    # Tiles cover M and N exactly once: no tile lies wholly outside.
    assert p["blocks"] == -(-m // bm) * -(-n // bn)
    assert (-(-m // bm) - 1) * bm < m and (-(-n // bn) - 1) * bn < n
    # A ring of at least 4 stages of BK = 128 fits the block's shared memory.
    assert stages >= 4 and stages * (bm + bn) * hopper.W8A8_BK <= 227 * 1024 - 2048


# One wave of 128 large tiles (4 of the 132 SMs idle) measured faster than
# 256 smaller tiles or K splits at these shapes (PERF.md), so "every SM"
# means at least 90 % of them, for both kernels.
@pytest.mark.parametrize("m,k,n", W8A8_MAIN)
def test_w8a8_plan_gives_every_sm_work_on_the_main_paths(m, k, n):
    assert hopper.w8a8_plan(m, n, SMS)["blocks"] >= 0.9 * SMS


@pytest.mark.parametrize("m,k,n", MXINT4_MAIN + EDGES)
def test_mxint4_plan_covers_the_shape(m, k, n):
    p = hopper.mxint4_plan(m, n, k, SMS)
    tm = p["tm"]
    assert tm in hopper.MXINT4_TILES and p["c"] == hopper.MXINT4_TILES[tm]
    # The row tile is the smallest that holds a decode batch: no padding row.
    assert tm == min(t for t in hopper.MXINT4_TILES if t >= min(m, 8))
    assert p["tiles"] == -(-n // hopper.MXINT4_TILE_N) * -(-m // tm)
    # Splits cover K exactly and cut it at whole batches of the pipeline.
    assert p["k_per"] % hopper.MXINT4_ROWS == 0
    assert (p["splits"] - 1) * p["k_per"] < k <= p["splits"] * p["k_per"]
    if p["splits"] > 1:
        assert p["k_per"] * hopper.MXINT4_TILE_N // 2 >= hopper.MXINT4_MIN_BLOCK_BYTES


@pytest.mark.parametrize("m,k,n", MXINT4_MAIN)
def test_mxint4_plan_gives_every_sm_work_on_the_main_paths(m, k, n):
    assert hopper.mxint4_plan(m, n, k, SMS)["blocks"] >= 0.9 * SMS


def test_w8_layout_check_rejects_all_but_k_major():
    w = torch.randint(-127, 128, (64, 48), dtype=torch.int8)
    with pytest.raises(ValueError, match="K-major"):
        hopper.check_w8_layout(w)                        # row-major [K, N]
    with pytest.raises(ValueError, match="K-major"):
        hopper.check_w8_layout(w.reshape(-1))
    km = Tdeploy.k_major(w)
    hopper.check_w8_layout(km)
    assert km.t().is_contiguous() and torch.equal(km, w)
    odd = torch.zeros(48 * 64 + 1, dtype=torch.int8)[1:].view(48, 64).t()
    with pytest.raises(ValueError, match="aligned"):
        hopper.check_w8_layout(odd)


def test_w8a8_plain_version_takes_the_k_major_weight():
    rng = np.random.default_rng(0)
    xq = torch.from_numpy(rng.integers(-127, 128, (5, 64)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (64, 32)).astype(np.int8))
    want = ops.w8a8_matmul(xq, w, 0.01, impl="ref")
    assert torch.equal(ops.w8a8_matmul(xq, Tdeploy.k_major(w), 0.01, impl="ref"), want)


def test_build_hash_follows_included_headers_and_link_flags(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "k.cuh"\nint f();\n')
    (tmp_path / "k.cuh").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    assert [p.name for p in hopper.sources("k", tmp_path)] == ["k.cu", "k.cuh",
                                                                "common.cuh"]
    first = hopper._lib_path("k", tmp_path)
    assert first == hopper._lib_path("k", tmp_path)
    (tmp_path / "common.cuh").write_text("// v2\n")
    edited = hopper._lib_path("k", tmp_path)
    assert edited != first
    monkeypatch.setitem(hopper.LINK_FLAGS, "k", ("-lcuda",))
    assert hopper._lib_path("k", tmp_path) != edited


def test_w8a8_kernel_links_libcuda():
    assert "-lcuda" in hopper.LINK_FLAGS["w8a8_matmul"]


@pytest.fixture(scope="module")
def reduced_trees():
    cfg = get_config("retnet-1.3b").reduced()
    params, _, paths = Jlm.init(cfg, jax.random.key(0))
    deployed = Jdeploy.deploy_quantize(params, paths)
    as_np = lambda t: jax.tree.map(np.asarray, jax.device_get(t))   # noqa: E731
    return cfg, as_np(params), as_np(deployed)


def _w8_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _w8_leaves(v, f"{prefix}.{k}" if prefix else k)
    elif prefix.endswith("w8_vals"):
        yield prefix, tree


def _port_w8(model):
    return {name.replace(".", "/"): buf for name, buf in model.named_buffers()
            if name.endswith("w8_vals")}


@pytest.mark.parametrize("route", ["bridge", "deploy"])
def test_deployed_int8_weights_are_k_major_with_the_reference_bytes(reduced_trees,
                                                                    route):
    """Through the bridge (the reference's deployed tree) and through the
    port's own deploy pass (the reference's master tree), every ``w8_vals``
    is the reference's ``[K, N]`` array, byte for byte, held K-major."""
    cfg, master, deployed = reduced_trees
    if route == "bridge":
        model = bridge.model_from_tree(cfg, deployed)
    else:
        model = Tdeploy.deploy_quantize(bridge.model_from_tree(cfg, master))
    got = _port_w8(model)
    ref = dict(_w8_leaves(deployed))
    assert len(got) == sum(a.shape[0] if a.ndim == 3 else 1 for a in ref.values())
    for name, w in got.items():
        assert w.t().is_contiguous(), name
    # Per-layer buffers carry the reference's stacked [L, K, N] leaves.
    head = ref["lm_head.w8_vals"]
    assert np.array_equal(model.lm_head.w8_vals.numpy(), head)
    for i, blk in enumerate(model.blocks):
        for k, n in (("ret", "wq"), ("ret", "wo"), ("mlp", "wi"), ("mlp", "wo")):
            want = ref[f"blocks.{k}.{n}.w8_vals"][i]
            got_w = getattr(getattr(blk, k), n).w8_vals
            assert np.array_equal(got_w.numpy(), want), (i, k, n)
