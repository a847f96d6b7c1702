"""The routed-MoE expert GEMV's planner and workspace: the parts of a launch
that plain Python decides, tested here on the CPU (the kernel itself runs
only on the card, tests/test_torch_cuda.py)."""

import inspect

import pytest
import torch

from repro_torch.kernels import hopper

# (K, N) of olmoe-1b-7b's experts (wg / wi 2048 -> 1024, wo 1024 -> 2048)
# and of deepseek-v3's MTP head step (7168 -> 2048, 2048 -> 7168).
MAIN = [(2048, 1024), (1024, 2048), (7168, 2048), (2048, 7168)]
# Every (K, N) of the card tests' EXPERT_SHAPES: ragged K, N not a
# multiple of the 512-column tile, one batch.
CARD = MAIN + [(128, 64), (64, 128), (100, 96), (32, 32)]
STEP = hopper.MXINT4_EXPERT_STEP


@pytest.mark.parametrize("k,n", CARD)
def test_plan_covers_k_in_whole_batches(k, n):
    plan = hopper.mxint4_expert_plan(k, n)
    assert plan["k_per"] % STEP == 0 and plan["k_per"] > 0
    # Every K row in exactly one run, and no run empty.
    assert (plan["splits"] - 1) * plan["k_per"] < k <= plan["splits"] * plan["k_per"]
    assert plan["tiles"] * hopper.MXINT4_EXPERT_TILE_N >= n
    assert (plan["tiles"] - 1) * hopper.MXINT4_EXPERT_TILE_N < n
    assert plan["blocks_per_expert"] == plan["tiles"] * plan["splits"]


@pytest.mark.parametrize("k,n", CARD)
def test_plan_is_the_same_for_every_row_count(k, n):
    """Nothing of the launch's rows or routing reaches the plan, so a row's
    order of summation (the split, and the tile it runs in) is the same in
    every launch: the plan takes (K, N) and the card alone, and the rows
    change only the outer dimension of the buffers."""
    assert list(inspect.signature(hopper.mxint4_expert_plan).parameters) == ["k", "n", "sms"]
    plan = hopper.mxint4_expert_plan(k, n)
    for a in (1, 3, 16, 80, 1000):
        assert hopper.mxint4_expert_plan(k, n) is plan
        out, partials = hopper.mxint4_expert_buffers(plan, a, n, "cpu")
        assert out.shape == (a, n)
        assert partials is out or partials.shape == (plan["splits"], a, n)


@pytest.mark.parametrize("k,n", MAIN)
def test_plan_fills_one_wave_at_the_main_shapes(k, n):
    """The items of a B 2, top-8 decode step's experts (16 at most; 14 at
    olmoe's decode shape in chip_smoke.py) give every one of an H100's 132
    SMs a block and fit in one wave of persistent blocks, so each block
    takes one item; and the launch's blocks are capped at that wave."""
    plan = hopper.mxint4_expert_plan(k, n, 132)
    wave = hopper.MXINT4_EXPERT_BLOCKS_PER_SM * 132
    assert plan["blocks_per_expert"] * 14 >= 132
    assert plan["blocks_per_expert"] * hopper.MXINT4_EXPERT_EXPERTS <= wave
    assert hopper.mxint4_expert_blocks(plan, 16, 64, 132) == min(16 * plan["blocks_per_expert"], wave)
    assert hopper.mxint4_expert_blocks(plan, 80, 64, 132) == wave
    assert hopper.mxint4_expert_blocks(plan, 1, 64, 132) == plan["blocks_per_expert"]


def test_plan_at_the_main_shapes():
    plans = {kn: hopper.mxint4_expert_plan(*kn) for kn in MAIN}
    assert plans[(2048, 1024)] == dict(tiles=2, splits=8, k_per=256, blocks_per_expert=16)
    assert plans[(1024, 2048)] == dict(tiles=4, splits=4, k_per=256, blocks_per_expert=16)
    assert plans[(7168, 2048)] == dict(tiles=4, splits=4, k_per=1792, blocks_per_expert=16)
    assert plans[(2048, 7168)] == dict(tiles=14, splits=1, k_per=2048, blocks_per_expert=14)


@pytest.mark.parametrize("k,n", CARD)
@pytest.mark.parametrize("a", [1, 16, 80])
def test_workspace_is_what_the_wrapper_allocates(k, n, a):
    """The wrapper's buffers: ``out`` [A, N] and, when K is split, one
    partial sum per split, row and column; unsplit, the kernel writes
    ``out`` directly and the workspace is ``out`` itself."""
    plan = hopper.mxint4_expert_plan(k, n)
    out, partials = hopper.mxint4_expert_buffers(plan, a, n, "cpu")
    assert out.dtype == partials.dtype == torch.float32
    if plan["splits"] == 1:
        assert partials is out
    else:
        assert partials.shape == (plan["splits"], a, n)
        assert partials.data_ptr() != out.data_ptr()


def test_plan_splits_less_on_a_smaller_card():
    """On fewer SMs the wave is smaller, so K splits into fewer runs (none
    on 8 SMs); on more, into more."""
    small = hopper.mxint4_expert_plan(2048, 1024, 8)
    big = hopper.mxint4_expert_plan(2048, 1024, 264)
    assert small["splits"] == 1 and small["k_per"] == 2048
    assert big["splits"] > hopper.mxint4_expert_plan(2048, 1024, 132)["splits"]


@pytest.mark.parametrize("k", [32, 98, 100, 101, 7168])
def test_x_is_handed_over_in_whole_tiles(k):
    """x's rows go to the kernel as TMA tiles: a K that is a multiple of 4
    hands x over as it is (a view at a 16-byte offset, as a row slice of
    it, too); any other K is zero-padded to the next multiple of 4, and the
    padding meets the weights' rows past K as zeros."""
    x = torch.randn(5, k)
    got = hopper.mxint4_expert_x(x)
    if k % 4 == 0:
        assert got is x
        rows = x[2:4]
        assert hopper.mxint4_expert_x(rows).data_ptr() == rows.data_ptr()
    else:
        assert got.shape == (5, k + (-k % 4))
        assert torch.equal(got[:, :k], x) and not got[:, k:].any()
