"""The rmsnorm_stats planner (`hopper.rmsnorm_stats_plan`), on the CPU.

The plan is a pure function of the shape, the load width and the card's
SM count, and the launch takes it as it is, so its grid, row split and
stage count (``rounds``: the rounds of loads a thread issues all at once)
are checked here without a card against what `rmsnorm_stats_launch`
accepts: every row in exactly one block, a row's elements split into
whole loads and a tail, the rounds as few as cover the loads, and a
block's threads within the kernel's limit.  That the kernel's threads
then read each load once is for the card tests.  (The kernel's only
shared memory is its 128 bytes of warp sums, whatever the plan.)
"""

import pytest
import torch

from repro_torch.kernels import hopper

# (M, D) the served models normalise, timed on the card (PERF.md).
TIMED = [(1024, 4096), (1024, 2048), (1024, 7168), (1024, 1536), (32768, 128),
         (2, 4096), (16384, 4096), (1000, 4096)]
EDGE_D = [1, 3, 96, 100, 128, 4095, 4096, 7168]
SMS = [114, 132]


def _check(plan: dict, m: int, d: int, elem: int, sms: int = 132) -> None:
    per = plan["width"] // elem
    assert plan["chunks"] * per + plan["tail"] == d and 0 <= plan["tail"] < per
    tpr = plan["tpr"]
    assert 1 <= tpr <= hopper.RMS_MAX_THREADS
    assert (tpr & (tpr - 1)) == 0 if tpr <= 32 else tpr % 32 == 0
    assert plan["threads"] == tpr * plan["rows"] <= hopper.RMS_MAX_THREADS
    # Rows: block b owns [b * rows, (b + 1) * rows); every row once, no block empty.
    assert plan["blocks"] == -(-m // plan["rows"])
    assert (plan["blocks"] - 1) * plan["rows"] < m <= plan["blocks"] * plan["rows"]
    # A round is every thread's loads; the rounds are as few as cover the row.
    assert plan["loads"] in (1, hopper.RMS_MAX_LOADS)
    per_round = tpr * plan["loads"]
    assert (plan["rounds"] - 1) * per_round < plan["chunks"] <= plan["rounds"] * per_round \
        or plan["rounds"] == plan["chunks"] == 0
    assert plan["resident"] == min(32, hopper.RMS_THREADS_PER_SM // plan["threads"])
    assert plan["waves"] == -(-plan["blocks"] // (sms * plan["resident"]))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("m,d", TIMED)
def test_plan_covers_the_timed_shapes(m, d, elem, sms):
    _check(hopper.rmsnorm_stats_plan(m, d, elem, sms), m, d, elem, sms)


@pytest.mark.parametrize("width", [16, 8, 4, 2])
@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("m", [1, 7, 1000])
@pytest.mark.parametrize("d", EDGE_D)
def test_plan_covers_edge_widths_and_alignments(d, m, elem, width):
    """D = 1 .. 7168 at every load width a row's alignment can give (2
    bytes only for bf16), M = 1 included."""
    if width < elem:
        with pytest.raises(ValueError, match="no plan"):
            hopper.rmsnorm_stats_plan(m, d, elem, 132, width)
        return
    _check(hopper.rmsnorm_stats_plan(m, d, elem, 132, width), m, d, elem)


@pytest.mark.parametrize("m", [1, 3, 32768])
@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("d", EDGE_D + [65536, 100000])
def test_few_and_many_rows_cover_every_row(d, elem, m):
    """One load per thread (few rows) and two (many), and rows longer than
    one round of the block's threads."""
    plan = hopper.rmsnorm_stats_plan(m, d, elem, 132)
    _check(plan, m, d, elem)
    if m == 32768 and plan["chunks"] > 1:
        assert plan["loads"] == hopper.RMS_MAX_LOADS


def test_long_rows_take_more_rounds():
    """100000 f32 values are 25000 loads: 13 rounds of 1024 threads x 2."""
    plan = hopper.rmsnorm_stats_plan(4, 100000, 4, 132)
    assert plan["tpr"] == hopper.RMS_MAX_THREADS and plan["rounds"] == 13


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("m,d", TIMED)
def test_prefill_rows_take_one_round(m, d, elem):
    """At every timed shape a thread issues all its loads of the row at
    once: one round."""
    assert hopper.rmsnorm_stats_plan(m, d, elem, 132)["rounds"] == 1


def test_main_shape_plan():
    """[1024, 4096] bf16 on 132 SMs: 256 threads per row, 2 loads of 16 bytes
    each, a row per block, 1024 blocks in one wave (8 per SM)."""
    plan = hopper.rmsnorm_stats_plan(1024, 4096, 2, 132)
    assert {k: plan[k] for k in ("width", "loads", "rounds", "tpr", "rows", "threads",
                                 "blocks", "resident", "waves")} == dict(
        width=16, loads=2, rounds=1, tpr=256, rows=1, threads=256, blocks=1024, resident=8,
        waves=1)


@pytest.mark.parametrize("d,tpr", [(512, 32), (1024, 64), (2048, 128)])
def test_many_rows_fill_a_block(d, tpr):
    """Enough rows for every SM: rows share a block of RMS_BLOCK_THREADS."""
    plan = hopper.rmsnorm_stats_plan(4096, d, 2, 132)
    assert plan["tpr"] == tpr and plan["rows"] == hopper.RMS_BLOCK_THREADS // tpr
    _check(plan, 4096, d, 2)


@pytest.mark.parametrize("sms", SMS)
def test_decode_rows_spread_over_warps(sms):
    """[2, 4096] bf16: one row per block, on as many threads as the row
    has 16-byte chunks, one load each."""
    plan = hopper.rmsnorm_stats_plan(2, 4096, 2, sms)
    assert (plan["blocks"], plan["rows"], plan["tpr"], plan["loads"]) == (2, 1, 512, 1)


@pytest.mark.parametrize("elem", [2, 4])
def test_narrow_rows_pack_into_warps(elem):
    """qwen3-8b's per-head norms ([32768, 128]): several rows per warp."""
    plan = hopper.rmsnorm_stats_plan(32768, 128, elem, 132)
    assert plan["tpr"] < 32 and plan["rows"] * plan["tpr"] == hopper.RMS_BLOCK_THREADS
    assert plan["blocks"] >= 132


def test_few_rows_take_one_row_per_block():
    """Fewer row pairs than SMs: one row per block, so each takes an SM."""
    for m in (1, 3, 100):
        plan = hopper.rmsnorm_stats_plan(m, 2048, 2, 132)
        assert plan["rows"] == 1 and plan["blocks"] == m


@pytest.mark.parametrize("addr,stride,elem,want", [
    (0, 8192, 2, 16), (2, 8192, 2, 2), (4, 8192, 2, 4), (8, 8200, 2, 8),
    (0, 8194, 2, 2), (4, 16384, 4, 4), (8, 16392, 4, 8), (0, 528, 4, 16), (0, 12, 4, 4),
])
def test_load_width_follows_base_and_stride(addr, stride, elem, want):
    assert hopper.rms_width(addr, stride, elem) == want


def test_plan_rejects_what_the_kernel_does_not_take():
    for args in ((0, 64, 2), (4, 0, 2), (4, 64, 8)):
        with pytest.raises(ValueError, match="no plan"):
            hopper.rmsnorm_stats_plan(*args, 132)


def test_wrapper_checks_before_it_builds():
    """On the CPU the launch function raises before it looks for nvcc."""
    with pytest.raises(ValueError, match="CUDA"):
        hopper.rmsnorm_stats(torch.ones(4, 64), 1e-6)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        hopper.rmsnorm_stats(torch.ones(4, 64, dtype=torch.float16), 1e-6)
