"""Flash-decode's planner and layout check: the parts of a launch that plain
Python decides, tested here on the CPU (the kernel itself runs only on the
card, tests/test_torch_cuda.py)."""

import pytest
import torch

from repro_torch.kernels import hopper

SMS = 132   # the H100 SXM's SMs
FORMATS = ["f32", "bf16", "int8", "int8_tok", "mxint4_blk"]
MAIN_FORMATS = ["f32", "int8_tok", "mxint4_blk"]
QWEN3 = (2, 8, 4, 128, 128)          # B, KV, G, d, dv of qwen3-8b's decode
# (B, KV, G, d, C) of the card tests' flash-decode shapes.
CARD_SHAPES = [(2, 8, 4, 128, 544), (1, 2, 1, 64, 200), (3, 1, 8, 128, 200),
               (2, 2, 4, 32, 200), (1, 4, 8, 64, 33), (1, 2, 1, 256, 300),
               (2, 2, 16, 256, 200), (1, 3, 16, 128, 100)]


def _covers(plan, c, kv_lens=()):
    """The plan's ranges cut the capacity ``c`` into whole tiles, every split
    holding some; at each kv_len the rows the splits stream
    (`hopper.fd_split_rows`, as the kernel computes them) are [0, kv_len),
    each once, in split order, and the empty splits are the trailing ones."""
    ranges, tile = plan["ranges"], plan["tile"]
    assert len(ranges) == plan["splits"] >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == c
    for (s, e), (s2, _) in zip(ranges, ranges[1:]):
        assert e == s2                              # no gap, no overlap
    for s, e in ranges:
        assert s < e                                # no split owns no tile
        assert s % tile == 0                        # whole tiles ...
        assert e % tile == 0 or e == c              # ... cut only at C
    assert plan["tiles"] == -(-c // tile)
    assert plan["rows_per_split"] == max(e - s for s, e in ranges)
    for kv_len in kv_lens:
        rows = hopper.fd_split_rows(ranges, kv_len)
        assert [r for s, e in rows for r in range(s, e)] == list(range(kv_len))
        empty = [s == e for s, e in rows]
        assert not empty[0] and empty == sorted(empty)


def _lens(c):
    return sorted({1, 15, 16, 17, 31, 32, 33, c // 2, c - 1, c} & set(range(1, c + 1)))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("kv_len", [1, 31, 32, 33, 257, 528, 544])
def test_plan_covers_kv_len_with_whole_tiles(fmt, kv_len):
    """The qwen3-8b plan at chip_smoke's capacity (C 544): at every kv_len
    the non-empty splits stream [0, kv_len) once, in whole tiles but the
    last."""
    b, kv, g, d, dv = QWEN3
    plan = hopper.flash_decode_plan(b, kv, g, d, dv, 544, fmt, fmt, SMS)
    _covers(plan, 544, [kv_len])
    for s, e in hopper.fd_split_rows(plan["ranges"], kv_len):
        assert s % plan["tile"] == 0 and (e % plan["tile"] == 0 or e == kv_len)


@pytest.mark.parametrize("b,kv,g,d,c", CARD_SHAPES)
def test_plan_covers_the_card_test_shapes(b, kv, g, d, c):
    for fmt in FORMATS:
        plan = hopper.flash_decode_plan(b, kv, g, d, d, c, fmt, fmt, SMS)
        _covers(plan, c, _lens(c))
        assert 4 * plan["gchunks"] >= g > 4 * (plan["gchunks"] - 1)
        assert plan["ns"] * 128 >= d
        assert plan["blocks"] == b * kv * plan["gchunks"] * plan["splits"]
        # The merging block holds every split's partial in shared memory.
        assert 4 * 4 * (plan["splits"] * (d + 3) + 1) <= hopper.FD_SMEM_BYTES


@pytest.mark.parametrize("fmt", MAIN_FORMATS)
@pytest.mark.parametrize("kv_len", [513, 528, 544])
def test_plan_fills_the_card_and_streams_at_the_qwen3_shape(fmt, kv_len):
    """At chip_smoke's kv_len (513 to 544 of C 544) every SM gets a block,
    every split streams rows, and every split but the last more than one
    ring stage of them, so its next tiles' loads overlap its compute."""
    b, kv, g, d, dv = QWEN3
    plan = hopper.flash_decode_plan(b, kv, g, d, dv, 544, fmt, fmt, SMS)
    assert plan["blocks"] >= SMS
    assert (plan["ns"], plan["gchunks"]) == (1, 1)
    rows = [e - s for s, e in hopper.fd_split_rows(plan["ranges"], kv_len)]
    assert min(rows) > 0 and min(rows[:-1]) > plan["tile"]
    assert 2 <= plan["stages"] <= hopper.FD_MAX_STAGES
    assert plan["stages"] * plan["stage_bytes"] <= hopper.FD_RING_BYTES


@pytest.mark.parametrize("fmt", FORMATS)
def test_plan_at_kv_len_one_leaves_every_split_but_the_first_empty(fmt):
    """One row of a 544-row cache: the first split streams it, the other
    16 stream nothing and merge as empty partials (the card tests hold the
    kernel's merge of them to the plain version)."""
    b, kv, g, d, dv = QWEN3
    plan = hopper.flash_decode_plan(b, kv, g, d, dv, 544, fmt, fmt, SMS)
    rows = hopper.fd_split_rows(plan["ranges"], 1)
    assert plan["splits"] == 17 and rows[0] == (0, 1)
    assert all(s == e for s, e in rows[1:])


def test_plan_is_cached():
    args = (2, 8, 4, 128, 128, 544, "mxint4_blk", "mxint4_blk", SMS)
    assert hopper.flash_decode_plan(*args) is hopper.flash_decode_plan(*args)
    assert hopper.flash_decode_plan.cache_info().hits >= 1


def test_plan_keeps_two_tiles_and_a_byte_floor_per_split():
    # A capacity of 40 rows is 3 tiles: one split, though 16 blocks leave
    # SMs idle.
    assert hopper.flash_decode_plan(2, 8, 4, 128, 128, 40, "f32", "f32", SMS)["splits"] == 1
    # A 200-row mxint4_blk cache at d = 32 is 7.2 KB: one split of at least
    # 4 KB, though 13 tiles would allow 6.
    plan = hopper.flash_decode_plan(2, 2, 4, 32, 32, 200, "mxint4_blk", "mxint4_blk", SMS)
    assert plan["splits"] == 1
    # Enough rows: two blocks per SM.
    big = hopper.flash_decode_plan(2, 8, 4, 128, 128, 4096, "mxint4_blk", "mxint4_blk", SMS)
    assert big["blocks"] >= 2 * SMS and big["stages"] == hopper.FD_MAX_STAGES


@pytest.mark.parametrize("fmt,dim,side", [
    ("f32", 128, (512, 0)), ("bf16", 128, (256, 0)), ("int8", 64, (64, 0)),
    ("int8_tok", 128, (128, 4)), ("mxint4_blk", 128, (64, 8)), ("mxint4_blk", 32, (16, 2)),
])
def test_row_bytes_and_copy_widths(fmt, dim, side):
    assert hopper.fd_row_bytes(fmt, dim) == side
    if side[1]:
        assert hopper.fd_alignment_width(side[1]) == min(16, side[1])


def _offset_view(shape, dtype, offset_elems):
    n = 1
    for s in shape:
        n *= s
    return torch.zeros(n + 16, dtype=dtype)[offset_elems:offset_elems + n].view(shape)


def test_layout_check_accepts_aligned_operands():
    hopper.check_fd_operand("k", torch.zeros(2, 9, 8, 128), torch.float32, (2, 9, 8, 128))
    hopper.check_fd_operand("k.m", torch.zeros(2, 9, 8, 16, dtype=torch.int8),
                            torch.int8, (2, 9, 8, 16))
    # A 2-byte exponent row (mxint4_blk at d = 32) takes 2-byte chunks.
    hopper.check_fd_operand("k.e", _offset_view((2, 9, 8, 2), torch.int8, 2),
                            torch.int8, (2, 9, 8, 2), side=True)
    hopper.check_fd_operand("k.s", torch.ones(2, 9, 8, 1), torch.float32,
                            (2, 9, 8, 1), side=True)


@pytest.mark.parametrize("dtype,offset", [(torch.float32, 1), (torch.float32, 2),
                                          (torch.bfloat16, 4), (torch.int8, 8)])
def test_layout_check_rejects_an_offset_base(dtype, offset):
    shape = (1, 5, 2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        hopper.check_fd_operand("k", _offset_view(shape, dtype, offset), dtype, shape)


@pytest.mark.parametrize("shape,offset", [
    ((1, 5, 2, 8), 4),       # mxint4_blk exponents at d = 128: 8-byte chunks
    ((1, 5, 2, 16), 8),      # d = 256: 16-byte chunks
    ((1, 5, 2, 2), 1),       # d = 32: 2-byte chunks
])
def test_layout_check_rejects_an_offset_side_array(shape, offset):
    with pytest.raises(ValueError, match="aligned"):
        hopper.check_fd_operand("k.e", _offset_view(shape, torch.int8, offset),
                                torch.int8, shape, side=True)


@pytest.mark.parametrize("dtype,dim", [(torch.float32, 6), (torch.bfloat16, 12),
                                       (torch.int8, 24), (torch.int8, 8)])
def test_layout_check_rejects_a_row_pitch_off_16_bytes(dtype, dim):
    """Rows of 24, 24, 24 and 8 bytes: the next row would start off the
    16-byte grid (an 8-byte row is a mxint4_blk cache at d = 16)."""
    t = torch.zeros(1, 5, 2, dim, dtype=dtype)
    with pytest.raises(ValueError, match="16-byte chunks"):
        hopper.check_fd_operand("k", t, dtype, tuple(t.shape))


def test_layout_check_rejects_a_strided_view():
    t = torch.zeros(1, 5, 2, 256)[..., :128]
    with pytest.raises(ValueError, match="contiguous"):
        hopper.check_fd_operand("k", t, torch.float32, (1, 5, 2, 128))


def test_flash_decode_builds_one_library_split_over_cores(tmp_path, monkeypatch):
    """Flash-decode's format pairs build as one library whose device
    compilation nvcc splits over every core; the flag is part of the
    library's hash, and no other kernel takes it."""
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(hopper, "_nvcc", lambda: "cuda/bin/nvcc")
    assert "--split-compile=0" in hopper.nvcc_command("flash_decode", tmp_path / "f.so")
    assert "--split-compile=0" not in hopper.nvcc_command("w8a8_matmul", tmp_path / "w.so")
    path = hopper._lib_path("flash_decode")
    assert path.parent == tmp_path
    monkeypatch.setitem(hopper.COMPILE_FLAGS, "flash_decode", ())
    assert hopper._lib_path("flash_decode") != path


def test_plan_caps_splits_at_the_merge_shared_memory():
    # One (b, h) over a long cache would take 264 splits; the merging block
    # holds 55 partials of dv = 256 with their weights.
    plan = hopper.flash_decode_plan(1, 1, 4, 256, 256, 32768, "f32", "f32", SMS)
    assert plan["splits"] == 55
    _covers(plan, 32768, [1, 600, 32767, 32768])


@pytest.mark.parametrize("k_fmt", FORMATS)
@pytest.mark.parametrize("v_fmt", FORMATS)
@pytest.mark.parametrize("dim", [32, 128, 256])
def test_plan_lays_out_a_stage_the_kernel_accepts(k_fmt, v_fmt, dim):
    """The planner owns a ring stage's layout; the launch accepts it only if
    every array's tile fits its place at a 16-byte aligned offset."""
    plan = hopper.flash_decode_plan(2, 8, 4, dim, dim, 528, k_fmt, v_fmt, SMS)
    off_v, off_ks, off_vs, stage = plan["layout"]
    (kb, ks), (vb, vs) = hopper.fd_row_bytes(k_fmt, dim), hopper.fd_row_bytes(v_fmt, dim)
    t = plan["tile"]
    assert all(x % 16 == 0 for x in plan["layout"])
    assert off_v >= t * kb and off_ks >= off_v + t * vb
    assert off_vs >= off_ks + t * ks and stage >= off_vs + t * vs
    assert stage == plan["stage_bytes"]
    assert plan["stages"] * stage <= hopper.FD_RING_BYTES
