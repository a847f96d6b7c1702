"""Build and bind the hand-written Hopper kernels in ``kernels/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``.  The
build happens at first use, one ``nvcc`` per source, all started together,
into ``<checkout>/build/repro_torch_kernels`` (``REPRO_TORCH_BUILD_DIR``
overrides it).  A library's file name carries a hash of its source, of every
header it includes from ``csrc/``, and of its compile and link flags, so an
edited source or header is rebuilt and never loaded stale.

The two GEMM kernels take their tile shape (and MXINT4 its K split) from
planners here (`w8a8_plan`, `mxint4_plan`), plain functions of the shape
that the CPU tests reach.

The launch functions here check device, dtype, shape, contiguity and
alignment, launch on PyTorch's current stream, raise on a nonzero
``cudaGetLastError()``, and count their launches in `LAUNCHES`.  Nothing in
this module is imported or built until a kernel is launched on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("mxint4_matmul", "w8a8_matmul", "retention_chunkwise", "flash_decode",
           "rmsnorm_stats")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Link flags per kernel: the W8A8 GEMM encodes its TMA descriptors with
# libcuda's cuTensorMapEncodeTiled.
LINK_FLAGS = {"w8a8_matmul": ("-lcuda",)}

# Launches per kernel since the last `reset_launches()`; bumped only where a
# kernel is launched.
LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_TICKETS: dict[int, torch.Tensor] = {}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/hopper.py -> <checkout>/build/repro_torch_kernels
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA toolkit")


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name: str, csrc: Path | None = None) -> list[Path]:
    """``<name>.cu`` and every header it includes from ``csrc``, transitively
    (``#include "..."``; system headers are the toolkit's)."""
    csrc = CSRC if csrc is None else csrc
    todo, seen = [csrc / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            if (path.parent / inc).exists():
                todo.append((path.parent / inc).resolve())
    return seen


def _lib_path(name: str, csrc: Path | None = None) -> Path:
    h = hashlib.sha256()
    for path in sources(name, csrc):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS.get(name, ())).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def _link_flags(name: str, nvcc: str) -> list[str]:
    flags = list(LINK_FLAGS.get(name, ()))
    stubs = Path(nvcc).resolve().parents[1] / "lib64" / "stubs"
    if "-lcuda" in flags and stubs.is_dir():
        # Link against the toolkit's stub; the installed libcuda.so.1 is
        # loaded at run time (PyTorch has loaded it already).
        flags.insert(0, f"-L{stubs}")
    return flags


def build(names=KERNELS) -> dict[str, str]:
    """Compile the named kernels that are not built yet, in parallel.

    Returns ``{name: ptxas report}`` for the sources compiled by this call
    (registers, shared memory and spills per kernel).  Raises with the
    compiler's output if any build fails.
    """
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _lib_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"),
               *_link_flags(name, nvcc)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    reports, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, target)
        reports[name] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def _lib(name: str) -> ctypes.CDLL:
    with _LOCK:
        if name not in _LIBS:
            build((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _bind(name, lib)
            _LIBS[name] = lib
        return _LIBS[name]


def _bind(name: str, lib: ctypes.CDLL) -> None:
    if name == "mxint4_matmul":
        fn = lib.mxint4_matmul_launch
        fn.argtypes = [_P] * 9 + [_I] * 6 + [_P]
    elif name == "w8a8_matmul":
        fn = lib.w8a8_matmul_launch
        fn.argtypes = [_P] * 6 + [_I] * 4 + [_P]
    elif name == "retention_chunkwise":
        fn = lib.retention_chunkwise_launch
        fn.argtypes = [_P] * 7 + [_I] * 5 + [_P]
        for query in (lib.retention_max_chunk, lib.retention_max_dk):
            query.argtypes, query.restype = [], _I
    elif name == "flash_decode":
        fn = lib.flash_decode_launch
        fn.argtypes = [_P] * 8 + [_I] * 11 + [_F, _I, _P]
        for query in (lib.flash_decode_tile_rows, lib.flash_decode_max_dim,
                      lib.flash_decode_max_group):
            query.argtypes, query.restype = [], _I
    elif name == "rmsnorm_stats":
        fn = lib.rmsnorm_stats_launch
        fn.argtypes = [_P, _P, _I, _I, _I, _I, _F, _P]
    else:
        raise KeyError(f"no binding for kernel {name!r}")
    fn.restype = _I


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           align: int = 4) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name}: must be contiguous and {align}-byte aligned")


def _raise_if(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# MXINT4 decode GEMV (csrc/mxint4_matmul.cu).  A block covers 256 output
# columns and `tm` rows of x; each thread owns `c` columns and loads 32
# bytes of weights per batch, the next batch in flight while it computes
# this one.  A batch of the block is MXINT4_ROWS K rows for every
# instantiated (tm, c), and a K split is a whole number of batches.
MXINT4_TILE_N = 256
MXINT4_ROWS = 64
MXINT4_TILES = {1: 32, 2: 32, 4: 16, 8: 8}      # tm -> columns per thread
MXINT4_MIN_BLOCK_BYTES = 16 << 10                # weight bytes per block


@functools.lru_cache(maxsize=None)
def mxint4_plan(m: int, n: int, k: int, sms: int = 132) -> dict:
    """Tile and K split of one MXINT4 launch.

    ``tm`` is the smallest instantiated row tile that holds M (8 rows per
    tile above that), so no FMA runs on a padding row of a decode batch.
    K is split into runs of whole MXINT4_ROWS batches, each at least
    MXINT4_MIN_BLOCK_BYTES of weights so a block streams enough to cover its
    fixed cost.  Among those splits the plan minimises the rows a block
    streams times the waves of blocks (two blocks fit on an SM), plus a
    per-split charge for the partials' round trip; the constants come from
    sweeping the split at the main-path shapes on an H100 (PERF.md).
    Plans are cached: the search would otherwise cost the host tens of
    microseconds per decode launch.  Callers must not modify the dict.
    """
    tm = next((t for t in MXINT4_TILES if t >= m), max(MXINT4_TILES))
    tiles = -(-n // MXINT4_TILE_N) * -(-m // tm)
    min_rows = MXINT4_MIN_BLOCK_BYTES // (MXINT4_TILE_N // 2)
    best = None
    for want in range(1, max(1, k // min_rows) + 1):
        k_per = -(-k // want)
        k_per += (-k_per) % MXINT4_ROWS
        splits = -(-k // k_per)
        waves = -(-tiles * splits // (2 * sms))
        cost = waves * (k_per + 128) + 6 * splits
        if best is None or (cost, splits) < best[0]:
            best = ((cost, splits), dict(tm=tm, c=MXINT4_TILES[tm], tiles=tiles,
                                         splits=splits, k_per=k_per,
                                         blocks=tiles * splits))
    return best[1]


def mxint4_matmul(x, packed, exps_packed, out_scale, row_scale, bias):
    """f32 x ``[M, K]`` times MXINT4 ``W[K, N]`` with the Eq. (4) epilogue."""
    lib = _lib("mxint4_matmul")
    m, k = x.shape
    n = packed.shape[1] * 2
    if n % 32:
        raise ValueError(f"mxint4_matmul: N={n} must be a multiple of 32")
    _check("x", x, torch.float32, (m, k))
    _check("packed", packed, torch.int8, (k, n // 2), align=16)
    _check("exps_packed", exps_packed, torch.uint8, (k, n // 32), align=1)
    for nm, t, size in (("out_scale", out_scale, n), ("row_scale", row_scale, m),
                        ("bias", bias, n)):
        _check(nm, t, torch.float32, (size,))
    plan = mxint4_plan(m, n, k, _sms(x.device))
    out = torch.empty(m, n, dtype=torch.float32, device=x.device)
    partials = (torch.empty(plan["splits"], m, n, dtype=torch.float32, device=x.device)
                if plan["splits"] > 1 else out)
    tickets = _tickets(x.device, plan["tiles"])
    err = lib.mxint4_matmul_launch(
        x.data_ptr(), packed.data_ptr(), exps_packed.data_ptr(),
        out_scale.data_ptr(), row_scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), partials.data_ptr(), tickets.data_ptr(),
        m, n, k, plan["tm"], plan["splits"], plan["k_per"], _stream())
    _raise_if(err, "mxint4_matmul")
    LAUNCHES["mxint4_matmul"] += 1
    return out


def _sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    return _sm_count(idx)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tickets(device: torch.device, count: int) -> torch.Tensor:
    """Per-device split-K ticket counters: zeroed once, and left at zero by
    every launch (the last block of a tile resets its ticket)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    t = _TICKETS.get(idx)
    if t is None or t.numel() < count:
        t = torch.zeros(max(count, 4096), dtype=torch.int32, device=device)
        _TICKETS[idx] = t
    return t


# W8A8 GEMM (csrc/w8a8_matmul.cu): (BM, BN, stages) of each instantiated
# tile, by the index the kernel takes.  BK is 128 bytes of K, one 128-byte
# swizzled TMA row; a stage holds A [BM x BK] and W^T [BN x BK].
W8A8_BK = 128
W8A8_TILES = ((128, 128, 6), (128, 256, 4), (64, 256, 5), (64, 128, 8))
W8A8_SMALL_M = 64          # M up to this runs one masked m64 row of tiles
# Tiles in order of preference, the most efficient first: on an H100 the
# 128 x 256 tile ran its main loop faster than 128 x 128, and one wave of
# large tiles beat two waves of smaller ones, or a K split, at every
# main-path shape (PERF.md).
W8A8_ORDER = {False: (1, 0, 3), True: (2, 3)}    # keyed by M <= W8A8_SMALL_M


@functools.lru_cache(maxsize=None)
def w8a8_plan(m: int, n: int, sms: int = 132) -> dict:
    """Tile of one W8A8 launch (one block per SM: a block takes about 192 KB
    of shared memory, and runs the whole of K).

    The plan takes the first tile of W8A8_ORDER that gives at least 90 % of
    the SMs a block, with its last wave at least 75 % full; failing that,
    the tile with the most blocks.  Plans are cached; callers must not
    modify the dict.
    """
    def count(cfg):
        bm, bn, _ = W8A8_TILES[cfg]
        return -(-m // bm) * -(-n // bn)

    order = W8A8_ORDER[m <= W8A8_SMALL_M]
    full = [c for c in order
            if count(c) >= 0.9 * sms and count(c) / (-(-count(c) // sms) * sms) >= 0.75]
    cfg = full[0] if full else max(order, key=count)
    bm, bn, stages = W8A8_TILES[cfg]
    return dict(cfg=cfg, bm=bm, bn=bn, stages=stages, blocks=count(cfg))


def check_w8_layout(w_q: torch.Tensor) -> None:
    """W8A8's weight must be ``[K, N]`` held K-major (``w_q.t()`` contiguous,
    as deploy stores it) and 16-byte aligned: TMA reads it as rows of K.
    Raises otherwise; the kernel never relayouts W."""
    if w_q.ndim != 2 or not w_q.t().is_contiguous():
        raise ValueError("w8a8_matmul: w_q must be [K, N] stored K-major "
                         "(w_q.t() contiguous, see deploy.k_major), got strides "
                         f"{tuple(w_q.stride())}")
    if w_q.data_ptr() % 16:
        raise ValueError("w8a8_matmul: w_q must be 16-byte aligned")


def w8a8_matmul(x_q, w_q, out_scale, row_scale, bias):
    """int8 ``[M, K]`` x int8 ``[K, N]`` (K-major) -> f32, exact int32
    accumulate."""
    lib = _lib("w8a8_matmul")
    m, k = x_q.shape
    n = w_q.shape[1]
    if k % 16 or n % 16:
        raise ValueError(f"w8a8_matmul: K={k} and N={n} must be multiples of 16")
    check_w8_layout(w_q)
    _check("x_q", x_q, torch.int8, (m, k), align=16)
    _check("w_q.t()", w_q.t(), torch.int8, (n, k), align=16)
    for nm, t, size in (("out_scale", out_scale, n), ("row_scale", row_scale, m),
                        ("bias", bias, n)):
        _check(nm, t, torch.float32, (size,))
    out = torch.empty(m, n, dtype=torch.float32, device=x_q.device)
    err = lib.w8a8_matmul_launch(
        x_q.data_ptr(), w_q.data_ptr(), out_scale.data_ptr(),
        row_scale.data_ptr(), bias.data_ptr(), out.data_ptr(), m, n, k,
        w8a8_plan(m, n, _sms(x_q.device))["cfg"], _stream())
    _raise_if(err, "w8a8_matmul")
    LAUNCHES["w8a8_matmul"] += 1
    return out


def retention_chunkwise(q, k, v, log_g, state, chunk: int):
    """q, k f32 ``[BH, S, dk]``, v f32 ``[BH, S, dv]``, log_g f32 ``[BH]``,
    state f32 ``[BH, dk, dv]`` or None -> (y ``[BH, S, dv]``, final state)."""
    lib = _lib("retention_chunkwise")
    bh, s, dk = q.shape
    dv = v.shape[-1]
    if chunk > lib.retention_max_chunk() or dk > lib.retention_max_dk():
        raise ValueError(f"retention_chunkwise: chunk {chunk} and dk {dk} must "
                         f"be <= {lib.retention_max_chunk()} and "
                         f"{lib.retention_max_dk()}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    _check("q", q, torch.float32, (bh, s, dk))
    _check("k", k, torch.float32, (bh, s, dk))
    _check("v", v, torch.float32, (bh, s, dv))
    _check("log_g", log_g, torch.float32, (bh,))
    if state is not None:
        _check("state", state, torch.float32, (bh, dk, dv))
    y = torch.empty(bh, s, dv, dtype=torch.float32, device=q.device)
    st = torch.empty(bh, dk, dv, dtype=torch.float32, device=q.device)
    err = lib.retention_chunkwise_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_g.data_ptr(),
        None if state is None else state.data_ptr(), y.data_ptr(),
        st.data_ptr(), bh, s, dk, dv, chunk, _stream())
    _raise_if(err, "retention_chunkwise")
    LAUNCHES["retention_chunkwise"] += 1
    return y, st


# Cache formats `flash_decode` takes, by name, with the kernel's code for each
# (its template parameter) and the dtypes of the value and side arrays.
CACHE_FORMATS = {"f32": (0, torch.float32, None),
                 "bf16": (1, torch.bfloat16, None),
                 "int8": (2, torch.int8, None),            # legacy: q / 32
                 "int8_tok": (3, torch.int8, torch.float32),
                 "mxint4_blk": (4, torch.int8, torch.int8)}


def _cache_operand(name: str, parts: tuple, fmt: str, lead: tuple, dim: int):
    """Check one cache operand ``(values, side or None)`` of format ``fmt``
    with logical shape ``lead + (dim,)``; returns the two pointers."""
    code, vdtype, sdtype = CACHE_FORMATS[fmt]
    values, side = parts
    if fmt == "mxint4_blk":
        if dim % 16:
            raise ValueError(f"{name}: mxint4_blk needs a multiple of 16, got {dim}")
        _check(f"{name}.m", values, vdtype, lead + (dim // 2,), align=1)
        _check(f"{name}.e", side, sdtype, lead + (dim // 16,), align=1)
    elif fmt == "int8_tok":
        _check(f"{name}.q", values, vdtype, lead + (dim,), align=1)
        _check(f"{name}.s", side, sdtype, lead + (1,))
    else:
        _check(name, values, vdtype, lead + (dim,), align=values.element_size())
    return code, values.data_ptr(), None if side is None else side.data_ptr()


def flash_decode(q, k_parts, k_fmt: str, v_parts, v_fmt: str, kv_len: int,
                 scale: float | None):
    """Decode attention of one token over the first ``kv_len`` cache rows.

    q f32 ``[B, KV, G, d]``; K and V as ``(values, side)`` pairs in the
    ``[B, C, KV, *]`` layout of a `CACHE_FORMATS` name (side is the int8_tok
    scales or the mxint4_blk exponents, else None); ``scale=None`` divides the
    scores by sqrt(d), as the plain version does.  Returns f32 ``[B, KV, G, dv]``.
    """
    lib = _lib("flash_decode")
    b, kv, g, d = q.shape
    c = k_parts[0].shape[1]
    dv = v_parts[0].shape[-1] * (2 if v_fmt == "mxint4_blk" else 1)
    tile, max_dim = lib.flash_decode_tile_rows(), lib.flash_decode_max_dim()
    if not (1 <= g <= lib.flash_decode_max_group() and d <= max_dim and dv <= max_dim):
        raise ValueError(f"flash_decode: G={g}, d={d}, dv={dv} exceed the kernel's "
                         f"limits ({lib.flash_decode_max_group()}, {max_dim})")
    if not 1 <= kv_len <= c:
        raise ValueError(f"flash_decode: kv_len {kv_len} outside [1, {c}]")
    _check("q", q, torch.float32, (b, kv, g, d))
    kc, k0, k1 = _cache_operand("k", k_parts, k_fmt, (b, c, kv), d)
    vc, v0, v1 = _cache_operand("v", v_parts, v_fmt, (b, c, kv), dv)
    # Split the kv_len rows into whole tiles until about two blocks per SM
    # (132 on the H100) have work.
    sms = _sms(q.device)
    tiles = -(-kv_len // tile)
    splits = max(1, min(tiles, -(-2 * sms // (b * kv))))
    rows = -(-tiles // splits) * tile
    splits = -(-kv_len // rows)
    out = torch.empty(b, kv, g, dv, dtype=torch.float32, device=q.device)
    partials = (torch.empty(b * kv * splits * g * (2 + dv), dtype=torch.float32,
                            device=q.device) if splits > 1 else out)
    tickets = _tickets(q.device, b * kv)
    div = scale is None
    err = lib.flash_decode_launch(
        q.data_ptr(), k0, k1, v0, v1, out.data_ptr(), partials.data_ptr(),
        tickets.data_ptr(), b, c, kv, g, d, dv, kv_len, kc, vc, splits, rows,
        0.0 if div else float(scale), int(div), _stream())
    _raise_if(err, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return out


def rmsnorm_stats(y, eps: float):
    """sigma^{-1} = rsqrt(mean(y^2) + eps) per row of f32 or bf16 ``[M, D]``
    -> f32 ``[M, 1]``."""
    lib = _lib("rmsnorm_stats")
    m, d = y.shape
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rmsnorm_stats: expected float32 or bfloat16, got {y.dtype}")
    _check("y", y, y.dtype, (m, d), align=y.element_size())
    vec = (d * y.element_size()) % 16 == 0 and y.data_ptr() % 16 == 0
    out = torch.empty(m, 1, dtype=torch.float32, device=y.device)
    err = lib.rmsnorm_stats_launch(y.data_ptr(), out.data_ptr(), m, d,
                                   int(y.dtype == torch.bfloat16), int(vec),
                                   float(eps), _stream())
    _raise_if(err, "rmsnorm_stats")
    LAUNCHES["rmsnorm_stats"] += 1
    return out
