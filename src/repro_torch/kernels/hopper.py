"""Build and bind the hand-written Hopper kernels in ``kernels/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``.  The
build happens at first use, one ``nvcc`` per source, all started together,
into ``<checkout>/build/repro_torch_kernels`` (``REPRO_TORCH_BUILD_DIR``
overrides it).  A library's file name carries a hash of its source, of every
header it includes from ``csrc/``, and of its compile and link flags, so an
edited source or header is rebuilt and never loaded stale.

The two GEMM kernels take their tile shape (and MXINT4 its K split) from
planners here (`w8a8_plan`, `mxint4_plan`), the routed-MoE expert GEMV its
tile and K split from `mxint4_expert_plan`, flash-decode its split and ring
from `flash_decode_plan`, and retention the size of its scratch from
`retention_plan` (its tiles and grid are fixed in the kernel), and
rmsnorm_stats its row split and grid from `rmsnorm_stats_plan`: plain
functions of the shape that the CPU tests reach, as are the layout checks
(`check_fd_operand`, `retention_dims`, `rms_width`).

The launch functions here check device, dtype, shape, contiguity and
alignment, launch on PyTorch's current stream, raise on a nonzero
``cudaGetLastError()``, and count their launches in `LAUNCHES`.  Nothing in
this module is imported or built until a kernel is launched on a CUDA tensor.
"""

from __future__ import annotations

import contextlib
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
           "rmsnorm_stats", "retention_chunkwise_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Link flags per kernel: the W8A8 GEMM and the routed-MoE expert GEMV encode
# their TMA descriptors with libcuda's cuTensorMapEncodeTiled.
LINK_FLAGS = {"w8a8_matmul": ("-lcuda",), "mxint4_matmul": ("-lcuda",)}

# Compile flags per kernel.  flash_decode.cu instantiates every (K, V) cache
# format pair, 50 kernels: nvcc splits their device compilation over every
# core (on an 8-core H100 host, 17.6-18.0 s for the five kernels' build
# against 37.5 s without the split; tools/kernel_build_times.py).
COMPILE_FLAGS = {"flash_decode": ("--split-compile=0",)}

# Launches per kernel since the last `reset_launches()`; bumped only where a
# kernel is launched.  Flash-decode's MLA mode is a kernel of its own in the
# flash_decode library, and the routed-MoE expert GEMV one in the
# mxint4_matmul library; each has its own count.
COUNTERS = KERNELS + ("flash_decode_mla", "mxint4_expert_matmul")
LAUNCHES: dict[str, int] = {name: 0 for name in COUNTERS}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_TICKETS: dict[int, torch.Tensor] = {}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launches() -> None:
    for name in COUNTERS:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def captured_launches():
    """Count the launches a CUDA graph capture records.

    The wrappers count each launch as they make it, but under capture the
    launch is only recorded: nothing runs.  Inside this context those counts
    go into the yielded dict instead of `LAUNCHES`, and `count_replay` adds
    them to `LAUNCHES` each time the graph is replayed, when they do run.
    """
    before = dict(LAUNCHES)
    recorded: dict[str, int] = {}
    try:
        yield recorded
    finally:
        for name in COUNTERS:
            recorded[name] = LAUNCHES[name] - before[name]
            LAUNCHES[name] = before[name]


def count_replay(recorded: dict) -> None:
    """Count the launches of one replay of a graph captured under
    `captured_launches`."""
    for name, n in recorded.items():
        LAUNCHES[name] += n


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
    h.update(" ".join(NVCC_FLAGS + COMPILE_FLAGS.get(name, ())
                      + LINK_FLAGS.get(name, ())).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def _link_flags(name: str, nvcc: str) -> list[str]:
    flags = list(LINK_FLAGS.get(name, ()))
    stubs = Path(nvcc).resolve().parents[1] / "lib64" / "stubs"
    if "-lcuda" in flags and stubs.is_dir():
        # Link against the toolkit's stub; the installed libcuda.so.1 is
        # loaded at run time (PyTorch has loaded it already).
        flags.insert(0, f"-L{stubs}")
    return flags


def nvcc_command(name: str, out: Path, flags: tuple | None = None,
                 csrc: Path | None = None) -> list:
    """The nvcc command that builds ``<csrc>/<name>.cu`` into the library
    ``out``, with ``flags`` (by default the kernel's `COMPILE_FLAGS`) after
    the common ones."""
    nvcc = _nvcc()
    flags = COMPILE_FLAGS.get(name, ()) if flags is None else flags
    return [nvcc, *NVCC_FLAGS, *flags, "-o", str(out),
            str((CSRC if csrc is None else csrc) / f"{name}.cu"), *_link_flags(name, nvcc)]


def build(names=KERNELS) -> dict[str, str]:
    """Compile the named kernels that are not built yet, in parallel.

    Returns ``{name: ptxas report}`` for the sources compiled by this call
    (registers, shared memory and spills per kernel).  Raises with the
    compiler's output if any build fails.
    """
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        target = _lib_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, subprocess.Popen(nvcc_command(name, tmp), stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True),
                      tmp, target))
    reports, failed = {}, []
    for name, proc, tmp, target in procs:
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
        experts = lib.mxint4_expert_matmul_launch
        experts.argtypes = [_P] * 7 + [_I] * 8 + [_P]
        experts.restype = _I
    elif name == "w8a8_matmul":
        fn = lib.w8a8_matmul_launch
        fn.argtypes = [_P] * 6 + [_I] * 4 + [_P]
    elif name == "retention_chunkwise":
        fn = lib.retention_chunkwise_launch
        fn.argtypes = [_P] * 11
    elif name == "retention_chunkwise_bwd":
        fn = lib.retention_chunkwise_bwd_launch
        fn.argtypes = [_P] * 17
    elif name == "flash_decode":
        fn = lib.flash_decode_launch
        fn.argtypes = [_P] * 9 + [_I] * 17 + [_F, _I, _P]
        limits = ((lib.flash_decode_tile_rows, FD_TILE),
                  (lib.flash_decode_max_dim, FD_MAX_DIM),
                  (lib.flash_decode_max_group, FD_MAX_GROUP),
                  (lib.flash_decode_max_stages, FD_MAX_STAGES))
        mla = lib.flash_decode_mla_launch
        mla.argtypes = [_P] * 8 + [_I] * 13 + [_F, _P]
        mla.restype = _I
        clusters = lib.flash_decode_mla_max_clusters
        clusters.argtypes, clusters.restype = [_I, _I], _I
        limits += ((lib.flash_decode_mla_tile_rows, MLA_TILE),
                   (lib.flash_decode_mla_heads, MLA_HEADS),
                   (lib.flash_decode_mla_max_splits, MLA_MAX_SPLITS))
        for query, want in limits:
            query.argtypes, query.restype = [], _I
            if query() != want:
                raise RuntimeError(f"flash_decode: the library's {query.__name__} "
                                   f"is {query()}, the planner's {want}")
    elif name == "rmsnorm_stats":
        fn = lib.rmsnorm_stats_launch
        fn.argtypes = [_P, _P, _I, _I, ctypes.c_longlong] + [_I] * 9 + [_F, _P]
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
    tickets = ticket_counters(x.device, plan["tiles"])
    err = lib.mxint4_matmul_launch(
        x.data_ptr(), packed.data_ptr(), exps_packed.data_ptr(),
        out_scale.data_ptr(), row_scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), partials.data_ptr(), tickets.data_ptr(),
        m, n, k, plan["tm"], plan["splits"], plan["k_per"], _stream())
    _raise_if(err, "mxint4_matmul")
    LAUNCHES["mxint4_matmul"] += 1
    return out


# Routed-MoE expert GEMV (csrc/mxint4_matmul.cu `mxint4_expert_gemv_kernel`).
# A block walks a tile of 512 columns of one expert over a run of ``k_per``
# K rows, in steps (batches) of 64 rows of 256 bytes of mantissas each, and
# computes every row routed to that expert; K splits into runs of ``k_per``.
MXINT4_EXPERT_TILE_N = 512
MXINT4_EXPERT_STEP = 64
MXINT4_EXPERT_EXPERTS = 16              # distinct experts of a B 2, top-8 decode step, at most
MXINT4_EXPERT_BLOCKS_PER_SM = 2          # ~110 KB of shared memory a block, 128 registers a thread


@functools.lru_cache(maxsize=None)
def mxint4_expert_plan(k: int, n: int, sms: int = 132) -> dict:
    """Tile and K split of one expert GEMV launch, a function of (K, N) and
    the card alone: never of the row count or the routing, so a row's order
    of summation, and with it its bits, do not depend on the rest of the
    launch.

    K is split into ``splits`` runs of ``k_per`` rows (whole
    MXINT4_EXPERT_STEP batches), as many as let the items of
    MXINT4_EXPERT_EXPERTS experts (an item is a run of one tile) fill one
    wave of MXINT4_EXPERT_BLOCKS_PER_SM blocks on every SM: a decode step's
    experts then take one item a block, and a split costs a round trip
    through the workspace, so no more are made.  ``blocks_per_expert`` is
    ``tiles * splits``.  Plans are cached; callers must not modify the dict.
    """
    step = MXINT4_EXPERT_STEP
    tiles = -(-n // MXINT4_EXPERT_TILE_N)
    steps = -(-k // step)
    want = MXINT4_EXPERT_BLOCKS_PER_SM * sms // MXINT4_EXPERT_EXPERTS
    splits = max(1, min(steps, want // tiles))
    per = -(-steps // splits)
    splits = -(-steps // per)                     # even runs: the last is no shorter
    return dict(tiles=tiles, splits=splits, k_per=per * step,
                blocks_per_expert=tiles * splits)


def mxint4_expert_blocks(plan: dict, a: int, e: int, sms: int = 132) -> int:
    """Persistent blocks of one launch: MXINT4_EXPERT_BLOCKS_PER_SM on every
    SM, or fewer when the launch has fewer items (an item is a (slot, split,
    tile), ``min(A, E)`` slots at most).  Which block takes which item
    changes no sum."""
    return min(min(a, e) * plan["blocks_per_expert"], MXINT4_EXPERT_BLOCKS_PER_SM * sms)


def mxint4_expert_x(x: torch.Tensor) -> torch.Tensor:
    """x as the kernel reads it, in TMA tiles: 16-byte aligned rows of a
    multiple of 4 floats; a copy zero-padded past K where x is not so."""
    k = x.shape[1]
    if k % 4:
        return torch.nn.functional.pad(x, (0, -k % 4))
    return x if x.data_ptr() % 16 == 0 else x.clone()


def mxint4_expert_buffers(plan: dict, a: int, n: int, device) -> tuple:
    """``out`` ``[A, N]`` and the split workspace ``[splits, A, N]`` (``out``
    itself when K is not split) of one launch, allocated with torch.empty."""
    out = torch.empty(a, n, dtype=torch.float32, device=device)
    partials = (torch.empty(plan["splits"], a, n, dtype=torch.float32, device=device)
                if plan["splits"] > 1 else out)
    return out, partials


def mxint4_expert_matmul(x, packed, exps_packed, expert_ids):
    """f32 ``[A, N]``: row ``a`` of x ``[A, K]`` times the MXINT4 weight of
    expert ``expert_ids[a]`` (int64 ``[A]`` on the card) from the stacks
    ``packed`` ``[E, K, N/2]`` and ``exps_packed`` ``[E, K, N/32]``."""
    lib = _lib("mxint4_matmul")
    a, k = x.shape
    e, n = packed.shape[0], packed.shape[-1] * 2
    if n % 32:
        raise ValueError(f"mxint4_expert_matmul: N={n} must be a multiple of 32")
    _check("x", x, torch.float32, (a, k))
    _check("packed", packed, torch.int8, (e, k, n // 2), align=16)
    _check("exps_packed", exps_packed, torch.uint8, (e, k, n // 32), align=1)
    _check("expert_ids", expert_ids, torch.int64, (a,), align=8)
    sms = _sms(x.device)
    plan = mxint4_expert_plan(k, n, sms)
    out, partials = mxint4_expert_buffers(plan, a, n, x.device)
    tickets = ticket_counters(x.device, min(a, e) * plan["tiles"])
    xt = mxint4_expert_x(x)
    err = lib.mxint4_expert_matmul_launch(
        xt.data_ptr(), packed.data_ptr(), exps_packed.data_ptr(), expert_ids.data_ptr(),
        out.data_ptr(), partials.data_ptr(), tickets.data_ptr(), a, n, k, xt.shape[1], e,
        plan["k_per"], plan["splits"], mxint4_expert_blocks(plan, a, e, sms), _stream())
    _raise_if(err, "mxint4_expert_matmul")
    LAUNCHES["mxint4_expert_matmul"] += 1
    return out


def _sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    return _sm_count(idx)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ticket_counters(device: torch.device, count: int = 0) -> torch.Tensor:
    """Per-device split-K ticket counters: zeroed once, and left at zero by
    every launch (the last block of a tile resets its ticket).  They are
    reallocated only to grow: a captured graph that launched on the old
    buffer keeps a reference to it."""
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


# Chunkwise retention (csrc/retention_chunkwise.cu).  The kernel fixes its
# tiles and works out its own grid; the host sizes the scratch it allocates.
# Limits: a chunk of at most RET_MAX_CHUNK positions (a score or output
# block holds a whole chunk), dk of at most RET_MAX_DK.
RET_MAX_CHUNK = 128
RET_MAX_DK = 256


@functools.lru_cache(maxsize=None)
def retention_plan(bh: int, s: int, dk: int, dv: int, chunk: int) -> dict:
    """Scratch of one retention launch.

    ``ldp`` is the row stride of the decayed-score scratch (chunk rounded up
    to whole 16-byte copies); ``p_floats`` and ``s_floats`` size the scores
    of every (bh, chunk) and the incoming states of chunks 1..n-1, which
    grow linearly in ``s``.  Raises on a shape the kernel does not take.
    Plans are cached; callers must not modify the dict.
    """
    if not 1 <= chunk <= RET_MAX_CHUNK or dk > RET_MAX_DK:
        raise ValueError(f"retention_chunkwise: chunk {chunk} and dk {dk} must be "
                         f"in [1, {RET_MAX_CHUNK}] and <= {RET_MAX_DK}")
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    if dk % 4 or dv % 4:
        raise ValueError(f"retention_chunkwise: dk {dk} and dv {dv} must be multiples "
                         "of 4 (rows of whole 16-byte copies)")
    n = s // chunk
    ldp = -(-chunk // 4) * 4
    return dict(n_chunks=n, ldp=ldp, p_floats=bh * n * chunk * ldp,
                s_floats=bh * (n - 1) * dk * dv)


def check_retention_operand(name: str, t: torch.Tensor, shape: tuple) -> tuple:
    """Layout of a retention input q, k or v ``[B, H, S, d]`` (any device).

    The kernel reads rows of d floats in 16-byte copies through the view's
    own (B, H, S) strides, so it takes f32 with a unit last-dim stride, d a
    multiple of 4, every stride of a dimension longer than 1 a multiple of
    4, and a 16-byte aligned base: the model's ``transpose(1, 2)`` views
    pass as they are.  Returns those three strides; raises on anything else
    (nothing is copied into a layout the kernel takes).
    """
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected torch.float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: last dim must have stride 1, got strides {t.stride()}")
    if shape[-1] % 4 or any(st % 4 for st, n in zip(t.stride()[:3], shape[:3]) if n > 1):
        raise ValueError(f"{name}: rows must be whole 16-byte copies (d and the B, H, S "
                         f"strides multiples of 4 floats), got shape {tuple(shape)}, "
                         f"strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: base must be 16-byte aligned (address {t.data_ptr():#x})")
    return tuple(st if n > 1 else 0 for st, n in zip(t.stride()[:3], shape[:3]))


def retention_dims(q, k, v, gamma, state, chunk: int) -> tuple[dict, tuple, tuple]:
    """Check one launch's operands (any device) and return its plan, the
    kernel's input pointers (q, k, v, gamma, state or None: the tensors'
    own) and its int64 dims: B, H, S, dk, dv, chunk, ldp, the (B, H, S)
    strides of q, k and v as the views have them, and those of y in its
    ``[B, S, H, dv]`` buffer.  Raises on anything the kernel does not take."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    plan = retention_plan(b * h, s, dk, dv, chunk)
    strides = [check_retention_operand(nm, t, (b, h, s, d)) for nm, t, d in
               (("q", q, dk), ("k", k, dk), ("v", v, dv))]
    if gamma.dtype != torch.float32 or tuple(gamma.shape) != (h,) or gamma.stride(0) != 1:
        raise ValueError(f"gamma: expected contiguous float32 [{h}], got {gamma.dtype} "
                         f"{tuple(gamma.shape)}")
    if state is not None and (state.dtype != torch.float32 or not state.is_contiguous()
                              or tuple(state.shape) != (b, h, dk, dv)
                              or state.data_ptr() % 16):
        raise ValueError(f"state: expected contiguous 16-byte aligned float32 "
                         f"{(b, h, dk, dv)}, got {state.dtype} {tuple(state.shape)}")
    dims = (b, h, s, dk, dv, chunk, plan["ldp"], *strides[0], *strides[1], *strides[2],
            s * h * dv, dv, h * dv)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), gamma.data_ptr(),
            None if state is None else state.data_ptr())
    return plan, ptrs, dims


def retention_chunkwise(q, k, v, gamma, state, chunk: int):
    """q, k f32 ``[B, H, S, dk]``, v f32 ``[B, H, S, dv]`` (strided views as
    `check_retention_operand` takes them), gamma f32 ``[H]``, state f32
    ``[B, H, dk, dv]`` contiguous or None -> (y ``[B, H, S, dv]``, a view of a
    ``[B, S, H, dv]`` buffer, and the final state ``[B, H, dk, dv]``).  The
    kernel reads the views in place: nothing is copied."""
    for t in (q, k, v, gamma) + (() if state is None else (state,)):
        if not t.is_cuda:
            raise ValueError(f"retention_chunkwise: expected CUDA tensors, got {t.device}")
    plan, ptrs, dims = retention_dims(q, k, v, gamma, state, chunk)
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    lib = _lib("retention_chunkwise")
    y = torch.empty(b, s, h, dv, dtype=torch.float32, device=q.device)
    st = torch.empty(b, h, dk, dv, dtype=torch.float32, device=q.device)
    scratch = torch.empty(plan["p_floats"] + plan["s_floats"], dtype=torch.float32,
                          device=q.device)
    err = lib.retention_chunkwise_launch(
        *ptrs, y.data_ptr(), st.data_ptr(),
        scratch.data_ptr(), scratch.data_ptr() + 4 * plan["p_floats"],
        (ctypes.c_longlong * len(dims))(*dims), _stream())
    _raise_if(err, "retention_chunkwise")
    LAUNCHES["retention_chunkwise"] += 1
    return y.permute(0, 2, 1, 3), st


# Backward of chunkwise retention (csrc/retention_chunkwise_bwd.cu): two
# launches, one count.  The host sizes its scratch: the recomputed incoming
# states S_1..S_{N-1} and the cotangents dS_1..dS_{N-1} (S_0 and dS_N are
# read where the caller holds them), and the decayed scores P and dP.
@functools.lru_cache(maxsize=None)
def retention_bwd_plan(bh: int, s: int, dk: int, dv: int, chunk: int) -> dict:
    """Scratch of one backward launch: ``s_floats`` for each of the two state
    scratches (``[BH, N - 1, dk, dv]``, empty for one chunk) and ``p_floats``
    for each of P and dP (``[BH, N, chunk, ldp]``); both grow linearly in
    ``s``.  Raises on a shape the kernel does not take, as `retention_plan`
    does.  Plans are cached; callers must not modify the dict."""
    fwd = retention_plan(bh, s, dk, dv, chunk)
    n, ldp = fwd["n_chunks"], fwd["ldp"]
    return dict(n_chunks=n, ldp=ldp, s_floats=bh * (n - 1) * dk * dv,
                p_floats=bh * n * chunk * ldp)


def retention_bwd_flops(b: int, h: int, s: int, dk: int, dv: int, chunk: int,
                        warm: bool, final_cotangent: bool, need_dstate: bool) -> int:
    """The multiply-adds (x 2) the backward needs at one shape: P and dP and
    the intra-chunk products over the pairs i >= t of every chunk, and the
    state products where their operands are not zero: the recomputed states
    S_1..S_{N-1} (and the cross term of dQ) beyond a zero initial state, dS_j
    for the chunks whose cotangent reaches back (dS_0 only when asked for),
    and dK's and dV's state terms where dS_{j+1} is not zero."""
    n, pairs, mat = s // chunk, chunk * (chunk + 1) // 2, chunk * dk * dv
    intra = n * 2 * pairs * (3 * dk + 2 * dv)        # P, dP; dQ, dK, dV within chunks
    states = 2 * (n - 1) + int(need_dstate)          # S_1..S_{N-1}; dS_{N-1}..dS_1 (, dS_0)
    cross = (n - 1 + int(warm)) + 2 * (n - 1 + int(final_cotangent))
    return b * h * (intra + 2 * mat * (states + cross))


def retention_chunkwise_bwd(q, k, v, gamma, state, dy, dstate, chunk: int,
                            need_dstate: bool):
    """Gradient of `retention_chunkwise`: q, k, v, gamma, state as the forward
    took them, dy f32 ``[B, H, S, dv]`` (any view with a unit last stride and
    16-byte rows; another layout is copied contiguous) and dstate, the final
    state's cotangent ``[B, H, dk, dv]`` or None (zero) -> (dq, dk, dv, each a
    ``[B, H, S, d]`` view of a ``[B, S, H, d]`` buffer, and the initial
    state's cotangent, or None unless ``need_dstate``)."""
    for t in (q, k, v, gamma, dy) + tuple(x for x in (state, dstate) if x is not None):
        if not t.is_cuda:
            raise ValueError(f"retention_chunkwise_bwd: expected CUDA tensors, got {t.device}")
    _, ptrs, dims = retention_dims(q, k, v, gamma, state, chunk)
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    try:
        gs = check_retention_operand("dy", dy, (b, h, s, dv))
    except ValueError:
        dy = dy.contiguous()
        gs = check_retention_operand("dy", dy, (b, h, s, dv))
    if dstate is not None:
        dstate = dstate.contiguous()
        _check("dstate", dstate, torch.float32, (b, h, dk, dv), 16)
    plan = retention_bwd_plan(b * h, s, dk, dv, chunk)
    lib = _lib("retention_chunkwise_bwd")
    grads = [torch.empty(b, s, h, d, dtype=torch.float32, device=q.device)
             for d in (dk, dk, dv)]
    ds0 = torch.empty(b, h, dk, dv, dtype=torch.float32, device=q.device) if need_dstate else None
    sf, pf = plan["s_floats"], plan["p_floats"]
    scratch = torch.empty(2 * sf + 2 * pf, dtype=torch.float32, device=q.device)
    base = scratch.data_ptr()
    out_strides = tuple(st for g in grads for st in (s * h * g.shape[-1], g.shape[-1],
                                                     h * g.shape[-1]))
    all_dims = dims[:16] + gs + out_strides
    err = lib.retention_chunkwise_bwd_launch(
        *ptrs, dy.data_ptr(), None if dstate is None else dstate.data_ptr(),
        *(g.data_ptr() for g in grads), None if ds0 is None else ds0.data_ptr(),
        base, base + 4 * sf, base + 8 * sf, base + 8 * sf + 4 * pf,
        (ctypes.c_longlong * len(all_dims))(*all_dims), _stream())
    _raise_if(err, "retention_chunkwise_bwd")
    LAUNCHES["retention_chunkwise_bwd"] += 1
    dq, dk_, dv_ = (g.permute(0, 2, 1, 3) for g in grads)
    return dq, dk_, dv_, ds0


# Cache formats `flash_decode` takes, by name, with the kernel's code for each
# (its template parameter) and the dtypes of the value and side arrays.
CACHE_FORMATS = {"f32": (0, torch.float32, None),
                 "bf16": (1, torch.bfloat16, None),
                 "int8": (2, torch.int8, None),            # legacy: q / 32
                 "int8_tok": (3, torch.int8, torch.float32),
                 "mxint4_blk": (4, torch.int8, torch.int8)}

# Flash-decode (csrc/flash_decode.cu).  A block of 4 warps streams FD_TILE-row
# tiles of one (b, h) through a ring of 2-4 stages in shared memory, each
# warp 4 rows of a tile; the planner lays out a stage, and the launch checks
# it.  The grid is fixed by the capacity C and the kernel reads kv_len from
# device memory, so one launch (or one captured graph) serves every
# position; a split whose rows all lie at or past kv_len streams nothing.
# A lane holds 4 elements of each 128-wide slot of a row (ns slots: 1
# for d, dv <= 128, else 2), and a block's registers hold FD_GROUP query
# heads; a larger G runs in chunks of FD_GROUP, a block each.
FD_TILE = 16
FD_GROUP = 4
FD_MAX_DIM = 256
FD_MAX_GROUP = 16
FD_MAX_STAGES = 4
FD_BLOCKS_PER_SM = 2            # blocks the grid aims for on every SM
FD_RING_BYTES = 96 << 10        # shared memory a block's ring may take
FD_SMEM_BYTES = 226 << 10       # shared memory a block may take
FD_MIN_BLOCK_BYTES = 4 << 10    # cache bytes a split streams at least


def fd_row_bytes(fmt: str, dim: int) -> tuple[int, int]:
    """Bytes of one cache row of ``dim`` elements in format ``fmt``: the
    values, and the side data (int8_tok's scale, mxint4_blk's exponents)."""
    return {"f32": (4 * dim, 0), "bf16": (2 * dim, 0), "int8": (dim, 0),
            "int8_tok": (dim, 4), "mxint4_blk": (dim // 2, dim // 16)}[fmt]


def _up16(n: int) -> int:
    return -(-n // 16) * 16


@functools.lru_cache(maxsize=None)
def flash_decode_plan(b: int, kv: int, g: int, d: int, dv: int, c: int,
                      k_fmt: str, v_fmt: str, sms: int = 132) -> dict:
    """Grid and ring of one flash-decode launch on a cache of capacity ``c``.

    The plan depends on the capacity, not on kv_len, as the reference's grid
    does: the C rows are cut into FD_TILE-row tiles, and each of ``splits``
    blocks per (b, h, G-chunk) owns an even share of them (the first
    ``tiles % splits`` splits one tile more), so every split holds whole
    tiles (``ranges`` lists each split's rows, as the kernel computes them).
    At a given kv_len the kernel streams only the rows of a range below it:
    a split that starts at or past kv_len streams nothing and merges as an
    empty partial, and no row at or past kv_len is read (`fd_split_rows`).
    ``splits`` is the fewest that gives each of the ``sms`` SMs
    FD_BLOCKS_PER_SM blocks (a block's 4 warps alone leave an SM's
    schedulers idle while they wait), but no more than keeps at least two
    tiles, and FD_MIN_BLOCK_BYTES of cache, per split, or than the merging
    block can hold in shared memory (every split's f32 partial and weights,
    FD_GROUP x (dv + 3) values).  The ring holds every tile of a split, up
    to FD_MAX_STAGES stages and FD_RING_BYTES.  A stage holds a tile of K's
    values, V's, and K's and V's side rows, each array at a 16-byte aligned
    offset (``layout``: V's values, K's side, V's side, and the stage's
    bytes).  Plans are cached (decode asks for one per layer and step);
    callers must not modify the dict.
    """
    ns = 1 if max(d, dv) <= 128 else 2
    gchunks = -(-g // FD_GROUP)
    (kb, ks), (vb, vs) = fd_row_bytes(k_fmt, d), fd_row_bytes(v_fmt, dv)
    off_v = FD_TILE * kb
    off_ks = off_v + FD_TILE * vb
    off_vs = off_ks + _up16(FD_TILE * ks)
    stage_bytes = off_vs + _up16(FD_TILE * vs)
    tiles = -(-c // FD_TILE)
    units = b * kv * gchunks
    by_bytes = c * (kb + ks + vb + vs) // FD_MIN_BLOCK_BYTES
    by_smem = (FD_SMEM_BYTES - 16) // (4 * FD_GROUP * (dv + 3))
    splits = max(1, min(-(-FD_BLOCKS_PER_SM * sms // units), tiles // 2, by_bytes, by_smem))
    lo, extra = divmod(tiles, splits)
    cuts = [(i * lo + min(i, extra)) * FD_TILE for i in range(splits + 1)]
    ranges = tuple((cuts[i], min(cuts[i + 1], c)) for i in range(splits))
    most = -(-tiles // splits)
    stages = max(2, min(FD_MAX_STAGES, most + 1, FD_RING_BYTES // stage_bytes))
    return dict(tile=FD_TILE, stages=stages, stage_bytes=stage_bytes,
                layout=(off_v, off_ks, off_vs, stage_bytes), tiles=tiles,
                splits=splits, ranges=ranges, ns=ns, gchunks=gchunks,
                blocks=units * splits, rows_per_split=max(e - s for s, e in ranges))


def fd_split_rows(ranges: tuple, kv_len: int) -> tuple:
    """The rows each split of a plan's ``ranges`` streams at ``kv_len``, as
    the kernel computes them: its range cut at kv_len, empty (``(s, s)``)
    for a split that starts at or past it."""
    return tuple((s, max(s, min(e, kv_len))) for s, e in ranges)


def check_kv_len(kv_len: torch.Tensor, device: torch.device, batch: int) -> int:
    """kv_len as flash-decode takes it (any device): an int32 tensor on
    ``device``, a scalar shared by the batch, as the Pallas kernel's operand
    is, or ``[batch]`` with one length per lane.  The kernels read it from
    device memory, so its value is never read on the host (it lies in
    ``[1, C]`` on the model path by construction).  Returns the stride the
    kernel steps through it by, per batch lane: 0 for a scalar."""
    if not isinstance(kv_len, torch.Tensor) or kv_len.dtype != torch.int32:
        raise TypeError("flash_decode: kv_len must be an int32 tensor")
    if tuple(kv_len.shape) not in ((), (batch,)) or kv_len.device != device:
        raise ValueError(f"flash_decode: kv_len must be a scalar or [{batch}] on {device}, "
                         f"got shape {tuple(kv_len.shape)} on {kv_len.device}")
    return kv_len.stride(0) if kv_len.ndim else 0


def fd_alignment_width(row_bytes: int) -> int:
    """Bytes per copy of a row: the largest of 16, 8, 4, 2 dividing it."""
    return next(w for w in (16, 8, 4, 2, 1) if row_bytes % w == 0)


def check_fd_operand(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
                     side: bool = False) -> None:
    """Dtype, shape and layout of one flash-decode array (any device).

    The kernel copies rows in whole chunks with no scalar path: a value
    array needs 16-byte rows and a 16-byte aligned base; a side array (one
    int8_tok scale or a few mxint4_blk exponents per row) a base aligned to
    the width of its row's chunks, and an even number of bytes per row.
    Raises on anything else.
    """
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    row = shape[-1] * t.element_size()
    width = fd_alignment_width(row) if side else 16
    if row % width or width < 2:
        raise ValueError(f"{name}: rows of {row} bytes are not a whole number of "
                         f"{'2' if side else '16'}-byte chunks")
    if t.data_ptr() % width:
        raise ValueError(f"{name}: base must be {width}-byte aligned "
                         f"(address {t.data_ptr():#x})")


def _cache_operand(name: str, parts: tuple, fmt: str, lead: tuple, dim: int):
    """Check one cache operand ``(values, side or None)`` of format ``fmt``
    with logical shape ``lead + (dim,)``; returns the two pointers."""
    code, vdtype, sdtype = CACHE_FORMATS[fmt]
    values, side = parts
    if not values.is_cuda or (side is not None and not side.is_cuda):
        raise ValueError(f"{name}: expected CUDA tensors, got {values.device}")
    if fmt == "mxint4_blk":
        if dim % 16:
            raise ValueError(f"{name}: mxint4_blk needs a multiple of 16, got {dim}")
        check_fd_operand(f"{name}.m", values, vdtype, lead + (dim // 2,))
        check_fd_operand(f"{name}.e", side, sdtype, lead + (dim // 16,), side=True)
    elif fmt == "int8_tok":
        check_fd_operand(f"{name}.q", values, vdtype, lead + (dim,))
        check_fd_operand(f"{name}.s", side, sdtype, lead + (1,), side=True)
    else:
        check_fd_operand(name, values, vdtype, lead + (dim,))
    return code, values.data_ptr(), None if side is None else side.data_ptr()


def flash_decode(q, k_parts, k_fmt: str, v_parts, v_fmt: str, kv_len: torch.Tensor,
                 scale: float | None):
    """Decode attention of one token over the first ``kv_len`` cache rows.

    q f32 ``[B, KV, G, d]``; K and V as ``(values, side)`` pairs in the
    ``[B, C, KV, *]`` layout of a `CACHE_FORMATS` name (side is the int8_tok
    scales or the mxint4_blk exponents, else None); ``kv_len`` an int32
    scalar or ``[B]`` on the card, which the kernel reads (block (b, .)
    reads lane b's, clamped to [0, C]);
    ``scale=None`` divides the scores by sqrt(d), as the plain version does.
    Returns f32 ``[B, KV, G, dv]``.
    """
    b, kv, g, d = q.shape
    c = k_parts[0].shape[1]
    dv = v_parts[0].shape[-1] * (2 if v_fmt == "mxint4_blk" else 1)
    if not (1 <= g <= FD_MAX_GROUP and d <= FD_MAX_DIM and dv <= FD_MAX_DIM):
        raise ValueError(f"flash_decode: G={g}, d={d}, dv={dv} exceed the kernel's "
                         f"limits ({FD_MAX_GROUP}, {FD_MAX_DIM})")
    _check("q", q, torch.float32, (b, kv, g, d), align=16)
    kv_stride = check_kv_len(kv_len, q.device, b)
    kc, k0, k1 = _cache_operand("k", k_parts, k_fmt, (b, c, kv), d)
    vc, v0, v1 = _cache_operand("v", v_parts, v_fmt, (b, c, kv), dv)
    plan = flash_decode_plan(b, kv, g, d, dv, c, k_fmt, v_fmt, _sms(q.device))
    lib = _lib("flash_decode")
    splits = plan["splits"]
    out = torch.empty(b, kv, g, dv, dtype=torch.float32, device=q.device)
    units = b * kv * plan["gchunks"]
    partials = (torch.empty(units * splits * FD_GROUP * (dv + 2), dtype=torch.float32,
                            device=q.device) if splits > 1 else out)
    tickets = ticket_counters(q.device, units)
    div = scale is None
    err = lib.flash_decode_launch(
        q.data_ptr(), k0, k1, v0, v1, out.data_ptr(), partials.data_ptr(),
        tickets.data_ptr(), kv_len.data_ptr(), kv_stride, b, c, kv, g, d, dv, kc, vc,
        plan["tiles"], splits,
        plan["stages"], plan["ns"], *plan["layout"], 0.0 if div else float(scale),
        int(div), _stream())
    _raise_if(err, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return out


# Flash-decode's MLA two-stream mode (csrc/flash_decode.cu,
# `flash_decode_mla_kernel`).  A block owns MLA_HEADS query heads of one
# batch lane and an even share of the C rows' MLA_TILE-row tiles (those
# below kv_len, which it reads from device memory, are streamed); its
# products run on the tensor cores (split TF32) out of a staging tile of
# [latent | rope] rows in shared memory, and the splits of one (b, head
# group) form a thread-block cluster that merges through its shared memory.
# The launch lays out the staging rows and shared memory itself; the plan
# holds the grid and the raw stage that the copies fill.
MLA_TILE = 32
MLA_HEADS = 16                  # one m16 tile of query heads
MLA_MAX_SPLITS = 8              # the portable cluster size
# Clusters of 1..8 such blocks (one per SM) an H100 SXM holds at once
# (cudaOccupancyMaxActiveClusters; tools/mla_phase_clock.py): the planner's
# default, for the CPU; on the card `flash_decode_mla` asks the card.
MLA_RESIDENT_H100 = (132, 66, 39, 30, 22, 17, 15, 15)
MLA_MAX_LATENT = 512            # a 32-column P.V group per warp of 16
MLA_MAX_ROPE = 128


@functools.lru_cache(maxsize=None)
def flash_decode_mla_plan(b: int, h: int, r: int, dr: int, c: int, fmt: str,
                          resident: tuple = MLA_RESIDENT_H100) -> dict:
    """Grid and raw stage of one MLA-mode launch on a cache of capacity ``c``.

    The ``b * groups`` (batch lane, group of MLA_HEADS heads) units each run
    as a cluster of ``splits`` blocks, and each split owns an even share of
    the capacity's tiles (``ranges``, as the kernel computes them); at a
    given kv_len a split streams its range's rows below it (`fd_split_rows`)
    and one that starts at or past it streams nothing but still joins its
    cluster's merge.
    ``resident[s - 1]`` is how many clusters of ``s`` blocks the card holds
    at once; ``splits`` (at most MLA_MAX_SPLITS and one per tile) minimises
    the waves of clusters times the tiles of the longest split, the fewer
    splits on a tie.  On an H100 deepseek-v3's 16 units take 6 splits, 96
    blocks: the card holds 17 clusters of 6 but only 15 of 7 or 8, which
    would run a second wave.

    A raw stage (every format but f32, which lands in the kernel's f32
    staging tiles) holds a tile as it is copied: the latent values, then the
    latent side data, the rope values and the rope side data, each at a
    16-byte aligned offset (``layout``: those three offsets and the stage's
    bytes).  Raises on a shape the kernel does not take; the launch checks
    its shared memory itself.  Plans are cached; callers must not modify
    the dict.
    """
    if not (4 <= r <= MLA_MAX_LATENT and 4 <= dr <= MLA_MAX_ROPE and r % 4 == 0
            and dr % 4 == 0):
        raise ValueError(f"flash_decode (MLA): latent {r} and rope {dr} widths must be "
                         f"multiples of 4 in [4, {MLA_MAX_LATENT}] and [4, {MLA_MAX_ROPE}]")
    if fmt == "mxint4_blk" and (r % 16 or dr % 16):
        raise ValueError(f"flash_decode (MLA): mxint4_blk needs widths in whole groups "
                         f"of 16, got {r} and {dr}")
    (lb, ls), (rb, rs) = fd_row_bytes(fmt, r), fd_row_bytes(fmt, dr)
    off_ls = _up16(MLA_TILE * lb)
    off_rv = off_ls + _up16(MLA_TILE * ls)
    off_rs = off_rv + _up16(MLA_TILE * rb)
    stage_bytes = off_rs + _up16(MLA_TILE * rs)
    tiles = -(-c // MLA_TILE)
    groups = -(-h // MLA_HEADS)
    units = b * groups
    splits = min(range(1, min(MLA_MAX_SPLITS, tiles) + 1),
                 key=lambda s: (-(-units // resident[s - 1]) * -(-tiles // s), s))
    lo, extra = divmod(tiles, splits)
    cuts = [(i * lo + min(i, extra)) * MLA_TILE for i in range(splits + 1)]
    ranges = tuple((cuts[i], min(cuts[i + 1], c)) for i in range(splits))
    return dict(tile=MLA_TILE, tiles=tiles, splits=splits, ranges=ranges, groups=groups,
                blocks=units * splits, layout=(off_ls, off_rv, off_rs, stage_bytes))


def _mla_operand(name: str, parts: tuple, fmt: str, lead: tuple, dim: int):
    """Check one MLA cache stream ``(values, side or None)`` of format ``fmt``
    with logical shape ``lead + (dim,)``: contiguous, each array's base
    aligned to its copy width (`fd_alignment_width` of its rows: the kernel
    copies a tile's rows as one flat run).  Returns the two pointers (side:
    0 if none)."""
    _, vdtype, sdtype = CACHE_FORMATS[fmt]
    values, side = parts
    shapes = {"int8_tok": (dim, 1), "mxint4_blk": (dim // 2, dim // 16)}.get(fmt, (dim, None))
    ptrs = []
    for tag, t, dtype, width in ((".values", values, vdtype, shapes[0]),
                                 (".side", side, sdtype, shapes[1])):
        if width is None:
            ptrs.append(0)
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}{tag}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != lead + (width,):
            raise ValueError(f"{name}{tag}: expected shape {lead + (width,)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}{tag}: must be contiguous")
        align = fd_alignment_width(width * t.element_size())
        if t.data_ptr() % align:
            raise ValueError(f"{name}{tag}: base must be {align}-byte aligned "
                             f"(address {t.data_ptr():#x})")
        ptrs.append(t.data_ptr())
    return ptrs


def _mla_resident(device: torch.device) -> tuple:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    return _mla_resident_on(idx)


@functools.lru_cache(maxsize=None)
def _mla_resident_on(index: int) -> tuple:
    """Clusters of 1..MLA_MAX_SPLITS MLA-mode blocks card ``index`` holds at
    once, at the most shared memory a launch may take (FD_SMEM_BYTES), asked
    once per card."""
    lib = _lib("flash_decode")
    with torch.cuda.device(index):
        got = tuple(lib.flash_decode_mla_max_clusters(s, FD_SMEM_BYTES)
                    for s in range(1, MLA_MAX_SPLITS + 1))
    if min(got) < 1:
        raise RuntimeError(f"flash_decode (MLA): cluster occupancy query failed: {got}")
    return got


def flash_decode_mla(q, q2, lat_parts, rope_parts, fmt: str, kv_len: torch.Tensor,
                     scale: float):
    """MLA decode attention of one token over the first ``kv_len`` rows.

    q f32 ``[B, H, r]`` (absorbed latent queries), q2 f32 ``[B, H, dr]``
    (rope queries); the latent cache, which is both K and V, and the rope
    cache as ``(values, side)`` pairs in the ``[B, C, *]`` layout of one
    `CACHE_FORMATS` name; ``kv_len`` an int32 scalar or ``[B]`` on the card,
    which the kernel reads (lane b's for lane b, clamped to [0, C]).  ``s = (q . L + q2 . R) * scale``.
    Returns f32 ``[B, H, r]``.
    """
    b, h, r = q.shape
    dr = q2.shape[-1]
    c = lat_parts[0].shape[1]
    _check("q", q, torch.float32, (b, h, r), align=16)
    _check("q2", q2, torch.float32, (b, h, dr), align=16)
    kv_stride = check_kv_len(kv_len, q.device, b)
    plan = flash_decode_mla_plan(b, h, r, dr, c, fmt, _mla_resident(q.device))
    l0, l1 = _mla_operand("latent", lat_parts, fmt, (b, c), r)
    r0, r1 = _mla_operand("rope", rope_parts, fmt, (b, c), dr)
    lib = _lib("flash_decode")
    out = torch.empty(b, h, r, dtype=torch.float32, device=q.device)
    err = lib.flash_decode_mla_launch(
        q.data_ptr(), q2.data_ptr(), l0, l1, r0, r1, out.data_ptr(), kv_len.data_ptr(),
        kv_stride, b, c, h, r, dr, CACHE_FORMATS[fmt][0], plan["tiles"], plan["splits"], *plan["layout"],
        float(scale), _stream())
    _raise_if(err, "flash_decode (MLA)")
    LAUNCHES["flash_decode_mla"] += 1
    return out


# rmsnorm_stats (csrc/rmsnorm_stats.cu).  A row is read in `chunks` loads
# of `width` bytes by `tpr` threads, each of which issues its `loads` loads
# of a round before it adds any.
RMS_BLOCK_THREADS = 256         # threads a block aims at: 128 and 512 within 1 % (PERF.md)
RMS_MAX_THREADS = 1024
RMS_MAX_LOADS = 2               # loads per thread (the kernel builds 1 and 2): 32
                                # bytes in flight at width 16, level with 4 (PERF.md)
RMS_THREADS_PER_SM = 2048       # the kernel caps registers so that this many fit


def rms_width(addr: int, stride_bytes: int, elem_bytes: int) -> int:
    """Bytes per load: the largest of 16, 8, 4, 2 that holds whole elements
    and divides both the base address and the row stride."""
    return next(w for w in (16, 8, 4, 2) if w == elem_bytes
                or (w > elem_bytes and addr % w == 0 and stride_bytes % w == 0))


def _rms_tpr(chunks: int, loads: int) -> int:
    """Threads per row for ``loads`` loads each: a power of two up to 32
    (a row's lanes add by shuffles), else a multiple of 32 up to
    RMS_MAX_THREADS (more rounds beyond)."""
    tpr = max(1, -(-chunks // loads))
    tpr = 1 << (tpr - 1).bit_length() if tpr <= 32 else 32 * -(-tpr // 32)
    return min(tpr, RMS_MAX_THREADS)


@functools.lru_cache(maxsize=None)
def rmsnorm_stats_plan(m: int, d: int, elem_bytes: int, sms: int = 132,
                       width: int = 16) -> dict:
    """Row split and grid of one rmsnorm_stats launch on ``[m, d]`` rows of
    ``elem_bytes`` elements read ``width`` bytes at a time; the launch takes
    it as it is and checks it.

    A row is ``chunks`` whole loads and ``tail`` elements past them.  Each
    of a row's ``tpr`` threads issues its ``loads`` loads of a round
    (RMS_MAX_LOADS, or 1 for a row of one load) before it adds any, and
    ``tpr`` is as many as cover the row in one round (``rounds`` more only
    past RMS_MAX_THREADS); ``rows`` rows share a block of about
    RMS_BLOCK_THREADS.  Few rows (fewer blocks than ``sms``) take fewer
    rows per block, down to one, and then, while the card has fewer than
    RMS_BLOCK_THREADS threads per SM to issue loads, one load per thread
    over twice the threads (a decode pair of rows spreads each row over
    512).  ``resident`` is the blocks an SM holds (RMS_THREADS_PER_SM
    threads: the kernel caps its registers so that all fit) and ``waves``
    the grid of ``blocks`` over ``sms * resident``.  Raises on a shape the
    kernel does not take.  Plans are cached; callers must not modify the
    dict.
    """
    if m < 1 or d < 1 or elem_bytes not in (2, 4) or width not in (2, 4, 8, 16) \
            or width < elem_bytes:
        raise ValueError(f"rmsnorm_stats: no plan for [{m}, {d}] x {elem_bytes} bytes "
                         f"at width {width}")
    per = width // elem_bytes
    chunks = d // per
    n = 1 if chunks <= 1 else RMS_MAX_LOADS
    tpr = _rms_tpr(chunks, n)
    rows = max(1, RMS_BLOCK_THREADS // tpr)
    while rows > 1 and -(-m // rows) < sms:
        rows //= 2
    if (n > 1 and m * tpr < sms * RMS_BLOCK_THREADS
            and tpr < _rms_tpr(chunks, 1) <= RMS_MAX_THREADS // rows):
        n = 1
        tpr = _rms_tpr(chunks, n)
    threads = tpr * rows
    blocks = -(-m // rows)
    resident = min(32, RMS_THREADS_PER_SM // threads)
    return dict(width=width, chunks=chunks, tail=d - chunks * per, loads=n,
                rounds=-(-chunks // (tpr * n)), tpr=tpr, rows=rows, threads=threads,
                blocks=blocks, resident=resident, waves=-(-blocks // (sms * resident)))


def rmsnorm_stats(y, eps: float):
    """sigma^{-1} = rsqrt(mean(y^2) + eps) per row of f32 or bf16 ``[M, D]``
    -> f32 ``[M, 1]``.

    The rows may lie any stride apart (a view is read in place); the
    elements of a row must be adjacent.  The launch follows
    `rmsnorm_stats_plan` of this shape, alignment and card.
    """
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rmsnorm_stats: expected float32 or bfloat16, got {y.dtype}")
    if not y.is_cuda:
        raise ValueError(f"rmsnorm_stats: expected a CUDA tensor, got {y.device}")
    if y.dim() != 2 or min(y.shape) < 1:
        raise ValueError(f"rmsnorm_stats: expected non-empty [M, D], got {tuple(y.shape)}")
    m, d = y.shape
    if d > 1 and y.stride(1) != 1:
        raise ValueError(f"rmsnorm_stats: a row's elements must be adjacent, got strides "
                         f"{tuple(y.stride())}")
    elem = y.element_size()
    stride = (y.stride(0) if m > 1 else d) * elem
    plan = rmsnorm_stats_plan(m, d, elem, _sms(y.device), rms_width(y.data_ptr(), stride, elem))
    lib = _lib("rmsnorm_stats")
    out = torch.empty(m, 1, dtype=torch.float32, device=y.device)
    err = lib.rmsnorm_stats_launch(
        y.data_ptr(), out.data_ptr(), m, d, stride, int(y.dtype == torch.bfloat16),
        *(plan[k] for k in ("width", "chunks", "tail", "rounds", "tpr", "loads", "rows",
                            "blocks")), float(eps), _stream())
    _raise_if(err, "rmsnorm_stats")
    LAUNCHES["rmsnorm_stats"] += 1
    return out
