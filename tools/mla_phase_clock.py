#!/usr/bin/env python3
"""Where a launch of flash-decode's MLA mode spends its time, on one NVIDIA
card.

    python3 tools/mla_phase_clock.py [--reps 15] [--kv-lens 1,32,64,256,528]

Two parts, at deepseek-v3's decode shape (B 2, H 128, latent 512, rope 64,
C 544) in the f32, int8_tok and mxint4_blk cache formats, the L2 flushed
before every launch as ``chip_smoke.py`` does:

1. the kernel as the library builds it, captured in a CUDA graph and
   replayed between CUDA events (median of ``--reps``, as ``chip_smoke.py``'s
   `time_ms`), at each of ``--kv-lens``: one tile (1, 32), a few tiles over
   several splits (64, 256: the cluster merge runs) and the main path's 528;
2. a build of ``csrc/flash_decode.cu`` with ``-DFD_PHASE_CLOCK``, in which
   thread 0 of every block stamps ``clock64`` at entry, loop end, after the
   cluster barrier, after the merge and at exit, and sums its loop's cycles
   waiting for tiles (the first wait includes the prologue), in scores, in
   the softmax and in P.V.

Prints one JSON line per (format, kv_len), times in microseconds: the
replayed device time, the launch's span (global timer, first entry to last exit), and the
median block's phases at the SM clock the two timers give; then one line
with how many clusters of 1 to 8 blocks the card holds at once at
the f32 and mxint4_blk plans' shared memory
(``cudaOccupancyMaxActiveClusters``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core import kvq  # noqa: E402
from repro_torch.kernels import hopper, ops  # noqa: E402

STAMPS = 12
B, H, R, DR, C = 2, 128, 512, 64, 544
SCALE = 1.0 / 192 ** 0.5


def build_clocked() -> ctypes.CDLL:
    """The phase-stamping library, bound and put where `hopper` looks."""
    out = hopper.build_dir() / "phase_clock"
    out.mkdir(parents=True, exist_ok=True)
    target = out / "flash_decode_mla.so"
    flags = hopper.COMPILE_FLAGS.get("flash_decode", ()) + ("-DFD_PHASE_CLOCK",)
    proc = subprocess.run(hopper.nvcc_command("flash_decode", target, flags),
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"phase-clock build failed:\n{proc.stdout}")
    lib = ctypes.CDLL(str(target))
    hopper._bind("flash_decode", lib)
    lib.flash_decode_mla_set_stamps.argtypes = [ctypes.c_void_p]
    lib.flash_decode_mla_set_stamps.restype = None
    hopper._LIBS["flash_decode"] = lib
    return lib


def device_us(fn, flush, reps: int) -> float:
    """Median device time of ``fn`` replayed from a CUDA graph, L2 flushed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) * 1e3)
    return statistics.median(times)


def phases(st: torch.Tensor) -> tuple[dict, float, float]:
    """One launch's stamps ``[blocks, STAMPS]`` -> the median block's phases
    in cycles, the span in ns, and SM cycles per ns."""
    clk = st[:, :5]
    sums = st[:, 5:9]
    ns0, ns1 = st[:, 10], st[:, 11]
    merged = bool((clk[:, 2] != 0).any())
    med = lambda col: statistics.median(col.tolist())  # noqa: E731
    out = dict(loop=med(clk[:, 1] - clk[:, 0]), wait=med(sums[:, 0]),
               scores=med(sums[:, 1]), softmax=med(sums[:, 2]), pv=med(sums[:, 3]),
               tiles=med(st[:, 9]))
    if merged:
        out.update(cluster_wait=med(clk[:, 2] - clk[:, 1]), merge=med(clk[:, 3] - clk[:, 2]),
                   exit_wait=med(clk[:, 4] - clk[:, 3]))
    else:
        out.update(write=med(clk[:, 4] - clk[:, 1]))
    out["total"] = med(clk[:, 4] - clk[:, 0])
    ghz = (clk[:, 4] - clk[:, 0]).sum().item() / (ns1 - ns0).sum().item()
    return out, (ns1.max() - ns0.min()).item(), ghz


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--kv-lens", default="1,32,64,256,528")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mla_phase_clock: no CUDA device", file=sys.stderr)
        return 2
    lens = [int(x) for x in args.kv_lens.split(",")]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    q = torch.randn(B, H, R, generator=gen, device="cuda") * 0.5
    q2 = torch.randn(B, H, DR, generator=gen, device="cuda")
    lat32 = torch.randn(B, C, R, generator=gen, device="cuda")
    rope32 = torch.randn(B, C, DR, generator=gen, device="cuda")
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    caches = {fmt: (lat32, rope32) if fmt == "f32" else
              (kvq.encode(lat32, fmt), kvq.encode(rope32, fmt))
              for fmt in ("f32", "int8_tok", "mxint4_blk")}

    def run(fmt, n):
        lat, rope = caches[fmt]
        return ops.flash_decode(q, lat, lat, n, q2=q2, k2=rope, scale=SCALE, impl="kernel")

    device = {(fmt, n): device_us(lambda: run(fmt, n), flush, args.reps)
              for fmt in caches for n in lens}
    lib = build_clocked()
    for fmt in caches:
        for n in lens:
            plan = hopper.flash_decode_mla_plan(B, H, R, DR, n, fmt,
                                                hopper._mla_resident(q.device))
            stamps = torch.zeros(plan["blocks"], STAMPS, dtype=torch.int64, device="cuda")
            lib.flash_decode_mla_set_stamps(stamps.data_ptr())
            rows, spans, ghz = [], [], []
            for _ in range(args.reps):
                stamps.zero_()
                flush.zero_()
                run(fmt, n)
                torch.cuda.synchronize()
                ph, span, g = phases(stamps.cpu())
                rows.append(ph)
                spans.append(span)
                ghz.append(g)
            rate = statistics.median(ghz) * 1e3           # cycles per microsecond
            block = {k: statistics.median(r[k] for r in rows) / (1 if k == "tiles" else rate)
                     for k in rows[0]}
            print(json.dumps(dict(
                format=fmt, kv_len=n, device_us=device[(fmt, n)],
                span_us=statistics.median(spans) / 1e3, sm_clock_ghz=rate / 1e3,
                median_block_us=block, splits=plan["splits"], blocks=plan["blocks"])),
                flush=True)
    smem = {fmt: hopper.flash_decode_mla_plan(B, H, R, DR, 528, fmt)["smem_bytes"]
            for fmt in ("f32", "mxint4_blk")}
    print(json.dumps({"max_active_clusters": {
        fmt: {n: lib.flash_decode_mla_max_clusters(n, size) for n in range(1, 9)}
        for fmt, size in smem.items()}, "smem_bytes": smem}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
