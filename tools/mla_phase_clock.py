#!/usr/bin/env python3
"""Where a launch of flash-decode's MLA mode spends its time, on one NVIDIA
card; one tree per process, so that two trees can be timed in turns.

    python3 tools/mla_phase_clock.py [--tree DIR] [--reps 15]
        [--kv-lens 1,32,64,256,528] [--no-phases | --serving]

``--tree`` is the checkout whose ``repro_torch`` is measured (by default
this one); it builds into that tree's own build directory.  For example,
the parent commit unpacked under ``build/`` against this tree, in turns:

    for t in build/parent . . build/parent; do
        python3 tools/mla_phase_clock.py --tree $t --no-phases; done

The tree must take kv_len as an int32 tensor on the card and plan by the
capacity (the interface since the fused decode loop).

At deepseek-v3's decode shape (B 2, H 128, latent 512, rope 64, C 544) in
the f32, int8_tok and mxint4_blk cache formats, the L2 flushed before every
launch as ``chip_smoke.py`` does:

1. the kernel as the tree's library builds it, captured in a CUDA graph and
   replayed between CUDA events (median of ``--reps``, as ``chip_smoke.py``'s
   `time_ms`), at each of ``--kv-lens``: one tile (1, 32), a few tiles over
   several splits (64, 256: the cluster merge runs) and the main path's 528;
2. unless ``--no-phases`` (this tree only: the stamps are its kernel's), a
   build of ``csrc/flash_decode.cu`` with ``-DFD_PHASE_CLOCK``, in which
   thread 0 of every block stamps ``clock64`` at entry, loop end, after the
   cluster barrier, after the merge and at exit, and sums its loop's cycles
   waiting for copies (the first wait includes the prologue), dequantizing
   (encoded formats), in the scores (with the barrier after their partial
   sums), in the softmax and in P.V.

Prints one JSON line per (format, kv_len), times in microseconds, with the
card's name and power limit: the replayed device time and, with phases, the
launch's span (global timer, first entry to last exit) and the median
block's phases at the SM clock the two timers give; then, with phases, one
line with how many clusters of 1 to 8 blocks the card holds at once at the
most shared memory a launch may take (``cudaOccupancyMaxActiveClusters``, as
the planner asks it), and one with the ceiling the kernel's products run against: the throughput
of mma.sync m16n8k8 TF32 alone (csrc/tf32.cuh's product), one block per SM
of 4, 8 or 16 warps each issuing 8 independent accumulating products per
step for 4096 steps, in TFLOP/s and in cycles per product per SM
sub-partition (block 0's clock64 around its loop).

``--serving`` measures the mode end to end instead, with this checkout's
``chip_smoke.py`` loaded after the tree's ``repro_torch`` (so two trees are
measured alike): ds3_dense, deepseek-v3 cut to its 3 leading dense layers,
on ``chip_smoke.py``'s weights and prompts (B 2, 512-token prompts, 32
greedy tokens), one line per cache format with ``prefill_ms`` and
``decode_ms_per_token`` (medians of 5 ``InferenceEngine.generate`` calls
after a warm-up, every run's values beside them) and, against the plain
path on the same weights, ``greedy_token_agreement`` and
``chip_smoke.free_running``'s record of where the two paths' free-running
tokens and appended cache rows first part.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

STAMPS = 13
RATE_SOURCE = r"""
#include <cuda_runtime.h>
#include "tf32.cuh"
__global__ void rate(float* out, long long* clk, int steps) {
  const long long c0 = clock64();
  uint32_t a[4], b[2] = {__float_as_uint(0.5f), __float_as_uint(0.25f)};
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  float acc[8][4] = {};
  for (int s = 0; s < steps; ++s)
#pragma unroll
    for (int c = 0; c < 8; ++c) mma_tf32(acc[c], a, b);
  float t = 0.f;
  for (int c = 0; c < 8; ++c)
    for (int k = 0; k < 4; ++k) t += acc[c][k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
  if (blockIdx.x == 0 && threadIdx.x == 0) *clk = clock64() - c0;
}
extern "C" int run(int blocks, int threads, int steps, float* out, long long* clk,
                   float* ms) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    rate<<<blocks, threads>>>(out, clk, steps);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
  }
  cudaEventElapsedTime(ms, e0, e1);
  return (int)cudaGetLastError();
}
"""
PHASES = ("wait", "dequant", "scores", "softmax", "pv")
B, H, R, DR, C = 2, 128, 512, 64, 544
SCALE = 1.0 / 192 ** 0.5


def build_clocked(hopper) -> ctypes.CDLL:
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


def mma_rate(torch, hopper) -> list:
    """mma.sync m16n8k8 TF32 throughput at 4, 8 and 16 warps per SM."""
    out_dir = hopper.build_dir() / "mma_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "rate.cu").write_text(RATE_SOURCE)
    lib_path = out_dir / "rate.so"
    subprocess.run([hopper._nvcc(), *hopper.NVCC_FLAGS, "-I", str(hopper.CSRC), "-o",
                    str(lib_path), str(out_dir / "rate.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    steps, rows = 4096, []
    out = torch.empty(sms * 512, device="cuda")
    clk = torch.zeros(1, dtype=torch.int64, device="cuda")
    for threads in (128, 256, 512):
        ms = ctypes.c_float()
        err = lib.run(sms, threads, steps, ctypes.c_void_p(out.data_ptr()),
                      ctypes.c_void_p(clk.data_ptr()), ctypes.byref(ms))
        if err:
            raise RuntimeError(f"mma rate launch failed: cudaError {err}")
        rows.append(dict(warps_per_sm=threads // 32, ms=ms.value,
                         tflops=steps * 8 * threads // 32 * sms * 2048 / (ms.value * 1e-3) / 1e12,
                         cycles_per_mma_per_subpartition=clk.item() / (steps * 8 * threads / 128)))
    return rows


def device_us(torch, fn, flush, reps: int) -> float:
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


def phases(st) -> tuple[dict, float, float]:
    """One launch's stamps ``[blocks, STAMPS]`` -> the median block's phases
    in cycles, the span in ns, and SM cycles per ns."""
    clk = st[:, :5]
    sums = st[:, 5:10]
    ns0, ns1 = st[:, 11], st[:, 12]
    merged = bool((clk[:, 2] != 0).any())
    med = lambda col: statistics.median(col.tolist())  # noqa: E731
    out = dict(loop=med(clk[:, 1] - clk[:, 0]), tiles=med(st[:, 10]))
    out.update({name: med(sums[:, i]) for i, name in enumerate(PHASES)})
    if merged:
        out.update(cluster_wait=med(clk[:, 2] - clk[:, 1]), merge=med(clk[:, 3] - clk[:, 2]),
                   exit_wait=med(clk[:, 4] - clk[:, 3]))
    else:
        out.update(write=med(clk[:, 4] - clk[:, 1]))
    out["total"] = med(clk[:, 4] - clk[:, 0])
    ghz = (clk[:, 4] - clk[:, 0]).sum().item() / (ns1 - ns0).sum().item()
    return out, (ns1.max() - ns0.min()).item(), ghz


def serving(torch, base: dict) -> None:
    """ds3_dense serving lines (``--serving``)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    eng = cs.InferenceEngine.from_config(cs.DS3["cfg"], cs.EngineSpec(), device="cuda")
    plain = cs.InferenceEngine(eng.cfg, eng.model, cs.EngineSpec(kernel_impl="ref"))
    prompts = torch.randint(1, eng.cfg.vocab_size, (cs.BATCH, cs.PROMPT),
                            generator=cs._gen(1), device="cuda")
    for fmt in cs.DS3["formats"]:
        gen = cs.GenerationConfig(max_new_tokens=cs.NEW, cache_format=fmt)
        eng.generate(prompts, gen)
        timed = [eng.generate(prompts, gen) for _ in range(5)]
        pre = [r.prefill_s * 1e3 for r in timed]
        dec = [r.decode_s * 1e3 / r.decode_steps for r in timed]
        res_k, res_p, drift = cs.free_running(eng, plain, prompts, gen)
        toks = timed[0].tokens
        drift["kernel_tokens_as_timed"] = bool((res_k.tokens == toks).all())
        print(json.dumps(dict(
            base, format=fmt or "f32", prefill_ms=statistics.median(pre),
            decode_ms_per_token=statistics.median(dec), prefill_ms_runs=pre,
            decode_ms_per_token_runs=dec,
            greedy_token_agreement=(res_p.tokens == toks).float().mean().item(),
            free_running=drift)), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--kv-lens", default="1,32,64,256,528")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--no-phases", action="store_true")
    mode.add_argument("--serving", action="store_true")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    this = tree == ROOT
    if not this and not (args.no_phases or args.serving):
        print("mla_phase_clock: phases need this tree (pass --no-phases or --serving)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree / "src"))
    import torch
    if not torch.cuda.is_available():
        print("mla_phase_clock: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import kvq
    from repro_torch.kernels import hopper, ops
    if os.path.commonpath([hopper.__file__, str(tree)]) != str(tree):
        raise RuntimeError(f"imported {hopper.__file__}, not the tree's")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    base = dict(tree=os.path.relpath(tree, ROOT), card=card)
    if args.serving:
        serving(torch, base)
        return 0
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
        kv_len = torch.tensor(n, dtype=torch.int32, device="cuda")
        return ops.flash_decode(q, lat, lat, kv_len, q2=q2, k2=rope, scale=SCALE,
                                impl="kernel")

    def plan(fmt, n):
        p = hopper.flash_decode_mla_plan(B, H, R, DR, C, fmt, hopper._mla_resident(q.device))
        return dict(splits=p["splits"], blocks=p["blocks"])

    device = {(fmt, n): device_us(torch, lambda: run(fmt, n), flush, args.reps)
              for fmt in caches for n in lens}
    if args.no_phases:
        for (fmt, n), us in device.items():
            print(json.dumps(dict(base, format=fmt, kv_len=n, device_us=us, **plan(fmt, n))),
                  flush=True)
        return 0
    lib = build_clocked(hopper)
    for fmt in caches:
        for n in lens:
            blocks = plan(fmt, n)["blocks"]
            stamps = torch.zeros(blocks, STAMPS, dtype=torch.int64, device="cuda")
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
                base, format=fmt, kv_len=n, device_us=device[(fmt, n)],
                span_us=statistics.median(spans) / 1e3, sm_clock_ghz=rate / 1e3,
                median_block_us=block, **plan(fmt, n))), flush=True)
    print(json.dumps(dict(base, max_active_clusters=hopper._mla_resident(q.device),
                          smem_bytes=hopper.FD_SMEM_BYTES)), flush=True)
    print(json.dumps(dict(base, mma_tf32_rate=mma_rate(torch, hopper))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
