#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: kernels, then serving.

    python3 chip_smoke.py

Phases, each fatal on a miss (no CPU fallback, nonzero exit):

1. the card's name and power limit (``nvidia-smi``);
2. build every Hopper kernel from ``src/repro_torch/kernels/csrc`` (nvcc,
   one process per source, in parallel), with each kernel's
   registers, shared memory and spills from ``-Xptxas -v``;
3. each kernel at the main paths' full-width shapes against its plain
   PyTorch version on the same inputs, with its tolerance; times (CUDA events,
   L2 flushed before every launch, median), the bound from the card's data
   sheet and, where one PyTorch call computes the same function, its time
   (W8A8: ``torch._int_mm`` on the K-major weight the kernel reads, and on a
   row-major copy; flash-decode: ``scaled_dot_product_attention`` with
   ``enable_gqa`` on the f32 cache's views, and on K/V expanded to every
   query head; flash-decode's MLA mode: the same call on the concatenated
   latent and rope streams), each relaunch bit-equal to the first;
   flash-decode (both modes, every format) also with a per-lane kv_len
   (`LANE_KV_LENS`: [1, 528], [528, 300]) against the plain version, timed
   at the second (``per_lane_ms``), and an all-equal one bit-equal to the
   scalar;
   retention on the model's strided views and the MLA mode, each bound by
   its split-TF32 instruction mix (the f32 CUDA-core bound beside it), with
   a profiler check that one call runs only its own launches (retention
   two, the MLA mode and rmsnorm_stats one); rmsnorm_stats at the sigma^-1
   shapes the served models normalise (`RMS_SHAPES`), also against float64,
   timed one call per replay and 8 calls on 8 inputs per replay
   (`amortised_ms`), beside
   ``torch.linalg.vector_norm`` as the nearest library reduction, and the
   price of the port's sigma^-1 chain of PyTorch kernels
   (`sigma_chain_price`);
4. the three main paths at full width, each through
   ``InferenceEngine.generate`` with the launch counters set to 0 just before
   and read just after, 2 prompts of 512 tokens plus 32 greedy tokens (each
   decode step a replay of one captured CUDA graph, its launches counted per
   replay; the capture's seconds logged), and the eager loop
   (``decode_step`` in a Python loop) in turns with it, whose tokens,
   lengths and final cache must match the graph's bit for bit:
   retnet-1.3b (24 layers, d_model 2048), qwen3-8b (36 layers, d_model
   4096, vocab 151936) with its f32, int8_tok and mxint4_blk KV caches, and
   ds3_dense, deepseek-v3-671b cut to its 3 leading dense layers (d_model
   7168, 128 MLA heads, kv_lora 512, vocab 129280) with the same three
   latent-cache formats, all from seeded random weights in the default
   W8A8/MXINT4 deployment; then the
   same weights on the plain path (``kernel_impl="ref"``): every block in
   lockstep, prefill logits beside the network's own sensitivity, every
   decode step's logits (see `compare_paths`), and, free-running, where the
   two paths' greedy tokens and appended cache rows first part (recorded,
   see `free_running`); one top-k and one top-p generate through the graph
   (retnet-1.3b), each token in its step's top k or nucleus, repeated with
   its seed;
5. after phase 4 on each path, the admission paths (`serve_admission`), once
   per cache format of the chunked admission: 2 prompts of 500 tokens in
   chunks of 32 (15 x 32 + 16 + 4: retention from a warm state at chunks
   32, 16 and 4; W8A8 at M = 64, 32 and 8, and MLA's per-chunk
   re-expansion of the whole latent) against the plain path block by
   block in lockstep; the counted run (chunked prefill, then
   ``resume_generate`` of 32 greedy tokens through the graph, launches
   exact) and the eager loop from the same cache, bit for bit, and the
   same resume in two halves of 16; monolithic (500 = 3 x 128 + 116) and
   bucketed prefill's launches exact; chunked and
   bucketed (500 -> 512) against monolithic prefill, recorded; the three
   prefills timed in turns;
6. after phase 5 on each path, the scheduler (`serve_scheduler`): a
   `RequestScheduler` drain of 6 mixed-length requests through two slot
   classes of 2 lanes (C 48 and 80, chunks of 16; on the dense paths the
   lanes' per-lane kv_len goes through flash-decode), each class step's
   launches per replay exact (169 MXINT4 on retnet), one replay against the
   eager class step mid-drain (tokens and every store tensor bit for bit),
   the drain's decode launches exactly its replays'; on retnet-1.3b then
   the `goodput_under_load` leg of the reference's serving bench through
   the port's `ServingFrontend` (`goodput_leg`: 8 requests, prompts 6-24,
   8 new tokens, 2 lanes, chunks of 8; closed-loop calibration, Poisson
   arrivals at 0.5, 1.5 and 4.0 x its rate, the front end against a
   direct run() token for token) and an oversubscribed host-spill run
   (`host_spill_run`: a spill/fetch round trip bit for bit, a preempted
   request token-identical to an unpreempted drain); goodput, TTFT and
   inter-token p50/p99 (also while a chunk ran), decode-stall steps,
   capture seconds, spill/fetch bytes and ms;
7. each model reduced, on the card against the CPU plain path, and the
   serve CLI (``python -m repro_torch.launch.serve``) at full width on
   retnet-1.3b as subprocesses: greedy and top-p generate, the scheduler,
   the front end on virtual time, and the oversubscribed host-spill
   scheduler with its trace and metrics;
8. one JSON line ``{"kernels": [...]}`` (``scheduler_launches_by_path``
   beside ``launches``) and, last, the ``{"ok": true, ...}`` line.

It imports neither jax nor the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import fused_rmsnorm as fr  # noqa: E402
from repro_torch.core import kvq  # noqa: E402
from repro_torch.core import mxint4 as mx  # noqa: E402
from repro_torch.core import retention as ret  # noqa: E402
from repro_torch.kernels import hopper, ops, ref  # noqa: E402
from repro_torch.models import deploy, layers, lm  # noqa: E402
from repro_torch.serving import engine as serving_engine  # noqa: E402
from repro_torch.serving.engine import (EngineSpec, GenerationResult,  # noqa: E402
                                        InferenceEngine, bucket_length, chunk_schedule)
from repro_torch.serving.sampling import (GenerationConfig, SamplingParams,  # noqa: E402
                                          _top_p_mask, sample)

# Data-sheet peaks (NVIDIA, dense): bytes/s of device memory, and operations/s
# for int8 and TF32 on the tensor cores and for f32 on the CUDA cores.
PEAKS = {
    "H100 SXM": dict(bytes=3.35e12, int8=1979e12, tf32=495e12, f32=67e12),
    "H100 PCIe": dict(bytes=2.0e12, int8=1513e12, tf32=378e12, f32=51e12),
    "H200": dict(bytes=4.8e12, int8=1979e12, tf32=495e12, f32=67e12),
}
SRC = {
    "mxint4_matmul": ("src/repro_torch/kernels/csrc/mxint4_matmul.cu",
                      "src/repro/kernels/mxint4_matmul.py:77"),
    "w8a8_matmul": ("src/repro_torch/kernels/csrc/w8a8_matmul.cu",
                    "src/repro/kernels/w8a8_matmul.py:52"),
    "retention_chunkwise": ("src/repro_torch/kernels/csrc/retention_chunkwise.cu",
                            "src/repro/kernels/retention_kernel.py:70"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:142"),
    "flash_decode_mla": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:108"),
    "rmsnorm_stats": ("src/repro_torch/kernels/csrc/rmsnorm_stats.cu",
                      "src/repro/kernels/rmsnorm_stats.py:38"),
}
# The full-width main paths: per layer (K, N, linears of that shape) run in
# both phases, and those run in prefill only (MLA's wk_b / wv_b, whose masters
# decode absorbs); ``cfg`` builds the model, ``reduced`` its CPU-scale twin.
RETNET = dict(arch="retnet-1.3b", layers=24, d=2048, vocab=32768, formats=(None,),
              linears=((2048, 2048, 2), (2048, 4096, 3), (4096, 2048, 2)),
              prefill_linears=())
QWEN3 = dict(arch="qwen3-8b", layers=36, d=4096, vocab=152064, kv=8, g=4, hd=128,
             formats=(None, "int8_tok", "mxint4_blk"),
             linears=((4096, 4096, 2), (4096, 1024, 2), (4096, 12288, 2),
                      (12288, 4096, 1)),
             prefill_linears=())
_DS3 = configs.get_config("deepseek-v3-671b")
DS3 = dict(arch="ds3_dense", layers=3, d=7168, vocab=129280, heads=128, r=512, dr=64,
           formats=(None, "int8_tok", "mxint4_blk"),
           cfg=dataclasses.replace(_DS3, n_layers=_DS3.first_dense_layers),
           reduced=dataclasses.replace(_DS3.reduced(), n_layers=_DS3.first_dense_layers),
           linears=((7168, 1536, 1), (1536, 24576, 1), (7168, 576, 1), (16384, 7168, 1),
                    (7168, 18432, 2), (18432, 7168, 1)),
           prefill_linears=((512, 16384, 2),))
PATHS = (RETNET, QWEN3, DS3)
BATCH, PROMPT, NEW = 2, 512, 32
CACHE_LEN = PROMPT + NEW           # KV slots of a generate: 544
DECODE_KV_LEN = CACHE_LEN - 16     # kv_len at which flash-decode is timed
# and those it is checked at (a device scalar, as the main path passes it;
# at 1 to 17 most splits of the capacity's plan stream nothing)
DECODE_CHECK_LENS = (1, 16, 17, 257, CACHE_LEN - 1, CACHE_LEN)
# Kernel path vs plain path, relative to max|value| (see `compare_paths`).
BLOCK_TOL = 2e-2         # prefill block, same input: an int8 rounding step
DECODE_BLOCK_TOL = 1e-3  # decode block, same input: f32 summation order only
PREFILL_TOL = 0.5        # end to end; the plain path's own one-bf16-step
                         # sensitivity measured 0.26 on an H100 (PERF.md)
DECODE_TOL = 0.1         # one decode step end to end from the same cache
LOGIT_TOL = 2e-2         # reduced model, card kernels vs CPU plain path
# rmsnorm_stats where the served models take sigma^-1: (M, D, dtype, site),
# the dtype being the one the site passes (ln1/ln2 see the bf16 residual
# stream, q_norm and the per-head norms an f32 linear output), the other
# dtype beside it, the decode pair, a 16k-token prompt and a ragged M.
RMS_SHAPES = (
    (1024, 4096, torch.bfloat16, "qwen3-8b ln1/ln2, prefill B 2 x S 512"),
    (1024, 4096, torch.float32, "qwen3-8b ln1/ln2 in f32"),
    (1024, 2048, torch.bfloat16, "retnet-1.3b ln1/ln2, prefill"),
    (1024, 2048, torch.float32, "retnet-1.3b ln1/ln2 in f32"),
    (1024, 7168, torch.bfloat16, "ds3_dense ln1/ln2, prefill"),
    (1024, 7168, torch.float32, "ds3_dense ln1/ln2 in f32"),
    (1024, 1536, torch.float32, "ds3_dense q_norm on q_lat, prefill"),
    (1024, 1536, torch.bfloat16, "ds3_dense q_norm in bf16"),
    (32768, 128, torch.float32, "qwen3-8b per-head q norm, prefill"),
    (32768, 128, torch.bfloat16, "qwen3-8b per-head q norm in bf16"),
    (2, 4096, torch.bfloat16, "qwen3-8b ln1/ln2, decode"),
    (16384, 4096, torch.bfloat16, "a 16k-token prompt (2.7x the L2)"),
    (1000, 4096, torch.float32, "ragged M"),
)
# Per-lane kv_len (a scheduler's slot class, its two lanes at different
# positions): flash-decode is checked at each pair and timed at the second.
LANE_KV_LENS = ((1, 528), (528, 300))
# The admission phase: 2 prompts of 500 tokens admitted in chunks of 32 (15 x
# 32 + 16 + 4, so retention runs from a warm state at chunks 32, 16 and 4),
# bucketed to 512, and 32 greedy tokens resumed from the chunked cache.
ADMIT_PROMPT, ADMIT_CHUNK = 500, 32
ADMIT_CACHE = ADMIT_PROMPT + NEW   # KV slots of a chunked admission: 532
TOP_P = 0.9
RMS_MAIN = (1024, 4096, torch.bfloat16)
RMS_AMORTISED = 8        # calls on distinct inputs per graph in `amortised_ms`


def log(*args) -> None:
    print(*args, flush=True)


def card_peaks(name: str) -> dict:
    if "H200" in name:
        return PEAKS["H200"]
    if "H100" in name:
        return PEAKS["H100 PCIe" if "PCIe" in name else "H100 SXM"]
    raise RuntimeError(f"no data-sheet peaks for {name!r}")


_FLUSH: list = []


def time_ms(fn, iters: int = 15) -> float:
    """Median device time of ``fn`` with a cold L2.

    ``fn`` is captured once in a CUDA graph and replayed between CUDA
    events, so the events time the card's work and not the Python wrapper
    around it (the wrapper's host cost is `call_ms`).  A 256 MB write before
    each replay evicts the 50 MB L2.
    """
    if not _FLUSH:
        _FLUSH.append(torch.empty(64 << 20, dtype=torch.float32, device="cuda"))
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    pairs = []
    for _ in range(iters):
        _FLUSH[0].zero_()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        graph.replay()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    t = sorted(s.elapsed_time(e) for s, e in pairs)
    del graph
    return t[len(t) // 2]


def call_ms(fn, iters: int = 50) -> float:
    """Wall time per call of ``fn`` issued back to back, warm L2: the larger
    of its host cost (Python, checks, allocation, launch) and its device time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def amortised_ms(fn, inputs, iters: int = 15) -> float:
    """Median device time per call of ``fn(x)`` over the distinct ``inputs``,
    captured back to back in one CUDA graph and replayed with a cold L2 as
    in `time_ms`, divided by their count: the replay's fixed cost (the floor
    of `time_ms`) is spread over every call."""
    return time_ms(lambda: [fn(x) for x in inputs], iters) / len(inputs)


def device_len(n) -> torch.Tensor:
    """kv_len as the main path passes it: an int32 scalar on the card (a
    ``[B]`` tensor for a tuple, one length per lane, as a slot class's step
    passes it)."""
    return torch.tensor(n, dtype=torch.int32, device="cuda")


def per_lane_checks(name, run, plain, n: int) -> tuple[float, float]:
    """``run(kv_len)`` at each pair of `LANE_KV_LENS` against ``plain`` under
    flash-decode's tolerance, and at a ``[B]`` kv_len of all ``n`` bit-equal
    to the scalar ``n``.  Returns the largest error and the kernel's time at
    the second pair."""
    err = 0.0
    for lens in LANE_KV_LENS:
        nl = device_len(lens)
        err = max(err, _check(f"{name} per-lane kv_len {lens}", run(nl), plain(nl),
                              2e-5, 2e-6))
    if not torch.equal(run(device_len((n,) * BATCH)), run(device_len(n))):
        raise RuntimeError(f"{name}: a per-lane kv_len of equal lengths differs from "
                           "the scalar")
    lanes = device_len(LANE_KV_LENS[1])
    return err, time_ms(lambda: run(lanes))


def bound_ms(nbytes: float, ops_: float, op_rate: float, peaks: dict):
    tb, to = nbytes / peaks["bytes"] * 1e3, ops_ / op_rate * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def _gen(seed: int) -> torch.Generator:
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def _check(name, got, want, rtol, atol):
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{name}: kernel vs plain: {m}")
    return err


def _linear_cases(path: dict, m: int, lm_head_m: int, prefill: bool = False):
    """(path, M, K, N, launches per unit) of every linear shape of a path in
    one phase."""
    shapes = path["linears"] + (path["prefill_linears"] if prefill else ())
    cases = [(path["arch"], m, k, n, c * path["layers"]) for k, n, c in shapes]
    return cases + [(path["arch"], lm_head_m, path["d"], path["vocab"], 1)]


def kernel_phase_mxint4(peaks):
    rows = []
    for arch, m, k, n, count in (c for path in PATHS
                                 for c in _linear_cases(path, BATCH, BATCH)):
        g = _gen(k + n)
        x = torch.randn(m, k, generator=g, device="cuda")
        w = torch.randn(k, n, generator=g, device="cuda") * k ** -0.5
        q = mx.quantize_mxint4(w)
        del w
        os_ = torch.rand(n, generator=g, device="cuda") + 0.5
        rs = torch.rand(m, generator=g, device="cuda") + 0.5
        b = torch.randn(n, generator=g, device="cuda")
        got = ops.mxint4_matmul(x, q, os_, rs, b, impl="kernel")
        want = ref.mxint4_matmul_ref(x, q, os_, rs, b)
        err = _check(f"mxint4 {k}x{n}", got, want, 1e-5, 1e-5)
        if not torch.equal(got, ops.mxint4_matmul(x, q, os_, rs, b, impl="kernel")):
            raise RuntimeError(f"mxint4 {k}x{n}: two launches differ")
        w_deq = mx.dequantize_mxint4(q, dtype=torch.float32)
        nbytes = 4 * m * k + k * n // 2 + k * n // 32 + 4 * (2 * n + m) + 4 * m * n
        bms, by = bound_ms(nbytes, 2 * m * k * n, peaks["f32"], peaks)
        ms = time_ms(lambda: ops.mxint4_matmul(x, q, os_, rs, b, impl="kernel"))
        rows.append(dict(
            path=arch, shape=[m, k, n], per_step=count, max_abs_err=err, ms=ms,
            call_ms=call_ms(lambda: ops.mxint4_matmul(x, q, os_, rs, b, impl="kernel")),
            plain_ms=time_ms(lambda: ref.mxint4_matmul_ref(x, q, os_, rs, b)),
            library_ms=time_ms(lambda: x @ w_deq), bound_ms=bms, bound_by=by,
            plan=hopper.mxint4_plan(m, n, k), rate=f"{nbytes / ms / 1e6:.1f} GB/s",
            bound_share=bms / ms))
        del w_deq
    return rows


def kernel_phase_w8a8(peaks):
    rows = []
    for arch, m, k, n, count in (c for path in PATHS
                                 for c in _linear_cases(path, BATCH * PROMPT, BATCH, True)):
        g = _gen(m + k + n)
        xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda").to(torch.int8)
        # K-major, as deploy stores the main path's weights.
        wq = deploy.k_major(torch.randint(-127, 128, (k, n), generator=g,
                                          device="cuda").to(torch.int8))
        sc = torch.tensor(1e-4, device="cuda")
        rs = torch.rand(m, generator=g, device="cuda") + 0.5
        b = torch.randn(n, generator=g, device="cuda")
        got = ops.w8a8_matmul(xq, wq, sc, rs, b, impl="kernel")
        want = ref.w8a8_matmul_ref(xq, wq, sc, rs, b)
        err = _check(f"w8a8 {m}x{k}x{n}", got, want, 0.0, 0.0)   # exact
        if not torch.equal(got, ops.w8a8_matmul(xq, wq, sc, rs, b, impl="kernel")):
            raise RuntimeError(f"w8a8 {m}x{k}x{n}: two launches differ")
        # torch._int_mm needs M > 16: the M = 2 lm_head is timed padded to 32
        # rows (noted as library_rows).  library_ms takes the K-major weight
        # (cuBLASLt's int8 "TN" layout, the one the kernel reads);
        # library_rowmajor_ms the row-major copy earlier runs timed.
        xl = xq if m > 16 else F.pad(xq, (0, 0, 0, 32 - m))
        nbytes = m * k + k * n + 4 * (2 * n + m) + 4 * m * n
        bms, by = bound_ms(nbytes, 2 * m * k * n, peaks["int8"], peaks)
        ms = time_ms(lambda: ops.w8a8_matmul(xq, wq, sc, rs, b, impl="kernel"))
        lib = time_ms(lambda: torch._int_mm(xl, wq))
        w_row = wq.contiguous()
        lib_row = time_ms(lambda: torch._int_mm(xl, w_row))
        del w_row
        rows.append(dict(
            path=arch, shape=[m, k, n], per_prefill=count, max_abs_err=err, ms=ms,
            call_ms=call_ms(lambda: ops.w8a8_matmul(xq, wq, sc, rs, b, impl="kernel")),
            plain_ms=time_ms(lambda: ref.w8a8_matmul_ref(xq, wq, sc, rs, b)),
            library_ms=lib, library_rowmajor_ms=lib_row, library_rows=xl.shape[0],
            bound_ms=bms, bound_by=by, plan=hopper.w8a8_plan(m, n),
            rate=f"{2 * m * k * n / ms / 1e9:.1f} TOP/s, {nbytes / ms / 1e6:.1f} GB/s",
            library_rate=f"{2 * xl.shape[0] * k * n / lib / 1e9:.1f} TOP/s",
            bound_share=bms / ms))
    return rows


def _launch_kernels(fn) -> list:
    """Names of the CUDA kernels (and copies) one call of ``fn`` runs on the
    card, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def _retention_f64(q, k, v, gamma):
    """y and the final state from a zero state in float64, by the parallel
    form over the whole sequence: the yardstick both f32 versions are held
    to (``f64_max_abs_err``)."""
    qd, kd, vd = (t.double() for t in (q, k, v))
    n = torch.arange(q.shape[2], dtype=torch.float64, device=q.device)
    lg = torch.log(gamma.double())[:, None, None]
    diff = n[:, None] - n[None, :]
    d = torch.where(diff >= 0, torch.exp(diff.clamp(min=0) * lg), 0.0)
    y = torch.einsum("bhnm,bhmv->bhnv", torch.einsum("bhnd,bhmd->bhnm", qd, kd) * d, vd)
    w = torch.exp((n[-1] - n)[None, :] * lg[:, :, 0])                 # [H, S]
    state = torch.einsum("bhnd,bhnv->bhdv", kd * w[None, :, :, None], vd)
    return y, state


def kernel_phase_retention(peaks):
    """retnet-1.3b prefill retention: B 2, H 8, S 512, dk 256, dv 512, c 128,
    on q, k and v as the model hands them over (transposes of ``[B, S, H,
    d]`` tensors; contiguous inputs are left to tests/test_torch_cuda.py).

    Checked from a zero and a warm state, relaunched bit-equal, and
    profiled: one wrapper call must run the kernel's two launches and no
    copy or elementwise kernel.  ``flops`` is the work the function needs
    from a zero state: Q K^T and P V over the pairs i >= j of a chunk, Q S
    for the chunks after the first, K^T V for every chunk.  ``bound_ms``
    prices it as the kernel's instruction mix, three TF32 tensor-core
    products per multiply-add; ``bound_f32_ms`` as f32 FMAs on the CUDA
    cores (the bound the kernel was first held to).  Both versions' errors
    against a float64 evaluation are printed beside the check, and the
    plain version's time on contiguous inputs (``plain_contiguous_ms``) beside
    its time on the views.  No single PyTorch call computes chunkwise
    retention."""
    h = 8
    dk, dv, c = RETNET["d"] // h, 2 * RETNET["d"] // h, 128
    g = _gen(7)
    gamma = ret.head_decays(h, device="cuda")
    bh, n_chunks = BATCH * h, PROMPT // c
    pairs = c * (c + 1) // 2
    flops = bh * (n_chunks * (2 * pairs * (dk + dv) + 2 * c * dk * dv)
                  + (n_chunks - 1) * 2 * c * dk * dv)
    nbytes = 4 * bh * PROMPT * (2 * dk + 2 * dv) + 4 * bh * dk * dv + 4 * h
    bms, by = bound_ms(nbytes, 3 * flops, peaks["tf32"], peaks)
    bf32, by32 = bound_ms(nbytes, flops, peaks["f32"], peaks)
    q, k = ((torch.randn(BATCH, PROMPT, h, dk, generator=g, device="cuda") * dk ** -0.5)
            .transpose(1, 2) for _ in range(2))
    v = torch.randn(BATCH, PROMPT, h, dv, generator=g, device="cuda").transpose(1, 2)
    run = lambda st=None: ops.retention_chunkwise(  # noqa: E731
        q, k, v, gamma, chunk=c, state=st, impl="kernel")
    errs = []
    for st in (None, torch.randn(BATCH, h, dk, dv, generator=g, device="cuda") * 0.1):
        y, s = run(st)
        y_r, s_r = ref.retention_chunkwise_ref(q, k, v, gamma, chunk=c, state=st)
        errs.append(max(_check("retention y", y, y_r, 1e-4, 1e-4),
                        _check("retention state", s, s_r, 1e-4, 1e-4)))
        for _ in range(2):
            y2, s2 = run(st)
            if not (torch.equal(y, y2) and torch.equal(s, s2)):
                raise RuntimeError("retention: two launches differ")
    y64, s64 = _retention_f64(q, k, v, gamma)
    y_r, s_r = ref.retention_chunkwise_ref(q, k, v, gamma, chunk=c)
    y, s = run()
    f64_err = {name: max((a.double() - y64).abs().max().item(),
                         (b.double() - s64).abs().max().item())
               for name, (a, b) in (("kernel", (y, s)), ("plain", (y_r, s_r)))}
    del y64, s64
    launched = _launch_kernels(run)
    if not launched:
        raise RuntimeError("retention: the profiler saw no device kernel")
    if len(launched) != 2 or not all("retention_pass" in n for n in launched):
        raise RuntimeError(f"retention: one call ran {launched}, "
                           "expected the kernel's two launches only")
    ms = time_ms(run)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    row = dict(
        path=RETNET["arch"], layout="model transpose(1, 2) views",
        shape=[BATCH, h, PROMPT, dk, dv, c], per_prefill=RETNET["layers"],
        max_abs_err=errs[0], warm_state_max_abs_err=errs[1], f64_max_abs_err=f64_err,
        ms=ms, call_ms=call_ms(run),
        plain_ms=time_ms(lambda: ref.retention_chunkwise_ref(q, k, v, gamma, chunk=c)),
        plain_contiguous_ms=time_ms(
            lambda: ref.retention_chunkwise_ref(qc, kc, vc, gamma, chunk=c)),
        library_ms=None, bound_ms=bms, bound_by=by, bound_f32_ms=bf32, bound_f32_by=by32,
        flops=flops, plan=hopper.retention_plan(bh, PROMPT, dk, dv, c),
        launch_kernels=launched, rate=f"{flops / ms / 1e9:.1f} TFLOP/s (needed work)",
        bound_share=bms / ms, bound_share_f32=bf32 / ms)
    return [row]


def _cache_leaf(x: torch.Tensor, fmt: str):
    """A cache leaf in one of the kernel's formats (legacy int8: q / 32)."""
    if fmt in kvq.FORMATS:
        return kvq.encode(x, fmt)
    return layers.to_cache_dtype(x, {"f32": torch.float32, "bf16": torch.bfloat16,
                                     "int8": torch.int8}[fmt])


def sdpa_backend(fn) -> str:
    """The backend one `scaled_dot_product_attention` call took, read from
    the CUDA kernels it ran (torch.profiler), with their names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not names:
        return "not measured"
    text = " ".join(names).lower()
    kind = next((k for k, marks in (("flash", ("flash",)), ("cudnn", ("cudnn",)),
                                    ("efficient", ("fmha", "efficient", "cutlassf")))
                 if any(m in text for m in marks)), "math")
    return f"{kind}: " + "; ".join(n[:48] for n in names[:4])


def kernel_phase_flash_decode(peaks):
    """qwen3-8b decode attention: B = 2, KV = 8, G = 4, d = 128, C = 544, in
    every cache format, kv_len an int32 scalar on the card.  Checked at
    `DECODE_CHECK_LENS`, timed at 528; the
    f32 cache (the default ``cache_format=None``) is the main-path unit.
    Its library yardsticks are `scaled_dot_product_attention` on the f32
    K/V: ``library_gqa_ms`` with ``enable_gqa=True`` on the un-expanded
    ``[B, KV, n, d]`` views, and ``library_ms`` on K/V copied and expanded
    to the 32 query heads (4x the bytes).  No single PyTorch call reads an
    encoded cache."""
    b, kvh, g, d, c, n = BATCH, QWEN3["kv"], QWEN3["g"], QWEN3["hd"], CACHE_LEN, DECODE_KV_LEN
    gen = _gen(11)
    q = torch.randn(b, kvh, g, d, generator=gen, device="cuda")
    k32 = torch.randn(b, c, kvh, d, generator=gen, device="cuda")
    v32 = torch.randn(b, c, kvh, d, generator=gen, device="cuda")
    rows = []
    for fmt in ("f32", "bf16", "int8", "int8_tok", "mxint4_blk"):
        k, v = _cache_leaf(k32, fmt), _cache_leaf(v32, fmt)
        err = 0.0
        for kv_len in map(device_len, DECODE_CHECK_LENS):
            got = ops.flash_decode(q, k, v, kv_len, impl="kernel")
            want = ref.flash_decode_ref(q, k, v, kv_len)
            err = max(err, _check(f"flash_decode {fmt} kv_len {int(kv_len)}", got, want,
                                  2e-5, 2e-6))
            if not torch.equal(got, ops.flash_decode(q, k, v, kv_len, impl="kernel")):
                raise RuntimeError(f"flash_decode {fmt}: two launches differ")
        nd = device_len(n)
        lane_err, lane_ms = per_lane_checks(
            f"flash_decode {fmt}", lambda n_: ops.flash_decode(q, k, v, n_, impl="kernel"),
            lambda n_: ref.flash_decode_ref(q, k, v, n_), n)
        row_bytes = {"f32": 4 * d, "bf16": 2 * d, "int8": d}.get(fmt) or kvq.nbytes_per_row(fmt, d)
        nbytes = 2 * 4 * b * kvh * g * d + 2 * n * b * kvh * row_bytes
        bms, by = bound_ms(nbytes, 4 * b * kvh * g * n * d, peaks["f32"], peaks)
        extra = {}
        if fmt == "f32":
            qs = q.reshape(b, kvh * g, 1, d)
            kg, vg = (t[:, :n].permute(0, 2, 1, 3) for t in (k32, v32))
            gqa = lambda: F.scaled_dot_product_attention(qs, kg, vg, enable_gqa=True)  # noqa: E731
            lib_err = (gqa().reshape(b, kvh, g, d) - ref.flash_decode_ref(q, k, v, nd)
                       ).abs().max().item()
            ks, vs = (t.repeat_interleave(g, dim=1).contiguous() for t in (kg, vg))
            extra = dict(library_ms=time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs)),
                         library_gqa_ms=time_ms(gqa), library_backend=sdpa_backend(gqa),
                         library_max_abs_err=lib_err)
            del ks, vs
        path = {"f32": QWEN3["arch"], "bf16": "bf16 (no model path)",
                "int8": "legacy int8 (no model path)"}.get(fmt, f"{QWEN3['arch']} {fmt}")
        ms = time_ms(lambda: ops.flash_decode(q, k, v, nd, impl="kernel"))
        row = dict(
            path=path, main=fmt == "f32", fmt=fmt, shape=[b, kvh, g, d, c], kv_len=n,
            per_step=QWEN3["layers"], max_abs_err=max(err, lane_err), ms=ms,
            per_lane_ms=lane_ms, per_lane_kv_len=list(LANE_KV_LENS[1]),
            per_lane_max_abs_err=lane_err,
            call_ms=call_ms(lambda: ops.flash_decode(q, k, v, nd, impl="kernel")),
            plain_ms=time_ms(lambda: ref.flash_decode_ref(q, k, v, nd)),
            library_ms=None, library_gqa_ms=None, bound_ms=bms, bound_by=by,
            plan={key: val for key, val in hopper.flash_decode_plan(
                b, kvh, g, d, d, c, fmt, fmt).items() if key != "ranges"},
            rate=f"{nbytes / ms / 1e6:.1f} GB/s", bound_share=bms / ms)
        row.update(extra)
        rows.append(row)
    return rows


def _mla_f64(q, q2, lat, rope, n, scale):
    """The MLA mode's output in float64 from the decoded cache."""
    ld, rd = (kvq.decode(x)[:, :n].double() for x in (lat, rope))
    s = (torch.einsum("bhr,bcr->bhc", q.double(), ld)
         + torch.einsum("bhr,bcr->bhc", q2.double(), rd)) * scale
    return torch.einsum("bhc,bcr->bhr", torch.softmax(s, dim=-1), ld)


def kernel_phase_flash_decode_mla(peaks):
    """deepseek-v3's absorbed decode attention (flash-decode's MLA mode): B 2,
    H 128, latent 512, rope 64, C 544, in every cache format, kv_len an int32
    scalar on the card.  Checked at `DECODE_CHECK_LENS` against the plain
    version, timed at 528; the f32
    cache is the main-path unit (3 launches a step).  The absorbed query is
    drawn at std 0.5, q_nope . wk_b for a unit-variance q_nope over the nope
    width 128 against a unit-RMS latent of 512 (scores of unit variance, as
    the model's scale assumes); with q ~ N(0, 1) the kernel is held to a
    float64 evaluation at the same tolerance (the plain version's own f32
    error nears it there), and ``f64_max_abs_err`` reports both versions'.
    ``flops`` counts the work the function needs: scores over latent and
    rope, then P.V.  ``bound_ms`` prices it at the kernel's instruction mix,
    three TF32 tensor-core products per multiply-add for the f32 cache
    (3xTF32) and two for the other formats (2xTF32, the cache values exact
    in TF32); ``bound_f32_ms`` as f32 FMAs on the CUDA cores (the bound an
    FMA kernel would be held to).  A profiler check holds one call to one
    device kernel.  The library yardstick is
    `scaled_dot_product_attention` with ``enable_gqa`` on ``[q | q2]``
    against ``[latent | rope]`` with the latent as V, concatenated outside
    the timed call; no PyTorch call reads an encoded cache."""
    b, h, r, dr = BATCH, DS3["heads"], DS3["r"], DS3["dr"]
    c, n = CACHE_LEN, DECODE_KV_LEN
    nope = DS3["cfg"].qk_nope_head_dim
    scale = 1.0 / (nope + dr) ** 0.5
    gen = _gen(13)
    q = torch.randn(b, h, r, generator=gen, device="cuda") * (nope / r) ** 0.5
    q_unit = torch.randn(b, h, r, generator=gen, device="cuda")
    q2 = torch.randn(b, h, dr, generator=gen, device="cuda")
    lat32 = torch.randn(b, c, r, generator=gen, device="cuda")
    rope32 = torch.randn(b, c, dr, generator=gen, device="cuda")
    rows = []
    for fmt in ("f32", "bf16", "int8", "int8_tok", "mxint4_blk"):
        lat, rope = _cache_leaf(lat32, fmt), _cache_leaf(rope32, fmt)
        run = lambda qq, n_: ops.flash_decode(qq, lat, lat, n_, q2=q2, k2=rope,  # noqa: E731
                                              scale=scale, impl="kernel")
        plain = lambda qq, n_: ref.flash_decode_ref(qq, lat, lat, n_, q2=q2, k2=rope,  # noqa: E731
                                                    scale=scale)
        err = 0.0
        for kv_len in map(device_len, DECODE_CHECK_LENS):
            got = run(q, kv_len)
            err = max(err, _check(f"flash_decode MLA {fmt} kv_len {int(kv_len)}", got,
                                  plain(q, kv_len), 2e-5, 2e-6))
            if not torch.equal(got, run(q, kv_len)):
                raise RuntimeError(f"flash_decode MLA {fmt}: two launches differ")
        nd = device_len(n)
        lane_err, lane_ms = per_lane_checks(f"flash_decode MLA {fmt}",
                                            lambda n_: run(q, n_), lambda n_: plain(q, n_), n)
        want64 = _mla_f64(q_unit, q2, lat, rope, n, scale)
        _check(f"flash_decode MLA {fmt} at q ~ N(0, 1) vs float64", run(q_unit, nd).double(),
               want64, 2e-5, 2e-6)
        f64_err = {name: (fn(q_unit, nd).double() - want64).abs().max().item()
                   for name, fn in (("kernel", run), ("plain", plain))}
        row_bytes = sum(hopper.fd_row_bytes(fmt, w)[i] for w in (r, dr) for i in (0, 1))
        nbytes = 4 * b * h * (2 * r + dr) + n * b * row_bytes
        flops = 2 * b * h * n * (r + dr) + 2 * b * h * n * r
        bms, by = bound_ms(nbytes, (3 if fmt == "f32" else 2) * flops, peaks["tf32"], peaks)
        bf32, by32 = bound_ms(nbytes, flops, peaks["f32"], peaks)
        launched = _launch_kernels(lambda: run(q, nd))
        if len(launched) != 1 or "flash_decode_mla" not in launched[0]:
            raise RuntimeError(f"flash_decode MLA {fmt}: one call ran {launched}, "
                               "expected the kernel's one launch only")
        extra = {}
        if fmt == "f32":
            q_cat = torch.cat([q, q2], dim=-1)[:, :, None]                 # [B, H, 1, r + dr]
            k_cat = torch.cat([lat32, rope32], dim=-1)[:, None, :n].contiguous()
            v_lat = lat32[:, None, :n].contiguous()                        # [B, 1, n, r]
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q_cat, k_cat, v_lat, scale=scale, enable_gqa=True)
            lib_err = (sdpa()[:, :, 0] - plain(q, nd)).abs().max().item()
            extra = dict(library_ms=time_ms(sdpa), library_backend=sdpa_backend(sdpa),
                         library_max_abs_err=lib_err)
            del q_cat, k_cat, v_lat
        path = {"f32": DS3["arch"], "bf16": "bf16 (no model path)",
                "int8": "legacy int8 (no model path)"}.get(fmt, f"{DS3['arch']} {fmt}")
        ms = time_ms(lambda: run(q, nd))
        row = dict(
            path=path, main=fmt == "f32", fmt=fmt, shape=[b, h, r, dr, c], kv_len=n,
            per_step=DS3["layers"], max_abs_err=max(err, lane_err),
            f64_max_abs_err=f64_err, ms=ms, per_lane_ms=lane_ms,
            per_lane_kv_len=list(LANE_KV_LENS[1]), per_lane_max_abs_err=lane_err,
            call_ms=call_ms(lambda: run(q, nd)), plain_ms=time_ms(lambda: plain(q, nd)),
            library_ms=None, bound_ms=bms, bound_by=by, bound_f32_ms=bf32,
            bound_f32_by=by32, flops=flops, launch_kernels=launched,
            plan={key: val for key, val in hopper.flash_decode_mla_plan(
                b, h, r, dr, c, fmt, hopper._mla_resident(q.device)).items()
                  if key not in ("ranges", "smem")},
            rate=f"{flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.1f} GB/s",
            bound_share=bms / ms, bound_share_f32=bf32 / ms)
        row.update(extra)
        rows.append(row)
    return rows


def ptxas_summary(report: str) -> dict:
    """Entry functions, registers, shared memory and spills from ``nvcc
    -Xptxas -v`` output."""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", report)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)]
    stack = [int(x) for x in re.findall(r"(\d+) bytes stack frame", report)]
    smem = [int(x) for x in re.findall(r"registers, (?:used \d+ barriers, )?(\d+) bytes smem",
                                       report)]
    return dict(entries=len(regs), registers=[min(regs, default=0), max(regs, default=0)],
                static_smem_bytes=max(smem, default=0), stack_bytes=max(stack, default=0),
                spill_bytes=max(spills, default=0))


def _rms_f64(y: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.rsqrt(y.double().square().mean(dim=-1) + eps)


def kernel_phase_rmsnorm_stats(peaks):
    """sigma^{-1} rows at `RMS_SHAPES`.  It has no model path (the reference
    routes no site through its kernel); its unit is one [1024, 4096] bf16
    call.  Each shape is checked against the plain version and float64, a
    relaunch must be bit-equal, and a profiler check holds one call to one
    device kernel.  ``ms`` is one call per replay (`time_ms`, whose floor
    is printed) and ``amortised_ms`` RMS_AMORTISED calls on distinct inputs
    per replay.  No PyTorch call computes rsqrt(mean(y^2) + eps), so
    ``library_ms`` is None; ``nearest_library_ms`` times
    ``torch.linalg.vector_norm(y, dim=-1, dtype=torch.float32)``, one
    library reduction over the same bytes, as a yardstick of the read."""
    rows = []
    for m, d, dt, site in RMS_SHAPES:
        ys = [torch.randn(m, d, generator=_gen(m + d + i), device="cuda").to(dt)
              for i in range(RMS_AMORTISED)]
        y = ys[0]
        run = lambda yy=y: ops.rmsnorm_stats(yy, impl="kernel")  # noqa: E731
        tag = f"rmsnorm_stats {m}x{d} {dt}"
        got = run()
        err = _check(tag, got, ref.rmsnorm_stats_ref(y), 1e-6, 1e-6)
        want64 = _rms_f64(y)
        _check(f"{tag} vs float64", got.double(), want64, 1e-6, 1e-6)
        if not torch.equal(got, run()):
            raise RuntimeError(f"{tag}: two launches differ")
        launched = _launch_kernels(run)
        if len(launched) != 1 or "rmsnorm_stats_kernel" not in launched[0]:
            raise RuntimeError(f"{tag}: one call ran {launched}, expected one kernel")
        elem = y.element_size()
        plan = hopper.rmsnorm_stats_plan(m, d, elem, hopper._sms(y.device), hopper.rms_width(
            y.data_ptr(), y.stride(0) * elem, elem))
        bms, by = bound_ms(m * d * elem + 4 * m, 2 * m * d, peaks["f32"], peaks)
        lib = lambda yy=y: torch.linalg.vector_norm(yy, dim=-1, dtype=torch.float32)  # noqa: E731
        ms = time_ms(run)
        am = amortised_ms(run, ys)
        rows.append(dict(
            path="ops.rmsnorm_stats (no model path)", main=(m, d, dt) == RMS_MAIN, site=site,
            shape=[m, d], dtype=str(dt).replace("torch.", ""), per_call=1, max_abs_err=err,
            f64_max_abs_err={"kernel": (got.double() - want64).abs().max().item(),
                             "plain": (ref.rmsnorm_stats_ref(y).double() - want64)
                             .abs().max().item()},
            ms=ms, amortised_ms=am, call_ms=call_ms(run),
            plain_ms=time_ms(lambda: ref.rmsnorm_stats_ref(y)), library_ms=None,
            nearest_library_ms=time_ms(lib),
            bound_ms=bms, bound_by=by, bound_share=bms / ms, amortised_bound_share=bms / am,
            launch_kernels=launched,
            plan={k: plan[k] for k in ("width", "loads", "rounds", "tpr", "rows", "blocks",
                                       "waves")}))
        del ys, y, want64
    return rows


def sigma_chain_price() -> list:
    """What the port's sigma^{-1} sites pay today: `fr.rms_sigma_inv` (a
    chain of PyTorch kernels) beside `ops.rmsnorm_stats`, on the bf16 rows
    `layers.norm_emit` passes in decode and in prefill: device kernels per
    call, their device time per call (torch.profiler over 20 calls back to
    back, warm L2), ``ms`` (`time_ms`, cold L2) and ``call_ms``."""
    from torch.profiler import ProfilerActivity, profile
    out = []
    for m in (2, 1024):
        y = torch.randn(m, 4096, generator=_gen(m), device="cuda").to(torch.bfloat16)
        for what, fn in (("ops.rmsnorm_stats", lambda: ops.rmsnorm_stats(y, impl="kernel")),
                         ("fr.rms_sigma_inv", lambda: fr.rms_sigma_inv(y))):
            names = _launch_kernels(fn)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            dev, _ = _device_us(prof)
            out.append(dict(what=what, shape=[m, 4096], dtype="bfloat16",
                            kernels_per_call=len(names), kernels=[n[:60] for n in names],
                            device_us_per_call=dev / 20, ms=time_ms(fn), call_ms=call_ms(fn)))
    return out


def summarize(name, rows, per_key, tol):
    """One `kernels` entry.  Times and bounds are summed over one unit (a
    decode step for mxint4 and flash_decode, a prefill for w8a8 and
    retention, a call for rmsnorm_stats) of each main path the kernel is on,
    from the rows marked main; ``per_path`` holds the same sums per path."""
    def total(key, pick):
        sel = [r for r in rows if pick(r)]
        if not sel or any(r[key] is None for r in sel):
            return None
        return sum(r[key] * r[per_key] for r in sel)
    main = lambda r: r.get("main", True)    # noqa: E731
    b = total("bound_ms", main)
    by_ops = sum(r["bound_ms"] * r[per_key] for r in rows
                 if main(r) and r["bound_by"] == "operations")
    keys = ("ms", "plain_ms", "library_ms", "bound_ms") + tuple(
        key for key in ("library_rowmajor_ms", "library_gqa_ms", "bound_f32_ms",
                        "plain_contiguous_ms", "amortised_ms", "nearest_library_ms",
                        "per_lane_ms")
        if key in rows[0])
    per_path = {p: {key: total(key, lambda r, p=p: r["path"] == p) for key in keys}
                for p in dict.fromkeys(r["path"] for r in rows)}
    entry = dict(name=name, route="cuda", source=SRC[name][0], replaces=SRC[name][1],
                 launches=None, max_abs_err=max(r["max_abs_err"] for r in rows),
                 tolerance=tol, per=per_key.replace("per_", ""),
                 ms=total("ms", main), plain_ms=total("plain_ms", main), bound_ms=b,
                 bound_by="operations" if by_ops > b / 2 else "bytes",
                 library_ms=total("library_ms", main))
    entry.update({key: total(key, main) for key in keys[4:]})
    return dict(entry, per_path=per_path, shapes=rows)


def retention_launches(s: int) -> int:
    """Retention launches per layer of an ``s``-token prefill: the whole
    128-row chunks in one launch, the tail in another."""
    return int(s >= 128) + int(s % 128 > 0)


def expected_launches(path: dict, s: int = PROMPT) -> tuple[dict, dict]:
    """Launches per ``s``-token prefill and per decode step on a main path."""
    per_prefill = dict.fromkeys(hopper.COUNTERS, 0)
    per_step = dict.fromkeys(hopper.COUNTERS, 0)
    both = sum(c for _, _, c in path["linears"])
    prefill_only = sum(c for _, _, c in path["prefill_linears"])
    per_prefill["w8a8_matmul"] = (both + prefill_only) * path["layers"] + 1
    per_step["mxint4_matmul"] = both * path["layers"] + 1
    if path is RETNET:
        per_prefill["retention_chunkwise"] = path["layers"] * retention_launches(s)
    elif path is DS3:
        per_step["flash_decode_mla"] = path["layers"]
    else:
        per_step["flash_decode"] = path["layers"]
    return per_prefill, per_step


def serve_full_width(path: dict, card: str):
    """One main path at full width, once per cache format: launch counts per
    phase and per counted generate (its decode steps replays of the captured
    step), the graph against the eager loop in turns (timings, and tokens,
    lengths and final cache bit for bit), busy shares, and the kernel path
    against the plain path on the same weights."""
    arch = path["arch"]
    log(f"== full-width serving: {arch}, B={BATCH}, S={PROMPT}, {NEW} greedy tokens, "
        f"cache formats {[f or 'f32' for f in path['formats']]}")
    t0 = time.perf_counter()
    eng = InferenceEngine.from_config(path.get("cfg", arch), EngineSpec(), device="cuda")
    torch.cuda.synchronize()
    log(f"init + deploy: {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
    cfg = eng.cfg
    if (cfg.n_layers, cfg.d_model, cfg.padded_vocab) != (path["layers"], path["d"],
                                                         path["vocab"]):
        raise RuntimeError(f"unexpected config {cfg}")
    prompts = torch.randint(1, cfg.vocab_size, (BATCH, PROMPT), generator=_gen(1),
                            device="cuda")
    want_p, want_s = expected_launches(path)
    plain = InferenceEngine(cfg, eng.model, EngineSpec(kernel_impl="ref"))
    counted, results = dict.fromkeys(hopper.COUNTERS, 0), {}
    for fmt in path["formats"]:
        tag = arch if fmt is None else f"{arch} {fmt}"
        gen = GenerationConfig(max_new_tokens=NEW, cache_format=fmt)
        # Per-phase launch counts, eagerly, then the capture.
        hopper.reset_launches()
        logits, cache = eng.prefill(prompts, cache_len=CACHE_LEN)
        per_prefill = dict(hopper.LAUNCHES)
        cache = eng._encode_cache(cache, gen)
        hopper.reset_launches()
        eng.decode_step(logits.argmax(-1)[:, None], cache)
        per_step = dict(hopper.LAUNCHES)
        log(tag, "launches per prefill", per_prefill, "per decode step", per_step)
        if per_prefill != want_p or per_step != want_s:
            raise RuntimeError(f"{tag}: launch counts {per_prefill} / {per_step}, "
                               f"expected {want_p} / {want_s}")
        key = eng.graph_key(cache, gen)
        del cache
        first = eng.generate(prompts, gen)
        graph = eng._graphs[key]
        log(f"{tag} step captured in {first.capture_s:.3f} s; a replay launches "
            f"{graph.launches}")
        if graph.launches != per_step:
            raise RuntimeError(f"{tag}: the captured step launches {graph.launches}, "
                               f"an eager step {per_step}")

        # The main path, counted.
        hopper.reset_launches()
        res = eng.generate(prompts, gen)
        launches = dict(hopper.LAUNCHES)
        want = {k: want_p[k] + want_s[k] * res.decode_steps for k in hopper.COUNTERS}
        log(tag, "main-path launches", launches, "decode steps (replays)", res.decode_steps)
        if launches != want or res.capture_s:
            raise RuntimeError(f"{tag}: main-path launches {launches}, expected {want} "
                               f"(capture {res.capture_s} s)")
        for k in counted:
            counted[k] += launches[k]
        toks = res.tokens
        if toks.shape != (BATCH, NEW) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            raise RuntimeError(f"{tag}: bad tokens {toks.shape}")
        if not torch.equal(toks, first.tokens):
            raise RuntimeError(f"{tag}: a second generate's tokens differ from the first's")

        # The graph and the eager loop in turns (eager, graph, graph, eager);
        # each pair must agree bit for bit.
        graph_runs, eager_runs = [res], []
        for kind in ("eager", "graph", "graph", "eager"):
            if kind == "graph":
                graph_runs.append(eng.generate(prompts, gen))
                continue
            got, cache = eager_generate(eng, prompts, gen)
            eager_runs.append(got)
            _same_as_graph(tag, graph_runs[-1], graph.state.cache, got, cache)
            del cache
        serving = dict(card=card, runs=len(graph_runs), launches=launches,
                       capture_s=first.capture_s, replay_launches=graph.launches)
        for name, runs in (("", graph_runs), ("eager_", eager_runs)):
            pre = sorted(r.prefill_s for r in runs)[len(runs) // 2]
            dec = sorted(r.decode_s / r.decode_steps for r in runs)[len(runs) // 2]
            serving.update({f"{name}prefill_ms": pre * 1e3,
                            f"{name}decode_ms_per_token": dec * 1e3,
                            f"{name}decode_tokens_per_s": BATCH / dec,
                            f"{name}prefill_ms_runs": [r.prefill_s * 1e3 for r in runs],
                            f"{name}decode_ms_per_token_runs": [
                                r.decode_s * 1e3 / r.decode_steps for r in runs]})
        serving["prefill_tokens_per_s"] = BATCH * PROMPT / (serving["prefill_ms"] / 1e3)
        serving["graph_and_eager_bit_identical"] = True
        serving.update(profile_shares(eng, prompts, gen))
        log(f"{tag} serving (kernel path, medians; graph and eager in turns):",
            json.dumps(serving))

        # The same weights on the plain path.
        t1 = time.perf_counter()
        checks = compare_paths(eng, plain, prompts, gen)
        res_k, res_p, drift = free_running(eng, plain, prompts, gen)
        checks.update(
            greedy_token_agreement=(res_p.tokens == toks).float().mean().item(),
            free_running=dict(drift, kernel_tokens_as_counted=bool(
                (res_k.tokens == toks).all())),
            plain_prefill_ms=res_p.prefill_s * 1e3,
            plain_decode_ms_per_token=res_p.decode_s * 1e3 / res_p.decode_steps,
            compare_s=time.perf_counter() - t1)
        serving.update(checks)
        log(f"{tag} kernel vs plain path:", json.dumps(checks))
        results[tag] = serving
    if path is RETNET:
        results[f"{arch} top-k"] = sampled_through_graph(eng, prompts)
        results[f"{arch} top-p"] = top_p_through_graph(eng, prompts)
    log(f"{arch} phase: {time.perf_counter() - t0:.1f} s")
    admitted, admission = serve_admission(path, eng, plain, card)
    results.update(admission)
    scheduled, scheduling = serve_scheduler(path, eng, card)
    results.update(scheduling)
    del eng, plain
    torch.cuda.empty_cache()
    return counted, admitted, scheduled, results


@torch.inference_mode()
def eager_generate(eng, prompts, gen):
    """`generate` as the eager loop: prefill, then `decode_step` in a Python
    loop in the reference's body order (greedy, no stop tokens), timed as
    `generate` times itself.  Returns a GenerationResult and the final
    cache."""
    if not gen.sampling.greedy or gen.stop_tokens:
        raise ValueError("eager_generate: greedy decoding without stop tokens only")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = eng.prefill(prompts, cache_len=prompts.shape[1] + gen.max_new_tokens)
    cache = eng._encode_cache(cache, gen)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    res, cache = eager_loop(eng, sample(logits, gen.sampling), cache, gen)
    res.prefill_s = t_prefill
    return res, cache


@torch.inference_mode()
def eager_loop(eng, tok, cache, gen):
    """The decode loop as `decode_step` in a Python loop from the first
    emitted token ``tok`` and ``cache`` (which dense decode writes in
    place), in the reference's body order (greedy, no stop tokens).
    Returns a GenerationResult (decode timed, no prefill) and the final
    cache."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b, n = tok.shape[0], gen.max_new_tokens
    out = torch.full((b, n), gen.pad_token_id, dtype=torch.long, device="cuda")
    lengths = torch.zeros(b, dtype=torch.int32, device="cuda")
    for i in range(n):
        out[:, i] = tok
        lengths += 1
        logits, cache = eng.decode_step(tok[:, None], cache)
        tok = sample(logits, gen.sampling)
    torch.cuda.synchronize()
    return GenerationResult(tokens=out, lengths=lengths, prefill_s=0.0,
                            decode_s=time.perf_counter() - t0, decode_steps=n), cache


def _same_as_graph(tag, res_g, cache_g, res_e, cache_e) -> None:
    """The graph's and the eager loop's tokens, lengths and final cache, bit
    for bit (every tensor of the cache: position, rope angles, rows)."""
    if not (torch.equal(res_g.tokens, res_e.tokens)
            and torch.equal(res_g.lengths, res_e.lengths)):
        raise RuntimeError(f"{tag}: graph and eager loop emit different tokens")
    a = dict(serving_engine.tree_items(cache_g))
    b = dict(serving_engine.tree_items(cache_e))
    if a.keys() != b.keys():
        raise RuntimeError(f"{tag}: graph and eager caches differ in structure")
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if differ:
        raise RuntimeError(f"{tag}: graph and eager final caches differ at {differ[:4]}")


@torch.inference_mode()
def sampled_through_graph(eng, prompts) -> dict:
    """Top-k sampling through the captured step: every token among the k
    largest logits of its step (checked on the first, from prefill, and by
    replaying the eager loop's logits on the graph's tokens), the same
    tokens again from the same seed, other tokens from another seed."""
    gen = GenerationConfig(max_new_tokens=NEW, sampling=SamplingParams(temperature=1.0,
                                                                        top_k=4))
    runs = [eng.generate(prompts, gen, generator=_gen(21)) for _ in range(2)]
    other = eng.generate(prompts, gen, generator=_gen(22))
    toks = runs[0].tokens
    logits, cache = eng.prefill(prompts, cache_len=CACHE_LEN)
    outside = 0
    for i in range(NEW):
        allowed = torch.topk(logits, 4, dim=-1).indices
        outside += int((allowed != toks[:, i:i + 1]).all(dim=-1).sum())
        logits, cache = eng.decode_step(toks[:, i:i + 1], cache)
    out = dict(capture_s=runs[0].capture_s, repeats=bool(torch.equal(toks, runs[1].tokens)),
               other_seed_differs=not torch.equal(toks, other.tokens),
               tokens_outside_top_k=outside, decode_ms_per_token=runs[1].decode_s * 1e3 / NEW)
    log("top-k through the graph:", json.dumps(out))
    if not out["repeats"] or not out["other_seed_differs"] or outside:
        raise RuntimeError(f"top-k sampling through the graph: {out}")
    return out


@torch.inference_mode()
def top_p_through_graph(eng, prompts) -> dict:
    """Top-p sampling through the captured step (temperature 1, p TOP_P):
    every token inside its step's nucleus, recomputed with the plain
    `_top_p_mask` from that step's logits (the first from prefill, the rest
    by replaying the eager loop on the graph's tokens), and the same tokens
    again from the same seed."""
    gen = GenerationConfig(max_new_tokens=NEW, sampling=SamplingParams(temperature=1.0,
                                                                        top_p=TOP_P))
    runs = [eng.generate(prompts, gen, generator=_gen(41)) for _ in range(2)]
    other = eng.generate(prompts, gen, generator=_gen(42))
    toks = runs[0].tokens
    logits, cache = eng.prefill(prompts, cache_len=CACHE_LEN)
    outside, sizes = 0, []
    for i in range(NEW):
        kept = torch.isfinite(_top_p_mask(logits.float(), TOP_P))
        outside += int((~kept.gather(1, toks[:, i:i + 1])).sum())
        sizes.append(kept.sum(dim=-1).tolist())
        logits, cache = eng.decode_step(toks[:, i:i + 1], cache)
    out = dict(p=TOP_P, capture_s=runs[0].capture_s,
               repeats=bool(torch.equal(toks, runs[1].tokens)),
               other_seed_differs=not torch.equal(toks, other.tokens),
               tokens_outside_nucleus=outside,
               nucleus_sizes_min_max=[min(min(z) for z in sizes), max(max(z) for z in sizes)],
               decode_ms_per_token=runs[1].decode_s * 1e3 / NEW)
    log("top-p through the graph:", json.dumps(out))
    if not out["repeats"] or outside:
        raise RuntimeError(f"top-p sampling through the graph: {out}")
    return out


def _bytes_differing(a, b) -> tuple[int, int]:
    """(differing, total) bytes of two cache trees, element by element."""
    diff = total = 0
    ib = dict(serving_engine.tree_items(b))
    for k, t in serving_engine.tree_items(a):
        diff += int((t != ib[k]).sum()) * t.element_size()
        total += t.numel() * t.element_size()
    return diff, total


def _cache_rel(tag, ck, cr, tol) -> float:
    """Largest relative difference of the (decoded) leaves of two layer
    caches, each within ``tol`` of its max|value| (equal where that is 0)."""
    worst = 0.0
    for name in cr:
        a, b = kvq.decode(ck[name]), kvq.decode(cr[name])
        if not bool(b.abs().max() > 0):
            if not torch.equal(a, b):
                raise RuntimeError(f"{tag} {name}: kernel vs plain differ on a zero leaf")
            continue
        worst = max(worst, _rel(a, b, f"{tag} {name}", tol))
    return worst


@torch.inference_mode()
def chunk_lockstep(eng, plain, prompts, fmt) -> dict:
    """The chunked admission, kernel path against plain path on the same
    weights, in lockstep: each chunk starts both paths from the plain path's
    cache (in ``fmt``), each block gets the plain path's input, and the
    block outputs, every tensor of each layer's new cache (decoded) and the
    chunk's logits (the lm_head on the plain path's final activations) must
    agree within BLOCK_TOL of max|value|.  Encoded bytes that differ are
    counted and reported."""
    cfg, model = eng.cfg, eng.model
    cache = lm.make_decode_cache(cfg, prompts.shape[0], ADMIT_CACHE,
                                 dtype=fmt or torch.float32, device="cuda")
    worst = dict(block=0.0, cache=0.0, logits=0.0)
    diff_bytes = total_bytes = 0
    off = 0
    for j, c in enumerate(chunk_schedule(prompts.shape[1], ADMIT_CHUNK)):
        x = lm._embed(model, prompts[:, off:off + c])
        pos = cache["pos"]
        sin, cos = lm._rope_tables(cfg, c, x.device, start=pos)
        blocks = []
        for i, (blk, cl) in enumerate(zip(model.blocks, cache["blocks"])):
            yk, ck = lm._block_chunk(blk, x, cfg, eng.hsa, _clone(cl), pos, sin, cos)
            yr, cr = lm._block_chunk(blk, x, cfg, plain.hsa, _clone(cl), pos, sin, cos)
            tag = f"chunk {j} (c {c}) block {i}"
            worst["block"] = max(worst["block"], _rel(yk, yr, tag, BLOCK_TOL))
            worst["cache"] = max(worst["cache"], _cache_rel(tag, ck, cr, BLOCK_TOL))
            if fmt is not None:
                d, t = _bytes_differing(ck, cr)
                diff_bytes, total_bytes = diff_bytes + d, total_bytes + t
            x = yr.to(x.dtype)
            blocks.append(cr)
        h = layers.norm_full(model.final_norm, x[:, -1:])
        lk = eng.hsa.linear(model.lm_head, h, "prefill")[:, 0]
        lr = plain.hsa.linear(model.lm_head, h, "prefill")[:, 0]
        worst["logits"] = max(worst["logits"], _rel(lk, lr, f"chunk {j} logits", BLOCK_TOL))
        cache = {"pos": pos + c, "blocks": blocks}
        if cfg.rope:
            cache["rope"] = lm._rope_state(cfg, cache["pos"])
        off += c
    return dict(lockstep_block_max_rel_err=worst["block"],
                lockstep_cache_max_rel_err=worst["cache"],
                lockstep_logit_max_rel_err=worst["logits"], lockstep_tolerance=BLOCK_TOL,
                lockstep_encoded_bytes_differing=[diff_bytes, total_bytes])


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _parting(a: torch.Tensor, b: torch.Tensor):
    """The first token column at which two greedy runs part (None: never)."""
    cols = (a != b).any(dim=0).nonzero()[:, 0].tolist()
    return cols[0] if cols else None


@torch.inference_mode()
def serve_admission(path: dict, eng, plain, card: str):
    """The admission paths at full width, once per cache format of the
    chunked admission: 2 prompts of ADMIT_PROMPT tokens in chunks of
    ADMIT_CHUNK.  Fatal: the chunked prefill against the plain path in
    lockstep (`chunk_lockstep`); the launch counts of the counted run
    (chunked prefill, then `resume_generate` of NEW greedy tokens through
    the graph: W8A8 chunks x (linears + lm_head), retention chunks x
    layers, one eager warm-up step and the replays); the graph against the
    eager loop from the same cache, bit for bit, the final cache read from
    the caller's; for the first format, the resume in two halves against
    the one resume (`resume_in_halves`); the launches of one monolithic and
    one bucketed prefill (`one_prefill_launches`).  Recorded: the chunked and
    the bucketed (to 512) prefill against monolithic prefill on the same
    deployed weights (the last logits' largest relative difference, where
    the greedy tokens resumed from each cache part from monolithic's),
    and the three prefills' host ms in turns (chunked, bucketed,
    monolithic, monolithic, bucketed, chunked)."""
    arch = path["arch"]
    t0 = time.perf_counter()
    cfg = eng.cfg
    prompts = torch.randint(1, cfg.vocab_size, (BATCH, ADMIT_PROMPT), generator=_gen(31),
                            device="cuda")
    sched = chunk_schedule(ADMIT_PROMPT, ADMIT_CHUNK)
    log(f"== admission: {arch}, B={BATCH}, S={ADMIT_PROMPT} in chunks {sched}, then "
        f"{NEW} greedy tokens resumed through the graph")
    want_p, want_s = expected_launches(path, ADMIT_CHUNK)
    want_chunked = {k: v * len(sched) for k, v in want_p.items()}
    counted, results = dict.fromkeys(hopper.COUNTERS, 0), {}
    for fmt in path["formats"]:
        tag = f"{arch} admission" + ("" if fmt is None else f" {fmt}")
        gen = GenerationConfig(max_new_tokens=NEW, cache_format=fmt)
        out = dict(card=card, schedule=sched)
        out.update(chunk_lockstep(eng, plain, prompts, fmt))

        # The counted run: chunked prefill, then decode resumed through the graph.
        hopper.reset_launches()
        (lg_c, cache_c), t_c0 = _timed(lambda: eng.prefill_chunked(
            prompts, cache_len=ADMIT_CACHE, chunk_size=ADMIT_CHUNK,
            cache_dtype=fmt or torch.float32))
        per_chunked = dict(hopper.LAUNCHES)
        pending = lg_c.argmax(-1)
        eager_cache = serving_engine._clone(cache_c)
        cache_c0 = serving_engine._clone(cache_c)
        key = eng.graph_key(cache_c, gen)
        fresh = key not in eng._graphs
        res = eng.resume_generate(pending, cache_c, gen)
        launches = dict(hopper.LAUNCHES)
        steps = res.decode_steps + (1 if fresh else 0)     # the capture's warm-up step
        want = {k: want_chunked[k] + want_s[k] * steps for k in hopper.COUNTERS}
        log(tag, "launches per chunked prefill", per_chunked, "with the resumed decode",
            launches, "replays", res.decode_steps, "captured", fresh)
        if per_chunked != want_chunked or launches != want:
            raise RuntimeError(f"{tag}: launches {per_chunked} / {launches}, expected "
                               f"{want_chunked} / {want}")
        for k in counted:
            counted[k] += launches[k]
        got, cache_e = eager_loop(eng, pending, eager_cache, gen)
        _same_as_graph(tag, res, cache_c, got, cache_e)
        del eager_cache, cache_e
        if fmt == path["formats"][0]:
            out["resumed_in_two_halves_bit_identical"] = resume_in_halves(
                tag, eng, pending, cache_c0, res, cache_c, gen)
        del cache_c0
        out.update(graph_and_eager_bit_identical=True, launches=launches,
                   capture_s=res.capture_s,
                   resumed_decode_ms_per_token=(res.decode_s - res.capture_s) * 1e3
                   / res.decode_steps,
                   eager_decode_ms_per_token=got.decode_s * 1e3 / got.decode_steps)

        # Bucketed and monolithic prefill on the same weights, timed in turns.
        def mono():
            lg, cache = eng.prefill(prompts, cache_len=ADMIT_CACHE)
            return lg, eng._encode_cache(cache, gen)

        def bucketed():
            lg, cache = eng.prefill(prompts, cache_len=ADMIT_CACHE, bucket=True)
            return lg, eng._encode_cache(cache, gen)

        def chunked():
            return eng.prefill_chunked(prompts, cache_len=ADMIT_CACHE, chunk_size=ADMIT_CHUNK,
                                       cache_dtype=fmt or torch.float32)

        times = dict(chunked=[t_c0], bucketed=[], monolithic=[])
        runs = {}
        for name, fn in (("bucketed", bucketed), ("monolithic", mono), ("monolithic", mono),
                         ("bucketed", bucketed), ("chunked", chunked)):
            runs[name], ms = _timed(fn)
            times[name].append(ms)
        out["prefill_ms_in_turns"] = times
        out["prefill_launches"] = one_prefill_launches(tag, path, eng, prompts, gen)
        lg_m, cache_m = runs["monolithic"]
        lg_b, cache_b = runs["bucketed"]
        if not torch.equal(runs["chunked"][0], lg_c):
            raise RuntimeError(f"{tag}: two chunked prefills of one prompt differ")
        res_m = eng.resume_generate(lg_m.argmax(-1), cache_m, gen)
        res_b = eng.resume_generate(lg_b.argmax(-1), cache_b, gen)
        rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()  # noqa: E731
        out.update(chunked_vs_monolithic_logit_rel=rel(lg_c, lg_m),
                   bucketed_vs_monolithic_logit_rel=rel(lg_b, lg_m),
                   chunked_vs_monolithic_first_parting=_parting(res.tokens, res_m.tokens),
                   bucketed_vs_monolithic_first_parting=_parting(res_b.tokens, res_m.tokens),
                   bucketed_capture_s=res_b.capture_s)
        for r in (res_m, res_b):
            if r.tokens.shape != (BATCH, NEW) or not bool(((r.tokens >= 0) & (
                    r.tokens < cfg.vocab_size)).all()):
                raise RuntimeError(f"{tag}: bad tokens {r.tokens.shape}")
        log(f"{tag}:", json.dumps(out))
        results[tag] = out
        del cache_c, cache_m, cache_b, runs
    log(f"{arch} admission phase: {time.perf_counter() - t0:.1f} s")
    return counted, results


# The scheduler phase.  retnet-1.3b serves the `goodput_under_load` leg of
# the reference's serving bench (benchmarks/bench_serving.py: 8 requests,
# prompts 6-24, 8 new tokens, 2 lanes, chunks of 8; a closed-loop
# calibration, then Poisson arrivals at 0.5, 1.5 and 4.0 x the calibrated
# rate through the front end; the front end against a direct run()); qwen3-8b
# and ds3_dense each drain mixed lengths through two classes of 2 lanes.
GOODPUT = dict(requests=8, prompt_min=6, prompt_max=24, new=8, lanes=2, chunk=8,
               rate_mults=(0.5, 1.5, 4.0))
DRAIN_LENS, DRAIN_CLASSES, DRAIN_CHUNK = (6, 40, 17, 70, 25, 9), ((2, 48), (2, 80)), 16
DECODE_KERNELS = ("mxint4_matmul", "flash_decode", "flash_decode_mla")


def _summary(obs, name: str) -> dict:
    h = obs.metrics.histogram(name)
    return {k: v for k, v in h.summary().items() if k in ("count", "p50", "p99", "mean")}


def scheduler_report(sched, wall_s: float) -> dict:
    """The scheduler's serving numbers from its metrics registry."""
    c = sched.obs.metrics.snapshot()["counters"]
    return dict(wall_s=wall_s, steps=c["sched.steps"], emitted=c["sched.emitted"],
                prefill_chunks=c["sched.prefill_chunks"],
                decode_stall_steps=c["sched.decode_stall_steps"],
                tokens_per_s=c["sched.emitted"] / wall_s, capture_s=sched.capture_s,
                ttft_s=_summary(sched.obs, "sched.ttft_s"),
                inter_token_s=_summary(sched.obs, "sched.inter_token_s"),
                inter_token_admitting_s=_summary(sched.obs, "sched.inter_token_admitting_s"),
                prefill_chunk_interval_s=_summary(sched.obs,
                                                  "sched.prefill_chunk_interval_s"))


def check_class_steps(tag, sched, want_step: dict) -> None:
    """Each class step launches exactly one decode step's kernels per replay."""
    for clen, step in sched.pool.steps.items():
        got = {k: step.launches.get(k, 0) for k in hopper.COUNTERS}
        if step.graph is None or got != want_step:
            raise RuntimeError(f"{tag}: class {clen}'s captured step launches {got}, "
                               f"expected {want_step}")


@torch.inference_mode()
def class_step_identity(tag, step) -> dict:
    """One replay of a class step against its eager body from the same state:
    tokens and every store tensor bit for bit.  The state is put back after,
    so the scheduler goes on as if neither had run."""
    before, tok0 = serving_engine._clone(step.store), step.tok.clone()
    pos = step.store["pos"].tolist()
    step.graph.replay()
    got, got_tok = serving_engine._clone(step.store), step.tok.clone()
    serving_engine._write_back(step.store, before)
    step.tok.copy_(tok0)
    step.body()
    a, b = dict(serving_engine.tree_items(got)), dict(serving_engine.tree_items(step.store))
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if differ or not torch.equal(got_tok, step.tok):
        raise RuntimeError(f"{tag}: class-step replay and eager body differ at "
                           f"{differ[:4] or 'the tokens'}")
    serving_engine._write_back(step.store, before)
    step.tok.copy_(tok0)
    torch.cuda.synchronize()
    return dict(lane_positions=pos, replay_and_eager_bit_identical=True)


def _requests(vocab: int, lens, seed: int) -> list:
    g = _gen(seed)
    return [torch.randint(1, vocab, (n,), generator=g, device="cuda").tolist() for n in lens]


def scheduler_drain(path: dict, eng, card: str, classes, lens, chunk: int, seed: int,
                    new: int = GOODPUT["new"]) -> tuple[dict, dict]:
    """A drain of ``lens``-long requests through ``classes``: the class steps'
    launches per replay exact; mid-drain, once two lanes of a class sit at
    different positions, one replay against the eager body
    (`class_step_identity`); the drain's decode-kernel launches exactly its
    replays' (prefill runs W8A8 and retention only); every request's tokens
    in the vocabulary.  Returns the drain's launches and its report."""
    from repro_torch.serving import Request, RequestScheduler
    tag = f"{path['arch']} scheduler drain"
    cfg = eng.cfg
    gen = GenerationConfig(max_new_tokens=new)
    sched = RequestScheduler(eng, classes=list(classes), gen=gen, chunk_size=chunk, seed=0)
    check_class_steps(tag, sched, expected_launches(path)[1])
    for uid, p in enumerate(_requests(cfg.vocab_size, lens, seed)):
        sched.submit(Request(uid=uid, prompt=p))
    identity = None
    hopper.reset_launches()
    t0 = time.perf_counter()
    while sched.pending:
        sched.step()
        if identity is None:
            busy = [st for clen, st in sched.pool.steps.items()
                    if sum(1 for sl in sched._active if sched.pool.locate(sl)[0] == clen) == 2]
            if busy:
                launched = dict(hopper.LAUNCHES)
                identity = class_step_identity(tag, busy[0])
                hopper.LAUNCHES.update(launched)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(hopper.LAUNCHES)
    res = {f.uid: f for f in sched._finished}
    bad = [u for u, f in res.items() if len(f.tokens) != new
           or not all(0 <= t < cfg.vocab_size for t in f.tokens)]
    if len(res) != len(lens) or bad or identity is None:
        raise RuntimeError(f"{tag}: {len(res)} of {len(lens)} finished, bad {bad}, "
                           f"identity checked {identity is not None}")
    for k in DECODE_KERNELS:
        want = sum(st.replays * st.launches.get(k, 0) for st in sched.pool.steps.values())
        if launches[k] != want:
            raise RuntimeError(f"{tag}: {k} launched {launches[k]} times, the replays "
                               f"{want}")
    out = dict(card=card, classes=[list(c) for c in classes], prompt_lens=list(lens),
               chunk=chunk, launches=launches,
               replays={clen: st.replays for clen, st in sched.pool.steps.items()},
               replay_launches=sched.pool.steps[classes[0][1]].launches,
               class_step=identity, **scheduler_report(sched, wall))
    log(f"{tag}:", json.dumps(out))
    return launches, out


@torch.inference_mode()
def host_spill_run(path: dict, eng, card: str) -> dict:
    """An oversubscribed pool (one class of 2 lanes, host spill on): two
    residents decode; a spill and fetch of one of them round-trips its lane
    bit for bit; then a priority-1 arrival preempts a resident into the
    host tier, which resumes once a lane frees.  Every request's tokens
    must equal those of the same requests drained without preemption."""
    from repro_torch.serving import Request, RequestScheduler
    tag = f"{path['arch']} host spill"
    clen = GOODPUT["prompt_max"] + NEW
    reqs = _requests(eng.cfg.vocab_size, (10, 20, 14), 53)
    gen = GenerationConfig(max_new_tokens=NEW)

    def make():
        return RequestScheduler(eng, classes=[(2, clen)], gen=gen, chunk_size=GOODPUT["chunk"],
                                host_spill=True, seed=0)

    sched = make()
    for uid in (0, 1):
        sched.submit(Request(uid=uid, prompt=reqs[uid]))
    while sched.stats["emitted"] < 4:
        sched.step()
    slot = next(iter(sched._active))
    before = {k: v.clone()
              for k, v in serving_engine.tree_items(sched.pool.lane_cache(slot))}
    sched.pool.spill(slot)
    sched.pool.fetch(slot)
    after = dict(serving_engine.tree_items(sched.pool.lane_cache(slot)))
    if any(not torch.equal(before[k], after[k]) for k in before):
        raise RuntimeError(f"{tag}: a spill and fetch changed the lane's cache")
    sched.submit(Request(uid=2, prompt=reqs[2]), priority=1)
    got = {f.uid: f.tokens for f in sched.run().values()}
    plain = make()
    for uid, p in enumerate(reqs):
        plain.submit(Request(uid=uid, prompt=p))
    want = {f.uid: f.tokens for f in plain.run().values()}
    m = sched.obs.metrics
    out = dict(card=card, preempted=sched.stats["preempted"], resumed=sched.stats["resumed"],
               spills=sched.pool.spill_stats["spills"],
               bytes_to_host=sched.pool.spill_stats["bytes_to_host"],
               bytes_to_device=sched.pool.spill_stats["bytes_to_device"],
               lane_bytes=eng.cache_nbytes(clen),
               spill_ms=[x * 1e3 for x in m.histogram("pool.spill_s").samples],
               fetch_ms=[x * 1e3 for x in m.histogram("pool.fetch_s").samples],
               spill_fetch_bit_exact=True, token_identical_to_unpreempted=got == want)
    log(f"{tag}:", json.dumps(out))
    if got != want or sched.stats["preempted"] < 1 or sched.stats["resumed"] < 1:
        raise RuntimeError(f"{tag}: {out}; tokens {got} vs {want}")
    return out


def goodput_leg(path: dict, eng, card: str) -> dict:
    """The reference's `goodput_under_load` leg on the port, at full width
    (see GOODPUT): calibration, the three Poisson rates through the front
    end (each on a fresh scheduler, warmed by a closed drain and reset), and
    the front end against a direct run() on the same requests, token for
    token."""
    import asyncio

    from repro_torch.obs import Observability
    from repro_torch.serving import (FrontendConfig, LengthMix, MonotonicClock,
                                     PoissonArrivals, Request, RequestScheduler,
                                     ServingFrontend, Workload, run_open_loop)
    g = GOODPUT
    gen = GenerationConfig(max_new_tokens=g["new"])
    mix = LengthMix(prompt_min=g["prompt_min"], prompt_max=g["prompt_max"],
                    new_min=g["new"], new_max=g["new"])
    clen = g["prompt_max"] + g["new"]
    vocab = eng.cfg.vocab_size
    warm_wl = Workload(arrivals=PoissonArrivals(1.0), lengths=mix, n_requests=g["requests"],
                       vocab_size=vocab, seed=29)

    def make_sched(obs, clock):
        return RequestScheduler(eng, classes=[(g["lanes"], clen)], gen=gen,
                                chunk_size=g["chunk"], seed=0, obs=obs, clock=clock.now)

    def closed_drain(sched, uid_base):
        for i, r in enumerate(warm_wl.requests()):
            sched.submit(Request(uid=uid_base + i, prompt=list(r.prompt),
                                 max_new_tokens=r.max_new_tokens))
        return sched.run()

    obs, clock = Observability(), MonotonicClock()
    sched = make_sched(obs, clock)
    check_class_steps(f"{path['arch']} goodput", sched, expected_launches(path)[1])
    closed_drain(sched, 5000)
    obs.metrics.reset()
    t0 = time.perf_counter()
    closed_drain(sched, 6000)
    torch.cuda.synchronize()
    calib_wall = max(time.perf_counter() - t0, 1e-6)
    base_rate = g["requests"] / calib_wall
    calib = scheduler_report(sched, calib_wall)
    slo_s = max(2.0 * calib["ttft_s"].get("p50", 0.05), 0.02)
    cfg = FrontendConfig(ttft_slo_s=slo_s, slo_window_s=max(4 * calib_wall, 1.0),
                         min_slo_samples=4, guaranteed_admit=g["lanes"])
    del sched
    rates = []
    for mult in g["rate_mults"]:
        leg_obs, leg_clock = Observability(), MonotonicClock()
        leg = make_sched(leg_obs, leg_clock)
        closed_drain(leg, 7000)
        leg_obs.metrics.reset()
        frontend = ServingFrontend(leg, config=cfg, clock=leg_clock)
        workload = Workload(arrivals=PoissonArrivals(base_rate * mult), lengths=mix,
                            n_requests=g["requests"], vocab_size=vocab, seed=13)

        async def drive(frontend=frontend, workload=workload):
            async with frontend:
                return await run_open_loop(frontend, workload)

        report = leg_clock.run(drive())
        if report.goodput_rps <= 0 or report.sheds_unexplained:
            raise RuntimeError(f"goodput leg at {mult}x: {report.to_dict()}")
        rates.append(dict(rate_mult=mult, **report.to_dict(),
                          scheduler=scheduler_report(leg, report.elapsed_s)))
        log(f"goodput at {mult} x {base_rate:.3f} req/s:", json.dumps(rates[-1]))
        del leg, frontend

    fe_sched = make_sched(Observability(), MonotonicClock())
    fe_clock = MonotonicClock(fe_sched._now)
    frontend = ServingFrontend(fe_sched, config=FrontendConfig(ttft_slo_s=slo_s,
                                                               shed_action="off"),
                               clock=fe_clock)
    id_requests = Workload(arrivals=PoissonArrivals(base_rate), lengths=mix,
                           n_requests=g["requests"], vocab_size=vocab, seed=17).requests()

    async def drive_identity() -> dict:
        tokens: dict = {}

        async def consume(stream):
            tokens[stream.uid] = [tok async for tok in stream]

        async with frontend:
            tasks, t0 = [], fe_clock.now()
            for r in id_requests:
                await fe_clock.sleep(t0 + r.at_s - fe_clock.now())
                stream = frontend.submit(r.prompt, uid=r.uid, max_new_tokens=r.max_new_tokens)
                tasks.append(asyncio.ensure_future(consume(stream)))
            await asyncio.gather(*tasks)
        return tokens

    fe_tokens = fe_clock.run(drive_identity())
    direct = make_sched(Observability(), MonotonicClock())
    for r in id_requests:
        direct.submit(Request(uid=r.uid, prompt=list(r.prompt),
                              max_new_tokens=r.max_new_tokens))
    want = {u: f.tokens for u, f in direct.run().items()}
    identical = fe_tokens == want
    out = dict(arch=path["arch"], card=card, n_requests=g["requests"],
               device_lanes=g["lanes"], arrival="poisson", calibrated_service_rps=base_rate,
               ttft_slo_s=slo_s, calibration=calib, rates=rates,
               token_identical_vs_run=identical)
    log("goodput_under_load (rates above):",
        json.dumps({k: v for k, v in out.items() if k != "rates"}))
    if not identical:
        raise RuntimeError(f"goodput leg: the front end's tokens {fe_tokens} differ from "
                           f"a direct run()'s {want}")
    return out


def serve_scheduler(path: dict, eng, card: str) -> tuple[dict, dict]:
    """The scheduler phase of one main path at full width (see GOODPUT):
    retnet-1.3b serves the goodput leg and the host-spill run, each path
    one drain of mixed lengths through two classes (its per-lane kv_len
    through flash-decode on the dense paths).  Returns the drain's
    launches and the results."""
    t0 = time.perf_counter()
    arch = path["arch"]
    log(f"== scheduler: {arch}, classes {DRAIN_CLASSES}, prompts {DRAIN_LENS}, "
        f"chunks of {DRAIN_CHUNK}" + (", then the goodput leg and the host spill"
                                      if path is RETNET else ""))
    launches, drain = scheduler_drain(path, eng, card, DRAIN_CLASSES, DRAIN_LENS,
                                      DRAIN_CHUNK, seed=47)
    results = {f"{arch} scheduler drain": drain}
    if path is RETNET:
        results["goodput_under_load"] = goodput_leg(path, eng, card)
        results[f"{arch} host spill"] = host_spill_run(path, eng, card)
    log(f"{arch} scheduler phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return launches, results


def one_prefill_launches(tag, path, eng, prompts, gen) -> dict:
    """Launches of one monolithic and one bucketed prefill of the admission
    prompts, each exact: retention runs every length through the kernel
    (500 = 3 x 128 + 116: two launches per layer; the 512 bucket one)."""
    out = {}
    for name, bucket in (("monolithic", False), ("bucketed", True)):
        hopper.reset_launches()
        eng.prefill(prompts, cache_len=ADMIT_CACHE, bucket=bucket)
        got = dict(hopper.LAUNCHES)
        want = expected_launches(path, bucket_length(ADMIT_PROMPT) if bucket
                                 else ADMIT_PROMPT)[0]
        if got != want:
            raise RuntimeError(f"{tag}: a {name} prefill launches {got}, expected {want}")
        out[name] = got
    return out


def resume_in_halves(tag, eng, pending, cache0, whole, whole_cache, gen) -> bool:
    """`resume_generate` of NEW // 2 tokens, then of NEW // 2 more from the
    cache it left and its ``next_token``, against one resume of NEW tokens
    from the same cache: tokens and final cache bit for bit."""
    half = dataclasses.replace(gen, max_new_tokens=NEW // 2)
    first = eng.resume_generate(pending, cache0, half)
    second = eng.resume_generate(first.next_token, cache0, half)
    halves = GenerationResult(tokens=torch.cat([first.tokens, second.tokens], dim=1),
                              lengths=first.lengths + second.lengths, prefill_s=0.0,
                              decode_s=0.0, decode_steps=NEW)
    _same_as_graph(f"{tag} resumed in halves", whole, whole_cache, halves, cache0)
    if not torch.equal(second.next_token, whole.next_token):
        raise RuntimeError(f"{tag}: resumed in halves, the next token differs")
    return True


def serve_cli() -> dict:
    """`python -m repro_torch.launch.serve` at full width on the card, one
    subprocess per mode: greedy and top-p generate, the scheduler, the front
    end on virtual time (its smoke contract: nonzero goodput, no unexplained
    shed), and the oversubscribed host-spill scheduler writing its trace and
    metrics.  Each must exit 0 and print its ``[serve]`` lines, the last
    the mode's own."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        trace, metrics = os.path.join(tmp, "trace.json"), os.path.join(tmp, "metrics.json")
        modes = (("greedy", [], "[serve] sample output tokens"),
                 ("top_p", ["--temperature", "1", "--top-p", str(TOP_P)],
                  "[serve] sample output tokens"),
                 ("scheduler", ["--requests", "6", "--slots", "4", "--chunk-size", "8"],
                  "[serve] tokens/s"),
                 ("frontend", ["--frontend", "--virtual-clock", "--requests", "8", "--slots",
                               "2", "--chunk-size", "8"], "[serve] frontend smoke OK"),
                 ("host_spill", ["--requests", "6", "--host-spill", "--oversubscribe", "2",
                                 "--chunk-size", "8", "--trace", trace, "--metrics", metrics],
                  "[serve] metrics snapshot"))
        for name, extra, last in modes:
            cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "retnet-1.3b",
                   "--scenario", "SILO", "--scale", "0.1", "--batch", "2", *extra]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                                  env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[serve]")]
            for ln in lines:
                log(f"  cli {name}: {ln}")
            if proc.returncode != 0 or not lines or not lines[-1].startswith(last):
                raise RuntimeError(f"serve CLI ({name}) exited {proc.returncode} with "
                                   f"{len(lines)} [serve] lines: {proc.stderr[-2000:]}")
            out[name] = dict(seconds=time.perf_counter() - t0, lines=lines)
        snap = json.load(open(metrics))["counters"]
        events = json.load(open(trace))["traceEvents"]
        if snap["sched.preempted"] < 1 or snap["sched.resumed"] != snap["sched.preempted"] \
                or not any(e["name"] == "preempt" for e in events):
            raise RuntimeError(f"serve CLI (host_spill): no preemption recorded: {snap}")
        out["host_spill"].update(metrics_counters=snap, trace_events=len(events))
    return out


def _device_us(prof) -> tuple[float, list]:
    """Kernel time in us (device-side events only: the CPU ops that launched
    them carry the same time again) and the top kernels in ms."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    evs.sort(key=lambda e: -e.self_device_time_total)
    top = [(e.key[:60], e.self_device_time_total / 1e3, e.count) for e in evs[:6]]
    return sum(e.self_device_time_total for e in evs), top


@torch.inference_mode()
def profile_shares(eng, prompts, gen, steps: int = 4) -> dict:
    """Device busy share of a prefill, of eager decode steps and of replays
    of the captured step, with the top kernels by device time (torch.profiler;
    it inflates the host side, so the busy shares are lower bounds)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = eng.prefill(prompts, cache_len=CACHE_LEN)
        cache = eng._encode_cache(cache, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, top = _device_us(prof)
    out.update(prefill_device_busy=dev / 1e6 / wall, prefill_top_ms=top)
    tok = logits.argmax(-1)
    graph = eng._graphs[eng.graph_key(cache, gen)]
    graph.state.reset(tok, cache, gen)
    for name, step in (("eager_", lambda: eng.decode_step(tok[:, None], cache)),
                       ("", graph.graph.replay)):
        with profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev, top = _device_us(prof)
        if not dev:
            out[f"{name}decode_profile"] = "not measured: the profiler saw no device time"
            continue
        out.update({f"{name}decode_device_busy": dev / 1e6 / wall,
                    f"{name}decode_device_ms_per_step": dev / 1e3 / steps,
                    f"{name}decode_top_ms_per_step": [(n, t / steps, c // steps)
                                                      for n, t, c in top]})
    return out


def _clone(tree):
    """A copy of a cache whose tensors a step may write in place (dense KV
    leaves); the rope state is never written in place and is shared."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree


def _prefill_from(model, x, cfg, hsa):
    """`lm.forward_prefill` from embedded inputs ``x``: last-token logits."""
    sin, cos = lm._rope_tables(cfg, x.shape[1], x.device)
    for blk in model.blocks:
        x = lm._block_apply(blk, x, cfg, hsa, "prefill", sin, cos)[0].to(x.dtype)
    h = layers.norm_full(model.final_norm, x[:, -1:])
    return hsa.linear(model.lm_head, h, "prefill")[:, 0]


@torch.inference_mode()
def compare_paths(eng, plain, prompts, gen):
    """Kernel path vs plain path on the same weights.

    * Per block, in lockstep: both paths get the plain path's input to the
      block; outputs within BLOCK_TOL of max|output|.  A wrong kernel shows
      here, at the block that runs it.
    * Prefill logits end to end, within PREFILL_TOL of max|logit|, beside the
      network's own sensitivity: the plain path against itself with one
      token's embedding moved by one bf16 step.  Random weights, a bf16
      residual stream and per-linear int8 activation rounding make that
      floor large, so no end-to-end bound can be tighter than it.
    * Decode the same way, each step starting both paths from the plain
      path's cache (in ``gen.cache_format``) and token, each on its own copy
      of the cache: every block in lockstep within DECODE_BLOCK_TOL (decode
      streams MXINT4 weights against f32 activations, with no int8 rounding,
      so only f32 summation order differs, and each path encodes its own new
      K/V row), and the logits within DECODE_TOL beside the decode step's own
      one-bf16-step sensitivity.  Where the two paths' greedy tokens from the
      same cache differ, ``decode_argmax_flips`` lists the step, the batch
      lane and the plain path's margin between its top two logits, relative
      to max|logit|: a flip at a margin under ``decode_logit_max_rel_err``
      is a near tie that f32 summation order decides.
    """
    cfg, model = eng.cfg, eng.model
    x = lm._embed(model, prompts)
    sin, cos = lm._rope_tables(cfg, x.shape[1], x.device)
    block = []
    for i, blk in enumerate(model.blocks):
        yr = lm._block_apply(blk, x, cfg, plain.hsa, "prefill", sin, cos)[0]
        yk = lm._block_apply(blk, x, cfg, eng.hsa, "prefill", sin, cos)[0]
        block.append(_rel(yk, yr, f"prefill block {i}", BLOCK_TOL))
        x = yr.to(x.dtype)

    lk, _ = eng.prefill(prompts)
    lr, cache = plain.prefill(prompts, cache_len=CACHE_LEN)
    cache = plain._encode_cache(cache, gen)
    prefill = _rel(lk, lr, "prefill logits", PREFILL_TOL)
    x = lm._embed(model, prompts).clone()
    x[0, PROMPT // 2] = _bf16_step(x[0, PROMPT // 2])
    floor = _rel(_prefill_from(model, x, cfg, plain.hsa), lr, "sensitivity", float("inf"))

    decode, dblock, dfloor, flips = [], [], [], []
    tok = lr.argmax(-1)
    for i in range(NEW):
        lk, _ = eng.decode_step(tok[:, None], _clone(cache))
        lr, nxt = plain.decode_step(tok[:, None], _clone(cache))
        decode.append(_rel(lk, lr, f"decode step {i}", DECODE_TOL))
        top2 = lr.float().topk(2, dim=-1).values
        for b in (lk.argmax(-1) != lr.argmax(-1)).nonzero()[:, 0].tolist():
            flips.append((i, b, ((top2[b, 0] - top2[b, 1]) / lr.float().abs().max()).item()))
        dblock.append(_decode_lockstep(eng, plain, tok, cache, i))
        x = lm._embed(model, tok[:, None]).clone()
        x[0] = _bf16_step(x[0])
        dfloor.append(_rel(_decode_from(model, x, _clone(cache), cfg, plain.hsa), lr,
                           "sensitivity", float("inf")))
        cache, tok = nxt, lr.argmax(-1)
    return dict(block_max_rel_err=max(block), block_tolerance=BLOCK_TOL,
                prefill_logit_rel_err=prefill, prefill_tolerance=PREFILL_TOL,
                prefill_sensitivity_floor=floor,
                decode_block_max_rel_err=max(dblock),
                decode_block_tolerance=DECODE_BLOCK_TOL,
                decode_logit_max_rel_err=max(decode), decode_tolerance=DECODE_TOL,
                decode_sensitivity_floor_max=max(dfloor), decode_argmax_flips=flips)


def _appends(engine, prompts, gen):
    """The eager loop (`eager_generate`) with every one-row cache write
    recorded: per decode step, each written leaf's row before encoding (f32)
    and as stored."""
    real, rows = layers.cache_update, []

    def spy(leaf, x, pos):
        out = real(leaf, x, pos)
        if x.shape[1] == 1:
            slot = min(int(pos), layers.cache_capacity(out) - 1)
            stored = ({k: v[:, slot].clone() for k, v in out.items()}
                      if isinstance(out, dict) else out[:, slot].clone())
            rows.append((x[:, 0].float().clone(), stored))
        return out

    layers.cache_update = spy
    try:
        res, _ = eager_generate(engine, prompts, gen)
    finally:
        layers.cache_update = real
    per = len(rows) // res.decode_steps
    return res, [rows[i * per:(i + 1) * per] for i in range(res.decode_steps)]


def _quant_step(x: torch.Tensor, stored) -> torch.Tensor:
    """The rounding step each element of row ``x`` had when it was stored."""
    if isinstance(stored, dict) and "e" in stored:          # mxint4_blk
        return torch.exp2(stored["e"].float() - mx.MANT_SHIFT).repeat_interleave(
            mx.GROUP_SIZE, dim=-1)
    if isinstance(stored, dict):                            # int8_tok
        return stored["s"].expand_as(x)
    bits = {torch.bfloat16: 8, torch.float16: 11}.get(stored.dtype, 24)
    return torch.exp2(torch.frexp(x)[1].float() - bits)


def _row_parting(xk, sk, xr, sr) -> dict | None:
    """Where one appended row's stored bytes differ between the two paths:
    the elements whose stored value differs and the side entries (mxint4_blk
    exponents, int8_tok scales) that differ; for up to four such elements,
    both paths' values before encoding, their gap, and each one's distance
    from the nearest rounding boundary, in its own rounding steps (0: on
    the boundary, 0.5: on a code).  ``col`` indexes the row flattened per
    batch lane (a GQA row is ``[KV heads, head dim]``)."""
    vk, vr = kvq.decode(sk), kvq.decode(sr)
    side = {k: int((sk[k] != sr[k]).sum()) for k in ("e", "s")
            if isinstance(sk, dict) and k in sk}
    diff = vk != vr
    if not bool(diff.any()) and not any(side.values()):
        return None
    stk, str_ = _quant_step(xk, sk), _quant_step(xr, sr)
    vk, vr, xk, xr, stk, str_, diff = (t.reshape(t.shape[0], -1)
                                       for t in (vk, vr, xk, xr, stk, str_, diff))
    to_edge = lambda x, st: ((x / st) - torch.floor(x / st) - 0.5).abs()  # noqa: E731
    out = dict(values_differing=int(diff.sum()), side_differing=side,
               pre_encode_max_rel_gap=((xk - xr).abs().max() / xr.abs().max()).item(),
               elements=[])
    for b, j in diff.nonzero()[:4].tolist():
        out["elements"].append(dict(
            lane=b, col=j, kernel=xk[b, j].item(), plain=xr[b, j].item(),
            gap_in_steps=((xk[b, j] - xr[b, j]).abs() / str_[b, j]).item(),
            kernel_to_boundary=to_edge(xk[b, j], stk[b, j]).item(),
            plain_to_boundary=to_edge(xr[b, j], str_[b, j]).item(),
            stored=(vk[b, j].item(), vr[b, j].item())))
    return out


@torch.inference_mode()
def free_running(eng, plain, prompts, gen):
    """Both paths generating on their own through the eager loop (whose
    tokens and cache the graph's match bit for bit, `_same_as_graph`): each
    decode step appends the rows its own path computed to its own cache.
    Returns both paths' results (the times are of these recorded runs) and
    where the two part: the first token column that differs (token i + 1
    comes from decode step i, which appends the rows of token i), and the
    first decode step whose appended rows differ in their stored bytes, with
    each differing write there (``write``: the order of the step's cache
    writes, two per layer, K or latent then V or rope) as `_row_parting`
    gives it, and how many steps before the first token flip had such rows.
    Rows that part from the same tokens, from nearby values either side of
    a rounding boundary, before any token flips, are the caches drifting
    apart through their encoding; a flip with no parted row before it would
    point at the attention itself."""
    res_k, rows_k = _appends(eng, prompts, gen)
    res_p, rows_p = _appends(plain, prompts, gen)
    tk, tp = res_k.tokens, res_p.tokens
    cols = (tk != tp).any(dim=0).nonzero()[:, 0].tolist()
    flip = cols[0] if cols else None
    first, steps = None, 0
    for i, (rk, rp) in enumerate(zip(rows_k, rows_p)):
        if flip is not None and i >= flip:
            break
        parted = [dict(write=w, **d) for w, ((xk, sk), (xr, sr)) in enumerate(zip(rk, rp))
                  if (d := _row_parting(xk, sk, xr, sr)) is not None]
        if parted:
            steps += 1
            first = first or dict(step=i, writes=parted)
    return res_k, res_p, dict(first_token_flip=flip, first_parted_rows=first,
                              steps_with_parted_rows_before_flip=steps)


def _bf16_step(row: torch.Tensor) -> torch.Tensor:
    """Move a bf16 row by one rounding step (relative 2^-7)."""
    return (row.float() * (1 + 2 ** -7)).to(row.dtype)


def _decode_from(model, x, cache, cfg, hsa):
    """`lm.forward_decode` from embedded inputs ``x``: logits."""
    st, pos = cache["rope"], cache["pos"]
    for blk, c in zip(model.blocks, cache["blocks"]):
        x = lm._block_decode(blk, x, cfg, hsa, c, pos, st.sin, st.cos)[0].to(x.dtype)
    return hsa.linear(model.lm_head, layers.norm_full(model.final_norm, x),
                      "decode")[:, 0]


def _decode_lockstep(eng, plain, tok, cache, step):
    cfg, model = eng.cfg, eng.model
    st, pos = cache["rope"], cache["pos"]
    x = lm._embed(model, tok[:, None])
    worst = 0.0
    for i, (blk, c) in enumerate(zip(model.blocks, cache["blocks"])):
        yr = lm._block_decode(blk, x, cfg, plain.hsa, _clone(c), pos, st.sin, st.cos)[0]
        yk = lm._block_decode(blk, x, cfg, eng.hsa, _clone(c), pos, st.sin, st.cos)[0]
        worst = max(worst, _rel(yk, yr, f"decode step {step} block {i}",
                                DECODE_BLOCK_TOL))
        x = yr.to(x.dtype)
    return worst


def _rel(a, b, what, tol):
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise RuntimeError(f"{what}: non-finite values")
    rel = ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
    if rel > tol:
        raise RuntimeError(f"{what}: kernel vs plain differ by {rel:.3e} of "
                           f"max|value| > {tol}")
    return rel


def reduced_vs_cpu(path: dict):
    """The reduced model: the kernel path on the card against the plain path
    on the CPU, same weights (a small-input reference check), once per cache
    format."""
    spec = EngineSpec(reduced="reduced" not in path)
    arch = path["arch"]
    eng = InferenceEngine.from_config(path.get("reduced", arch), spec, device="cuda")
    cpu = InferenceEngine(eng.cfg, copy.deepcopy(eng.model).to("cpu"), spec)
    prompts = torch.randint(1, eng.cfg.vocab_size, (2, 16), generator=_gen(3),
                            device="cuda")
    lg, _ = eng.prefill(prompts)
    lc, _ = cpu.prefill(prompts.cpu())
    rel = _rel(lg.cpu(), lc, f"reduced {arch} prefill", LOGIT_TOL)
    agree = {}
    for fmt in path["formats"]:
        gen = GenerationConfig(max_new_tokens=12, cache_format=fmt)
        tg = eng.generate(prompts, gen).tokens.cpu()
        tc = cpu.generate(prompts.cpu(), gen).tokens
        agree[fmt or "f32"] = (tg == tc).float().mean().item()
    log(f"reduced {arch}, card kernels vs CPU plain: prefill rel err {rel:.3e}, "
        f"greedy-token agreement {agree}")
    return {f"reduced {arch}": dict(prefill_rel_err=rel, greedy_agreement=agree)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need the card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"{name} is sm_{cap[0]}{cap[1]}; the kernels target sm_90a")
    peaks = card_peaks(name)
    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    log("python", sys.version.split()[0], "torch", torch.__version__, "cuda",
        torch.version.cuda)

    t0 = time.perf_counter()
    reports = hopper.build()
    for kname, rep in reports.items():
        log(f"built {kname}: {json.dumps(ptxas_summary(rep))}")
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("== kernel phases (full-width shapes; times in ms, median, cold L2)")
    one = torch.zeros(1, device="cuda")
    log(f"time_ms floor (one 1-element fill per replay): {time_ms(lambda: one.fill_(1.0)):.4f}")
    ones = [torch.zeros(1, device="cuda") for _ in range(RMS_AMORTISED)]
    log(f"amortised_ms floor ({RMS_AMORTISED} 1-element fills per replay): "
        f"{amortised_ms(lambda t: t.fill_(1.0), ones):.4f}")
    entries = [
        summarize("mxint4_matmul", kernel_phase_mxint4(peaks), "per_step",
                  "rtol=atol=1e-5"),
        summarize("w8a8_matmul", kernel_phase_w8a8(peaks), "per_prefill", "exact"),
        summarize("retention_chunkwise", kernel_phase_retention(peaks), "per_prefill",
                  "rtol=atol=1e-4"),
        summarize("flash_decode", kernel_phase_flash_decode(peaks), "per_step",
                  "rtol=2e-5, atol=2e-6"),
        summarize("flash_decode_mla", kernel_phase_flash_decode_mla(peaks), "per_step",
                  "rtol=2e-5, atol=2e-6"),
        summarize("rmsnorm_stats", kernel_phase_rmsnorm_stats(peaks), "per_call",
                  "rtol=atol=1e-6"),
    ]
    for e in entries:
        for r in e["shapes"]:
            extra = "".join(f" {key} {r[key]}" for key in (
                "library_rowmajor_ms", "library_gqa_ms", "library_backend",
                "library_max_abs_err", "rate", "library_rate", "bound_share",
                "bound_f32_ms", "bound_share_f32", "plain_contiguous_ms", "flops",
                "warm_state_max_abs_err", "f64_max_abs_err", "amortised_ms", "per_lane_ms",
                "per_lane_kv_len", "per_lane_max_abs_err",
                "amortised_bound_share", "nearest_library_ms",
                "site", "launch_kernels", "plan")
                if key in r)
            log(f"  {e['name']} {r['path']} {r['shape']}: kernel {r['ms']:.4f} (per call "
                f"{r['call_ms']:.4f}) plain {r['plain_ms']:.4f} library "
                f"{r['library_ms']} bound {r['bound_ms']:.4f} ({r['bound_by']}) "
                f"err {r['max_abs_err']:.2e}{extra}")
    rms = next(e for e in entries if e["name"] == "rmsnorm_stats")
    rms["sigma_chain"] = sigma_chain_price()
    for r in rms["sigma_chain"]:
        log(f"  sigma^-1 price: {json.dumps(r)}")
    log(f"kernel phases: {time.perf_counter() - t0:.1f} s")

    serving, by_path, admitted, scheduled = {}, {}, {}, {}
    for path in PATHS:
        (by_path[path["arch"]], admitted[path["arch"]], scheduled[path["arch"]],
         results) = serve_full_width(path, smi)
        serving.update(results)
    for path in PATHS:
        serving.update(reduced_vs_cpu(path))
    t0 = time.perf_counter()
    serving["serve CLI"] = serve_cli()
    log(f"serve CLI: {time.perf_counter() - t0:.1f} s")
    for e in entries:
        e["launches_by_path"] = {arch: n[e["name"]] for arch, n in by_path.items()}
        e["launches"] = sum(e["launches_by_path"].values())
        e["admission_launches_by_path"] = {arch: n[e["name"]]
                                           for arch, n in admitted.items()}
        e["scheduler_launches_by_path"] = {arch: n[e["name"]]
                                           for arch, n in scheduled.items()}
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"serving": serving}))
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
