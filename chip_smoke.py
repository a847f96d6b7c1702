#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: kernels, then serving.

    python3 chip_smoke.py

Phases, each fatal on a miss (no CPU fallback, nonzero exit):

1. the card's name and power limit (``nvidia-smi``);
2. build every Hopper kernel from ``src/repro_torch/kernels/csrc`` (nvcc,
   one process per source, in parallel);
3. each kernel at the main path's full-width shapes against its plain
   PyTorch version on the same inputs, with its tolerance; times (CUDA events,
   L2 flushed before every launch, median), the bound from the card's data
   sheet and, where one PyTorch call computes the same product, its time;
4. full-width retnet-1.3b (24 layers, d_model 2048, seeded random weights,
   W8A8/MXINT4 deployment) serving 2 prompts of 512 tokens plus 32 greedy
   tokens through ``InferenceEngine.generate``, with the launch counters
   set to 0 just before and read just after; then the same weights on the
   plain path (``kernel_impl="ref"``): every block in lockstep, prefill
   logits beside the network's own sensitivity, every decode step's logits,
   greedy-token agreement (see `compare_paths`); and reduced retnet-1.3b on
   the card against the CPU plain path;
5. one JSON line ``{"kernels": [...]}`` and, last, the ``{"ok": true, ...}``
   line.

It imports neither jax nor the JAX package.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.core import mxint4 as mx  # noqa: E402
from repro_torch.core import retention as ret  # noqa: E402
from repro_torch.kernels import hopper, ops, ref  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.serving.engine import EngineSpec, InferenceEngine  # noqa: E402
from repro_torch.serving.sampling import GenerationConfig  # noqa: E402

# Data-sheet peaks (NVIDIA, dense): bytes/s of device memory, and operations/s
# for int8 on the tensor cores and for f32 on the CUDA cores.
PEAKS = {
    "H100 SXM": dict(bytes=3.35e12, int8=1979e12, f32=67e12),
    "H100 PCIe": dict(bytes=2.0e12, int8=1513e12, f32=51e12),
    "H200": dict(bytes=4.8e12, int8=1979e12, f32=67e12),
}
SRC = {
    "mxint4_matmul": ("src/repro_torch/kernels/csrc/mxint4_matmul.cu",
                      "src/repro/kernels/mxint4_matmul.py:77"),
    "w8a8_matmul": ("src/repro_torch/kernels/csrc/w8a8_matmul.cu",
                    "src/repro/kernels/w8a8_matmul.py:52"),
    "retention_chunkwise": ("src/repro_torch/kernels/csrc/retention_chunkwise.cu",
                            "src/repro/kernels/retention_kernel.py:70"),
}
# Full-width retnet-1.3b: per layer (K, N, linears of that shape).
LAYER_LINEARS = ((2048, 2048, 2), (2048, 4096, 3), (4096, 2048, 2))
N_LAYERS, VOCAB, D = 24, 32768, 2048
BATCH, PROMPT, NEW = 2, 512, 32
# Kernel path vs plain path, relative to max|value| (see `compare_paths`).
BLOCK_TOL = 2e-2         # prefill block, same input: an int8 rounding step
DECODE_BLOCK_TOL = 1e-3  # decode block, same input: f32 summation order only
PREFILL_TOL = 0.5        # end to end; the plain path's own one-bf16-step
                         # sensitivity measured 0.26 on an H100 (PERF.md)
DECODE_TOL = 0.1         # one decode step end to end from the same cache
LOGIT_TOL = 2e-2         # reduced model, card kernels vs CPU plain path


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


def kernel_phase_mxint4(peaks):
    cases = [(k, n, c * N_LAYERS) for k, n, c in LAYER_LINEARS] + [(D, VOCAB, 1)]
    rows, m = [], BATCH
    for k, n, count in cases:
        g = _gen(k + n)
        x = torch.randn(m, k, generator=g, device="cuda")
        w = torch.randn(k, n, generator=g, device="cuda") * k ** -0.5
        q = mx.quantize_mxint4(w)
        os_ = torch.rand(n, generator=g, device="cuda") + 0.5
        rs = torch.rand(m, generator=g, device="cuda") + 0.5
        b = torch.randn(n, generator=g, device="cuda")
        got = ops.mxint4_matmul(x, q, os_, rs, b, impl="kernel")
        want = ref.mxint4_matmul_ref(x, q, os_, rs, b)
        err = _check(f"mxint4 {k}x{n}", got, want, 1e-5, 1e-5)
        w_deq = mx.dequantize_mxint4(q, dtype=torch.float32)
        nbytes = 4 * m * k + k * n // 2 + k * n // 32 + 4 * (2 * n + m) + 4 * m * n
        bms, by = bound_ms(nbytes, 2 * m * k * n, peaks["f32"], peaks)
        rows.append(dict(
            shape=[m, k, n], per_step=count, max_abs_err=err,
            ms=time_ms(lambda: ops.mxint4_matmul(x, q, os_, rs, b, impl="kernel")),
            call_ms=call_ms(lambda: ops.mxint4_matmul(x, q, os_, rs, b, impl="kernel")),
            plain_ms=time_ms(lambda: ref.mxint4_matmul_ref(x, q, os_, rs, b)),
            library_ms=time_ms(lambda: x @ w_deq), bound_ms=bms, bound_by=by))
    return rows


def kernel_phase_w8a8(peaks):
    m_full = BATCH * PROMPT
    cases = [(m_full, k, n, c * N_LAYERS) for k, n, c in LAYER_LINEARS]
    cases.append((BATCH, D, VOCAB, 1))
    rows = []
    for m, k, n, count in cases:
        g = _gen(m + k + n)
        xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda").to(torch.int8)
        wq = torch.randint(-127, 128, (k, n), generator=g, device="cuda").to(torch.int8)
        sc = torch.tensor(1e-4, device="cuda")
        rs = torch.rand(m, generator=g, device="cuda") + 0.5
        b = torch.randn(n, generator=g, device="cuda")
        got = ops.w8a8_matmul(xq, wq, sc, rs, b, impl="kernel")
        want = ref.w8a8_matmul_ref(xq, wq, sc, rs, b)
        err = _check(f"w8a8 {m}x{k}x{n}", got, want, 0.0, 0.0)   # exact
        # torch._int_mm needs M > 16: the M = 2 lm_head is timed padded to 32
        # rows (noted as library_rows).
        xl = xq if m > 16 else torch.nn.functional.pad(xq, (0, 0, 0, 32 - m))
        nbytes = m * k + k * n + 4 * (2 * n + m) + 4 * m * n
        bms, by = bound_ms(nbytes, 2 * m * k * n, peaks["int8"], peaks)
        rows.append(dict(
            shape=[m, k, n], per_prefill=count, max_abs_err=err,
            ms=time_ms(lambda: ops.w8a8_matmul(xq, wq, sc, rs, b, impl="kernel")),
            call_ms=call_ms(lambda: ops.w8a8_matmul(xq, wq, sc, rs, b, impl="kernel")),
            plain_ms=time_ms(lambda: ref.w8a8_matmul_ref(xq, wq, sc, rs, b)),
            library_ms=time_ms(lambda: torch._int_mm(xl, wq)),
            library_rows=xl.shape[0], bound_ms=bms, bound_by=by))
    return rows


def kernel_phase_retention(peaks):
    h, dk, dv, c = 8, D // 8, 2 * D // 8, 128
    g = _gen(7)
    q, k = (torch.randn(BATCH, h, PROMPT, dk, generator=g, device="cuda") * dk ** -0.5
            for _ in range(2))
    v = torch.randn(BATCH, h, PROMPT, dv, generator=g, device="cuda")
    gamma = ret.head_decays(h, device="cuda")
    rows = []
    for warm in (False, True):
        st = (torch.randn(BATCH, h, dk, dv, generator=g, device="cuda") * 0.1
              if warm else None)
        y, s = ops.retention_chunkwise(q, k, v, gamma, chunk=c, state=st, impl="kernel")
        y_r, s_r = ref.retention_chunkwise_ref(q, k, v, gamma, chunk=c, state=st)
        err = max(_check("retention y", y, y_r, 1e-4, 1e-4),
                  _check("retention state", s, s_r, 1e-4, 1e-4))
        if warm:           # off the main path: checked, not timed
            rows[0]["warm_state_max_abs_err"] = err
            continue
        bh, n_chunks = BATCH * h, PROMPT // c
        flops = bh * n_chunks * (2 * c * c * (dk + dv) + 4 * c * dk * dv)
        nbytes = 4 * bh * PROMPT * (2 * dk + 2 * dv) + 4 * bh * dk * dv + 4 * h
        bms, by = bound_ms(nbytes, flops, peaks["f32"], peaks)
        rows.append(dict(
            shape=[BATCH, h, PROMPT, dk, dv, c], per_prefill=N_LAYERS, max_abs_err=err,
            ms=time_ms(lambda: ops.retention_chunkwise(q, k, v, gamma, chunk=c,
                                                       impl="kernel")),
            call_ms=call_ms(lambda: ops.retention_chunkwise(q, k, v, gamma, chunk=c,
                                                            impl="kernel")),
            plain_ms=time_ms(lambda: ref.retention_chunkwise_ref(q, k, v, gamma, chunk=c)),
            library_ms=None, bound_ms=bms, bound_by=by))
    return rows


def summarize(name, rows, per_key, tol):
    """One `kernels` entry: times and bounds summed over one main-path unit
    (a decode step for mxint4, a prefill for the others)."""
    def total(key):
        if any(r[key] is None for r in rows):
            return None
        return sum(r[key] * r[per_key] for r in rows)
    b = total("bound_ms")
    by_ops = sum(r["bound_ms"] * r[per_key] for r in rows if r["bound_by"] == "operations")
    return dict(name=name, route="cuda", source=SRC[name][0], replaces=SRC[name][1],
                launches=None, max_abs_err=max(r["max_abs_err"] for r in rows),
                tolerance=tol, per=per_key.replace("per_", ""),
                ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=b,
                bound_by="operations" if by_ops > b / 2 else "bytes",
                library_ms=total("library_ms"), shapes=rows)


def serve_full_width(card: str):
    log("== full-width serving: retnet-1.3b, B=2, S=512, 32 greedy tokens")
    t0 = time.perf_counter()
    eng = InferenceEngine.from_config("retnet-1.3b", EngineSpec(), device="cuda")
    torch.cuda.synchronize()
    log(f"init + deploy: {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
    cfg = eng.cfg
    if (cfg.n_layers, cfg.d_model, cfg.padded_vocab) != (N_LAYERS, D, VOCAB):
        raise RuntimeError(f"unexpected config {cfg}")
    prompts = torch.randint(1, cfg.vocab_size, (BATCH, PROMPT), generator=_gen(1),
                            device="cuda")
    gen = GenerationConfig(max_new_tokens=NEW)

    # Per-phase launch counts, then warm up.
    hopper.reset_launches()
    logits, cache = eng.prefill(prompts)
    per_prefill = dict(hopper.LAUNCHES)
    hopper.reset_launches()
    eng.decode_step(logits.argmax(-1)[:, None], cache)
    per_step = dict(hopper.LAUNCHES)
    log("launches per prefill", per_prefill, "per decode step", per_step)
    want_p = {"w8a8_matmul": 7 * N_LAYERS + 1, "retention_chunkwise": N_LAYERS,
              "mxint4_matmul": 0}
    want_s = {"w8a8_matmul": 0, "retention_chunkwise": 0,
              "mxint4_matmul": 7 * N_LAYERS + 1}
    if per_prefill != want_p or per_step != want_s:
        raise RuntimeError(f"launch counts {per_prefill} / {per_step}, "
                           f"expected {want_p} / {want_s}")
    eng.generate(prompts, gen)

    # The main path, counted.
    hopper.reset_launches()
    res = eng.generate(prompts, gen)
    launches = dict(hopper.LAUNCHES)
    want = {"w8a8_matmul": 169, "retention_chunkwise": 24,
            "mxint4_matmul": 169 * res.decode_steps}
    log("main-path launches", launches, "decode steps", res.decode_steps)
    if launches != want:
        raise RuntimeError(f"main-path launches {launches}, expected {want}")
    toks = res.tokens
    if toks.shape != (BATCH, NEW) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise RuntimeError(f"bad tokens {toks.shape}")
    # Three more timed runs (not counted): the host clock varies run to run.
    runs = [res] + [eng.generate(prompts, gen) for _ in range(3)]
    pre = sorted(r.prefill_s for r in runs)[len(runs) // 2]
    dec = sorted(r.decode_s / r.decode_steps for r in runs)[len(runs) // 2]
    serving = dict(card=card, runs=len(runs), prefill_ms=pre * 1e3,
                   decode_ms_per_token=dec * 1e3,
                   decode_tokens_per_s=BATCH / dec,
                   prefill_tokens_per_s=BATCH * PROMPT / pre,
                   prefill_ms_runs=[r.prefill_s * 1e3 for r in runs],
                   decode_ms_per_token_runs=[r.decode_s * 1e3 / r.decode_steps
                                             for r in runs])
    serving.update(profile_shares(eng, prompts))
    log("serving (kernel path, medians):", json.dumps(serving))

    # The same weights on the plain path.
    plain = InferenceEngine(cfg, eng.model, EngineSpec(kernel_impl="ref"))
    checks = compare_paths(eng, plain, prompts)
    res_p = plain.generate(prompts, gen)
    checks.update(
        greedy_token_agreement=(res_p.tokens == toks).float().mean().item(),
        plain_prefill_ms=res_p.prefill_s * 1e3,
        plain_decode_ms_per_token=res_p.decode_s * 1e3 / res_p.decode_steps)
    serving.update(checks)
    log("kernel vs plain path:", json.dumps(checks))
    del eng, plain, cache
    torch.cuda.empty_cache()
    return launches, serving


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
def profile_shares(eng, prompts, steps: int = 4) -> dict:
    """Device busy share of a prefill and of decode steps, with the top
    kernels by device time (torch.profiler; it inflates the host side, so
    the busy shares are lower bounds)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {}
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = eng.prefill(prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, top = _device_us(prof)
    out.update(prefill_device_busy=dev / 1e6 / wall, prefill_top_ms=top)
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = eng.decode_step(logits.argmax(-1)[:, None], cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, top = _device_us(prof)
    out.update(decode_device_busy=dev / 1e6 / wall,
               decode_top_ms_per_step=[(n, t / steps, c // steps) for n, t, c in top])
    if not dev:
        out = dict(profile="not measured: the profiler saw no device time")
    return out


def _prefill_from(model, x, cfg, hsa):
    """`lm.forward_prefill` from embedded inputs ``x``: last-token logits."""
    sin, cos = lm._rope_tables(cfg, x.shape[1], x.device)
    for blk in model.blocks:
        x = lm._block_apply(blk, x, cfg, hsa, "prefill", sin, cos)[0].to(x.dtype)
    h = layers.norm_full(model.final_norm, x[:, -1:])
    return hsa.linear(model.lm_head, h, "prefill")[:, 0]


@torch.inference_mode()
def compare_paths(eng, plain, prompts):
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
      path's cache and token: every block in lockstep within DECODE_BLOCK_TOL
      (decode streams MXINT4 weights against f32 activations, with no int8
      rounding, so only f32 summation order differs), and the logits within
      DECODE_TOL beside the decode step's own one-bf16-step sensitivity.
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
    lr, cache = plain.prefill(prompts)
    prefill = _rel(lk, lr, "prefill logits", PREFILL_TOL)
    x = lm._embed(model, prompts).clone()
    x[0, PROMPT // 2] = _bf16_step(x[0, PROMPT // 2])
    floor = _rel(_prefill_from(model, x, cfg, plain.hsa), lr, "sensitivity", float("inf"))

    decode, dblock, dfloor = [], [], []
    tok = lr.argmax(-1)
    for i in range(NEW):
        lk, _ = eng.decode_step(tok[:, None], cache)
        lr, nxt = plain.decode_step(tok[:, None], cache)
        decode.append(_rel(lk, lr, f"decode step {i}", DECODE_TOL))
        dblock.append(_decode_lockstep(eng, plain, tok, cache, i))
        x = lm._embed(model, tok[:, None]).clone()
        x[0] = _bf16_step(x[0])
        dfloor.append(_rel(_decode_from(model, x, cache, cfg, plain.hsa), lr,
                           "sensitivity", float("inf")))
        cache, tok = nxt, lr.argmax(-1)
    return dict(block_max_rel_err=max(block), block_tolerance=BLOCK_TOL,
                prefill_logit_rel_err=prefill, prefill_tolerance=PREFILL_TOL,
                prefill_sensitivity_floor=floor,
                decode_block_max_rel_err=max(dblock),
                decode_block_tolerance=DECODE_BLOCK_TOL,
                decode_logit_max_rel_err=max(decode), decode_tolerance=DECODE_TOL,
                decode_sensitivity_floor_max=max(dfloor))


def _bf16_step(row: torch.Tensor) -> torch.Tensor:
    """Move a bf16 row by one rounding step (relative 2^-7)."""
    return (row.float() * (1 + 2 ** -7)).to(row.dtype)


def _decode_from(model, x, cache, cfg, hsa):
    """`lm.forward_decode` from embedded inputs ``x``: logits."""
    st = cache["rope"]
    for blk, c in zip(model.blocks, cache["blocks"]):
        x = lm._block_decode(blk, x, cfg, hsa, c, st.sin, st.cos)[0].to(x.dtype)
    return hsa.linear(model.lm_head, layers.norm_full(model.final_norm, x),
                      "decode")[:, 0]


def _decode_lockstep(eng, plain, tok, cache, step):
    cfg, model = eng.cfg, eng.model
    st = cache["rope"]
    x = lm._embed(model, tok[:, None])
    worst = 0.0
    for i, (blk, c) in enumerate(zip(model.blocks, cache["blocks"])):
        yr = lm._block_decode(blk, x, cfg, plain.hsa, c, st.sin, st.cos)[0]
        yk = lm._block_decode(blk, x, cfg, eng.hsa, c, st.sin, st.cos)[0]
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


def reduced_vs_cpu():
    """Reduced retnet-1.3b: the kernel path on the card against the plain
    path on the CPU, same weights (a small-input reference check)."""
    spec = EngineSpec(reduced=True)
    eng = InferenceEngine.from_config("retnet-1.3b", spec, device="cuda")
    cpu = InferenceEngine(eng.cfg, copy.deepcopy(eng.model).to("cpu"), spec)
    prompts = torch.randint(1, eng.cfg.vocab_size, (2, 16), generator=_gen(3),
                            device="cuda")
    gen = GenerationConfig(max_new_tokens=12)
    lg, _ = eng.prefill(prompts)
    lc, _ = cpu.prefill(prompts.cpu())
    rel = _rel(lg.cpu(), lc, "reduced prefill", LOGIT_TOL)
    tg, tc = eng.generate(prompts, gen).tokens.cpu(), cpu.generate(prompts.cpu(), gen).tokens
    agree = (tg == tc).float().mean().item()
    log(f"reduced retnet-1.3b, card kernels vs CPU plain: prefill rel err {rel:.3e}, "
        f"greedy-token agreement {agree:.4f}")
    return dict(reduced_prefill_rel_err=rel, reduced_greedy_agreement=agree)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need the card",
              file=sys.stderr)
        return 2
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
        regs = [ln.strip() for ln in rep.splitlines() if "registers" in ln]
        log(f"built {kname}: {'; '.join(regs)}")
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")

    log("== kernel phases (full-width shapes; times in ms, median, cold L2)")
    entries = [
        summarize("mxint4_matmul", kernel_phase_mxint4(peaks), "per_step",
                  "rtol=atol=1e-5"),
        summarize("w8a8_matmul", kernel_phase_w8a8(peaks), "per_prefill", "exact"),
        summarize("retention_chunkwise", kernel_phase_retention(peaks), "per_prefill",
                  "rtol=atol=1e-4"),
    ]
    for e in entries:
        for r in e["shapes"]:
            log(f"  {e['name']} {r['shape']}: kernel {r['ms']:.4f} (per call "
                f"{r['call_ms']:.4f}) plain "
                f"{r['plain_ms']:.4f} library {r['library_ms']} bound "
                f"{r['bound_ms']:.4f} ({r['bound_by']}) err {r['max_abs_err']:.2e}")

    launches, serving = serve_full_width(smi)
    serving.update(reduced_vs_cpu())
    for e in entries:
        e["launches"] = launches[e["name"]]
    log(json.dumps({"serving": serving}))
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
