#!/usr/bin/env python3
"""rmsnorm_stats on one NVIDIA card at ``chip_smoke.py``'s sigma^-1 shapes;
one tree per process, so that two trees can be timed in turns.

    python3 tools/rmsnorm_turns.py [--src DIR] [--reps 15] [--phases]

``--src`` is the ``src`` directory whose ``repro_torch`` is measured (by
default this checkout's); it builds into that tree's own build directory.
This checkout's ``chip_smoke.py`` is loaded after the tree's ``repro_torch``,
so both trees are timed by the same code.  For example, the parent commit
unpacked under ``build/`` against this tree, in turns:

    for t in build/parent/src src src build/parent/src; do
        python3 tools/rmsnorm_turns.py --src $t; done

At every shape of ``chip_smoke.RMS_SHAPES``, on ``ops.rmsnorm_stats(y,
impl="kernel")``: ``ms`` (`chip_smoke.time_ms`: one call per CUDA graph
replay, cold L2, median), ``amortised_ms`` (`chip_smoke.amortised_ms`: 8
calls on 8 distinct inputs per replay, over 8) and ``call_ms``
(`chip_smoke.call_ms`), in microseconds, one JSON line per tree, with the
floors of `chip_smoke.time_ms` (one 1-element fill per replay) and of
`chip_smoke.amortised_ms` (8 such fills per replay, over 8).

``--phases`` (this tree only) builds ``csrc/rmsnorm_stats.cu`` with
``-DRMS_PHASE_CLOCK``: thread 0 of every block stamps ``clock64`` and the
global timer at entry, when its first bytes have landed (its first load
added), when its last are added, and after the write.  One line per shape:
the launch's span (first entry to last exit, global timer), the spread of
block entries, and the median block's "first bytes landed", "loads" and
"reduce and write" at the SM clock the two timers give; medians over
``--reps`` launches, each after `chip_smoke.time_ms`'s flush (a 256 MB
write).
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
PHASES = 4


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def inputs(torch, cs, m, d, dt):
    return [torch.randn(m, d, generator=cs._gen(m + d + i), device="cuda").to(dt)
            for i in range(cs.RMS_AMORTISED)]


def label(m, d, dt) -> str:
    return f"{m}x{d} {str(dt).replace('torch.', '')}"


def build_clocked(hopper):
    """``csrc/rmsnorm_stats.cu`` built with ``-DRMS_PHASE_CLOCK`` into its
    own library, bound and put where `hopper.rmsnorm_stats` looks."""
    out = hopper.build_dir() / "variants"
    out.mkdir(parents=True, exist_ok=True)
    target = out / "rmsnorm_stats_phase_clock.so"
    proc = subprocess.run(hopper.nvcc_command("rmsnorm_stats", target, ("-DRMS_PHASE_CLOCK",)),
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"-DRMS_PHASE_CLOCK build failed:\n{proc.stdout}")
    lib = ctypes.CDLL(str(target))
    hopper._bind("rmsnorm_stats", lib)
    lib.rmsnorm_stats_set_stamps.argtypes = [ctypes.c_void_p]
    lib.rmsnorm_stats_set_stamps.restype = None
    hopper._LIBS["rmsnorm_stats"] = lib
    return lib


def phases(torch, hopper, lib, y, plan, flush, reps):
    stamps = torch.zeros(plan["blocks"], 2 * PHASES, dtype=torch.int64, device="cuda")
    lib.rmsnorm_stats_set_stamps(stamps.data_ptr())
    per, spans, spreads, ghz = [], [], [], []
    for _ in range(reps):
        stamps.zero_()
        flush.zero_()
        hopper.rmsnorm_stats(y, 1e-6)
        torch.cuda.synchronize()
        st = stamps.cpu()
        clk, ns = st[:, :PHASES], st[:, PHASES:]
        per.append([statistics.median((clk[:, i + 1] - clk[:, i]).tolist())
                    for i in range(PHASES - 1)])
        spans.append((ns[:, 3].max() - ns[:, 0].min()).item() / 1e3)
        spreads.append((ns[:, 0].max() - ns[:, 0].min()).item() / 1e3)
        ghz.append((clk[:, 3] - clk[:, 0]).sum().item()
                   / max(1, (ns[:, 3] - ns[:, 0]).sum().item()))
    rate = statistics.median(ghz) * 1e3                    # cycles per microsecond
    block = {name: statistics.median(p[i] for p in per) / rate
             for i, name in enumerate(("first_bytes_landed", "loads", "reduce_and_write"))}
    return dict(span_us=statistics.median(spans), entry_spread_us=statistics.median(spreads),
                sm_clock_ghz=rate / 1e3, median_block_us=block)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    if args.phases and src != ROOT / "src":
        print("rmsnorm_turns: --phases needs this tree", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("rmsnorm_turns: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import hopper, ops
    if os.path.commonpath([hopper.__file__, str(src)]) != str(src):
        raise RuntimeError(f"imported {hopper.__file__}, not the tree's")
    cs = load_chip_smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    base = dict(src=os.path.relpath(src, ROOT), card=card)
    us = lambda ms: ms * 1e3  # noqa: E731

    if args.phases:
        flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
        lib = build_clocked(hopper)
        for m, d, dt, _ in cs.RMS_SHAPES:
            y = inputs(torch, cs, m, d, dt)[0]
            plan = hopper.rmsnorm_stats_plan(m, d, y.element_size(), hopper._sms(y.device))
            print(json.dumps(dict(base, shape=label(m, d, dt), plan=plan,
                                  **phases(torch, hopper, lib, y, plan, flush, args.reps))),
                  flush=True)
        return 0

    rows = {}
    for m, d, dt, _ in cs.RMS_SHAPES:
        ys = inputs(torch, cs, m, d, dt)
        fn = lambda yy: ops.rmsnorm_stats(yy, impl="kernel")  # noqa: E731
        rows[label(m, d, dt)] = dict(
            ms=us(cs.time_ms(lambda: fn(ys[0]), args.reps)),
            amortised_ms=us(cs.amortised_ms(fn, ys, args.reps)),
            call_ms=us(cs.call_ms(lambda: fn(ys[0]))))
        del ys
    ones = [torch.zeros(1, device="cuda") for _ in range(cs.RMS_AMORTISED)]
    print(json.dumps(dict(
        base, unit="us", floor_ms=us(cs.time_ms(lambda: ones[0].fill_(1.0))),
        amortised_floor_ms=us(cs.amortised_ms(lambda t: t.fill_(1.0), ones)), shapes=rows)),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
