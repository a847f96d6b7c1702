#!/usr/bin/env python3
"""Where a flash-decode launch spends its time, from a build of the kernel
that stamps its phases, on one NVIDIA card.

    python3 tools/fd_phase_clock.py [--kv-len 528] [--reps 15]

Builds ``csrc/flash_decode.cu`` with ``-DFD_PHASE_CLOCK``: thread 0 of every
block records ``clock64`` and the global timer at entry (0), when its first
tile has landed (1), at the end of its loop (2), when its warps' states are
merged and written (3), after its split ticket (4), and, in the last block of
a (b, h), at the end of the merge of the splits (5).  The kernel is then
launched through `hopper.flash_decode` at qwen3-8b's decode shape (B 2, KV 8,
G 4, d 128, C 544) in the f32, int8_tok and mxint4_blk cache formats, with
the L2 flushed before every launch, as ``chip_smoke.py`` times it.

Prints one JSON line per format, in microseconds, each the median over
``--reps`` launches: the phases of the median last block and of the median
other block (from ``clock64``, at the SM clock the two timers give), the
launch's span from the first block's entry to the last block's end (global
timer), and the plan.
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

PHASES = 6
NAMES = ("prologue", "loop", "block_merge", "ticket", "split_merge")


def build() -> ctypes.CDLL:
    """The phase-stamping library, bound and put where `hopper.flash_decode`
    looks for its library."""
    out = hopper.build_dir() / "phase_clock"
    out.mkdir(parents=True, exist_ok=True)
    target = out / "flash_decode.so"
    flags = hopper.COMPILE_FLAGS.get("flash_decode", ()) + ("-DFD_PHASE_CLOCK",)
    proc = subprocess.run(hopper.nvcc_command("flash_decode", target, flags),
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"phase-clock build failed:\n{proc.stdout}")
    lib = ctypes.CDLL(str(target))
    hopper._bind("flash_decode", lib)
    lib.flash_decode_set_stamps.argtypes = [ctypes.c_void_p]
    lib.flash_decode_set_stamps.restype = None
    hopper._LIBS["flash_decode"] = lib
    return lib


def read(st: torch.Tensor, splits: int):
    """One launch's stamps ``[blocks, 2 * PHASES]`` (clock64, then global
    timer): the median cycles of each phase of the last blocks and of the
    others (None with one split), the span in microseconds, and SM cycles
    per nanosecond."""
    clk, ns = st[:, :PHASES], st[:, PHASES:]
    # With splits, the last block of a (b, h) stamps up to 5, the others to
    # 4; with one split every block ends at 3 (no ticket).
    last = clk[:, 5] != 0 if splits > 1 else torch.ones(len(st), dtype=torch.bool)
    end = 5 if splits > 1 else 3
    stop = torch.full((len(st), 1), end)
    stop[~last] = 4
    clk_end, ns_end = clk.gather(1, stop)[:, 0], ns.gather(1, stop)[:, 0]

    def mid(rows, upto):
        return [statistics.median((rows[:, i + 1] - rows[:, i]).tolist()) for i in range(upto)]

    return (mid(clk[last], end), mid(clk[~last], 4) if splits > 1 else None,
            (ns_end.max() - ns[:, 0].min()).item() / 1e3,
            (clk_end - clk[:, 0]).sum().item() / (ns_end - ns[:, 0]).sum().item())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kv-len", type=int, default=528)
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fd_phase_clock: no CUDA device", file=sys.stderr)
        return 2
    fmts = ("f32", "int8_tok", "mxint4_blk")
    lib = build()
    b, kvh, g, d, c, n = 2, 8, 4, 128, 544, args.kv_len
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    q = torch.randn(b, kvh, g, d, generator=gen, device="cuda")
    k32 = torch.randn(b, c, kvh, d, generator=gen, device="cuda")
    v32 = torch.randn(b, c, kvh, d, generator=gen, device="cuda")
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    kv_len = torch.tensor(n, dtype=torch.int32, device="cuda")
    for fmt in fmts:
        k, v = (k32, v32) if fmt == "f32" else (kvq.encode(k32, fmt), kvq.encode(v32, fmt))
        plan = hopper.flash_decode_plan(b, kvh, g, d, d, c, fmt, fmt, hopper._sms(q.device))
        stamps = torch.zeros(plan["blocks"], 2 * PHASES, dtype=torch.int64, device="cuda")
        lib.flash_decode_set_stamps(stamps.data_ptr())
        last, other, span, ghz = [], [], [], []
        for _ in range(args.reps):
            stamps.zero_()
            flush.zero_()
            ops.flash_decode(q, k, v, kv_len, impl="kernel")
            torch.cuda.synchronize()
            got = read(stamps.cpu(), plan["splits"])
            for acc, val in zip((last, other, span, ghz), got):
                if val is not None:
                    acc.append(val)
        rate = statistics.median(ghz) * 1e3          # cycles per microsecond

        def summary(rows):
            if not rows:
                return None
            per = [statistics.median(r[i] for r in rows) / rate for i in range(len(rows[0]))]
            return dict(zip(NAMES, per), total=sum(per))

        print(json.dumps(dict(
            format=fmt, kv_len=n, sm_clock_ghz=rate / 1e3, last_block_us=summary(last),
            other_block_us=summary(other), span_us=statistics.median(span),
            plan={key: val for key, val in plan.items() if key != "ranges"})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
