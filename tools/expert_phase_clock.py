#!/usr/bin/env python3
"""Where a routed-MoE expert GEMV launch spends its time, from a build of the
kernel that counts its phases, on one NVIDIA card.

    python3 tools/expert_phase_clock.py

Builds ``csrc/mxint4_matmul.cu`` with ``-DMX_EXPERT_PHASE_CLOCK``: thread 0
of every block counts the cycles (``clock64``) it spent building the routing,
waiting for its steps' copies, computing its steps and ending its passes
(sums, partials), the steps it computed, its cycles from entry to exit (its
last split sums included), and the global timer at entry and exit.  The kernel is then launched
through `hopper.mxint4_expert_matmul` at olmoe-1b-7b's decode (A 16) and
verify (A 80) shapes and at deepseek-v3's MTP head step (A 16 of 256
experts), on experts chosen as a router chooses them, with the L2 flushed
(a 256 MB write) before the launch, as ``chip_smoke.py`` times it.

Prints one JSON line per shape: the mean, min and max over blocks of each
count, in cycles; the launch's span in microseconds from the first block's
entry to the last block's exit, and the spread of the blocks' entries and
exits (global timer); and the plan.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import hopper, ops  # noqa: E402
from repro_torch.models import deploy  # noqa: E402

NAMES = ("route", "wait", "step", "pass", "steps", "total")
SHAPES = [(16, 64, 2048, 1024), (16, 64, 1024, 2048), (80, 64, 2048, 1024),
          (16, 256, 7168, 2048), (16, 256, 2048, 7168)]


def build() -> ctypes.CDLL:
    """The phase-counting library, bound and put where
    `hopper.mxint4_expert_matmul` looks for its library."""
    out = hopper.build_dir() / "phase_clock"
    out.mkdir(parents=True, exist_ok=True)
    target = out / "mxint4_matmul.so"
    proc = subprocess.run(hopper.nvcc_command("mxint4_matmul", target,
                                              ("-DMX_EXPERT_PHASE_CLOCK",)),
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"phase-clock build failed:\n{proc.stdout}")
    lib = ctypes.CDLL(str(target))
    hopper._bind("mxint4_matmul", lib)
    lib.mxint4_expert_phases_read.argtypes = [ctypes.c_void_p]
    hopper._LIBS["mxint4_matmul"] = lib
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    lib = build()
    flush = torch.empty(64 << 20, device="cuda")
    for a, e, k, n in SHAPES:
        g = torch.Generator(device="cuda")
        g.manual_seed(k + n)
        packed, exps = deploy.quantize_stacked(
            torch.randn(e, k, n, generator=g, device="cuda") * k ** -0.5)
        x = torch.randn(a, k, generator=g, device="cuda")
        ids = torch.rand(a // 8, e, generator=g, device="cuda").topk(8, dim=-1).indices.reshape(-1)
        ops.mxint4_expert_matmul(x, packed, exps, ids, impl="kernel")
        flush.zero_()
        ops.mxint4_expert_matmul(x, packed, exps, ids, impl="kernel")
        torch.cuda.synchronize()
        stamps = torch.zeros(1024, 8, dtype=torch.int64)
        err = lib.mxint4_expert_phases_read(ctypes.c_void_p(stamps.data_ptr()))
        if err:
            raise RuntimeError(f"reading the phase counts failed: cudaError {err}")
        plan = hopper.mxint4_expert_plan(k, n, hopper._sms(x.device))
        blocks = hopper.mxint4_expert_blocks(plan, a, e, hopper._sms(x.device))
        rows = stamps[:blocks].double()
        entry, exit_ = stamps[:blocks, 6], stamps[:blocks, 7]
        print(json.dumps(dict(
            shape=[a, k, n], experts=e, distinct_experts=int(ids.unique().numel()),
            blocks=blocks, plan=plan, device=torch.cuda.get_device_name(0),
            span_us=(exit_.max() - entry.min()).item() / 1e3,
            entry_spread_us=(entry.max() - entry.min()).item() / 1e3,
            exit_spread_us=(exit_.max() - exit_.min()).item() / 1e3,
            cycles={name: dict(mean=round(rows[:, i].mean().item()),
                               min=int(rows[:, i].min()), max=int(rows[:, i].max()))
                    for i, name in enumerate(NAMES)})), flush=True)
        del packed, exps


if __name__ == "__main__":
    main()
