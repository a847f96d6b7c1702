#!/usr/bin/env python3
"""Retention's backward kernel of two checkouts in turns, on one NVIDIA card.

    python3 tools/retention_bwd_turns.py OLD_CHECKOUT NEW_CHECKOUT

Runs ``chip_smoke.kernel_phase_retention_bwd`` of each checkout in a process
of its own, in the order old, new, new, old, each with its own build
directory (``REPRO_TORCH_BUILD_DIR``), so both versions are timed on the same
card in one call (the builds go under NEW_CHECKOUT's
``build/retention_bwd_turns``).  Each run checks its kernel against the plain
version (1e-4 of max|plain|) and its relaunches bit-equal, as the phase does.
Prints one JSON line per run and shape: the checkout's label, the card's name
and power limit, the shape, its calls a train step, ``ms`` (`time_ms`: cold
L2, one call a replay), the step's ms (``ms`` times the calls a step), the
bounds and the error against plain, and ``warm_launch_ms``: each launch's
device time (torch.profiler, the mean over 5 calls back to back, warm L2)
by the name of its CUDA function after ``retention_bwd_``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
import torch
cs.hopper.build(("retention_chunkwise_bwd",))
torch.backends.cuda.matmul.allow_tf32 = False
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
shapes = {r[0]: r[1:] for r in cs.RET_BWD_SHAPES}
for r in cs.kernel_phase_retention_bwd(cs.card_peaks(torch.cuda.get_device_name(0))):
    b, h, s, dk, dv, c, warm, final = shapes[r["site"]][:8]
    g = cs._gen(5)
    q, k = (torch.randn(b, s, h, dk, generator=g, device="cuda").transpose(1, 2) * dk ** -0.5
            for _ in range(2))
    v, dy = (torch.randn(b, s, h, dv, generator=g, device="cuda").transpose(1, 2)
             for _ in range(2))
    st = torch.randn(b, h, dk, dv, generator=g, device="cuda") * 0.1 if warm else None
    ds = torch.randn(b, h, dk, dv, generator=g, device="cuda") * 0.1 if final else None
    gamma = cs.ret.head_decays(h, device="cuda")
    run = lambda: cs.hopper.retention_chunkwise_bwd(q, k, v, gamma, st, dy, ds, c,
                                                    need_dstate=warm)
    launch_ms = {}
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            run()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "retention_bwd_" in e.key:
            name = e.key.split("retention_bwd_")[1].split("(")[0]
            launch_ms[name] = e.self_device_time_total / 1e3 / 5
    print("ROW " + json.dumps(dict({k: r.get(k) for k in (
        "site", "shape", "per_step", "ms", "bound_ms", "bound_f32_ms", "rel_err", "rate")},
        warm_launch_ms=launch_ms)), flush=True)
"""


def main() -> None:
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    old, new = (str(Path(p).resolve()) for p in sys.argv[1:])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    build = Path(new) / "build" / "retention_bwd_turns"
    for label, root in (("old", old), ("new", new), ("new", new), ("old", old)):
        env = dict(os.environ, REPRO_TORCH_BUILD_DIR=str(build / label))
        proc = subprocess.run([sys.executable, "-c", CHILD, root], env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        rows = [json.loads(line[4:]) for line in proc.stdout.splitlines()
                if line.startswith("ROW ")]
        if proc.returncode or not rows:
            raise SystemExit(f"{label} ({root}) failed:\n{proc.stdout[-3000:]}")
        for r in rows:
            print(json.dumps(dict(r, checkout=label, card=card,
                                  step_ms=r["ms"] * r["per_step"])), flush=True)


if __name__ == "__main__":
    main()
