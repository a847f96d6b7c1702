#!/usr/bin/env python3
"""The routed-MoE expert GEMV of two checkouts in turns, on one NVIDIA card.

    python3 tools/expert_turns.py OLD_CHECKOUT NEW_CHECKOUT

Runs ``chip_smoke.kernel_phase_mxint4_expert`` of each checkout in a process
of its own, in the order old, new, new, old, each with its own build
directory (``REPRO_TORCH_BUILD_DIR``), so both versions are timed on the same
card in one call (the builds go under NEW_CHECKOUT's ``build/expert_turns``).
Prints one JSON line per run and shape: the checkout's
label, the shape, its launches a step and ``ms`` (`time_ms`: cold L2, one
call a replay), and the step's ms (``ms`` times the launches a step).
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
cs.hopper.build(("mxint4_matmul",))
torch.backends.cuda.matmul.allow_tf32 = False
for r in cs.kernel_phase_mxint4_expert(cs.card_peaks(torch.cuda.get_device_name(0))):
    print("ROW " + json.dumps(dict(path=r["path"], shape=r["shape"], per_step=r["per_step"],
                                   ms=r["ms"])), flush=True)
"""


def main() -> None:
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    old, new = (str(Path(p).resolve()) for p in sys.argv[1:])
    build = Path(new) / "build" / "expert_turns"
    for label, root in (("old", old), ("new", new), ("new", new), ("old", old)):
        env = dict(os.environ, REPRO_TORCH_BUILD_DIR=str(build / label))
        proc = subprocess.run([sys.executable, "-c", CHILD, root], env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        rows = [json.loads(line[4:]) for line in proc.stdout.splitlines()
                if line.startswith("ROW ")]
        if proc.returncode or not rows:
            raise SystemExit(f"{label} ({root}) failed:\n{proc.stdout[-3000:]}")
        for r in rows:
            print(json.dumps(dict(r, checkout=label, step_ms=r["ms"] * r["per_step"])),
                  flush=True)


if __name__ == "__main__":
    main()
