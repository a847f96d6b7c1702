#!/usr/bin/env python3
"""Wall time of building the Hopper kernels with nvcc, in several ways of
building flash-decode.

    python3 tools/kernel_build_times.py [--csrc DIR] [--configs NAME ...]

Each configuration builds the five kernels of ``--csrc`` (by default this
checkout's ``src/repro_torch/kernels/csrc``) from scratch into a directory
of its own, one nvcc per library, all started together, as `hopper.build`
does.  They differ only in how ``flash_decode.cu`` is built:

    per-k-format  five libraries, ``-DFD_KEY_FORMAT=0`` .. ``4``, for a
                  source that builds one K cache format per library when
                  that macro is set (on any other, five copies of ``one``)
    one           one library holding every format pair
    one-split     as ``one``, with ``--split-compile=0`` (nvcc splits the
                  device compilation over every core), as `hopper` builds it

A configuration that a source does not support fails to compile and is
reported as failed.  Configurations run in the order given, so a repeated
name measures the spread.  Prints one JSON line per configuration: the wall
time of the whole build and of each nvcc, and its exit code.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import hopper  # noqa: E402

CONFIGS = {
    "per-k-format": [(f"-DFD_KEY_FORMAT={k}",) for k in range(5)],
    "one": [()],
    "one-split": [("--split-compile=0",)],
}


def build_once(csrc: Path, fd_flags: list, out: Path) -> dict:
    jobs = [(name, ()) for name in hopper.KERNELS if name != "flash_decode"]
    jobs += [("flash_decode", flags) for flags in fd_flags]
    t0 = time.perf_counter()
    procs = []
    for i, (name, flags) in enumerate(jobs):
        cmd = hopper.nvcc_command(name, out / f"{name}-{i}.so", flags, csrc)
        procs.append((name, flags, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    each = []
    for name, flags, proc in procs:
        log = proc.communicate()[0]
        each.append(dict(name=name, flags=" ".join(flags), rc=proc.returncode,
                         s=time.perf_counter() - t0,
                         error=log[-400:] if proc.returncode else ""))
    return dict(wall_s=time.perf_counter() - t0, ok=all(e["rc"] == 0 for e in each),
                jobs=each)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path, default=hopper.CSRC)
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS), choices=list(CONFIGS))
    args = ap.parse_args()
    version = subprocess.run([hopper._nvcc(), "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()[-1]
    print(json.dumps(dict(nvcc=version, cores=os.cpu_count(), csrc=str(args.csrc))),
          flush=True)
    hopper.build_dir().mkdir(parents=True, exist_ok=True)
    for name in args.configs:
        with tempfile.TemporaryDirectory(dir=hopper.build_dir()) as out:
            row = build_once(args.csrc.resolve(), CONFIGS[name], Path(out))
        print(json.dumps(dict(config=name, **row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
