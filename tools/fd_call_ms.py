#!/usr/bin/env python3
"""Host cost per call of the flash-decode wrapper, beside the rmsnorm_stats
wrapper as a control, on one NVIDIA card.

    python3 tools/fd_call_ms.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is measured (by
default this checkout's), so that two trees can be compared in turns on one
card, one process each, for example:

    for t in a b b a a b; do python3 tools/fd_call_ms.py --src $t/src --label $t; done

Both trees must take kv_len as an int32 tensor on the card (the interface
since the fused decode loop).

``call_ms`` is the wall time per call of ``ops.flash_decode(..., impl="kernel")``
issued back to back at qwen3-8b's decode shape (B 2, KV 8, G 4, d 128,
C 544, kv_len 528) in the f32, int8_tok and mxint4_blk cache formats, warm
L2: the larger of the wrapper's host cost and the kernel's device time.
The control is ``ops.rmsnorm_stats`` on a bf16 ``[2, 4096]`` row pair, a
wrapper whose device work is negligible, so it reads the host's speed.
Each wrapper gets 15 rounds of 200 calls; the line gives the least and the
median round, in microseconds per call (the least round is the one the rest
of the host disturbed least).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def call_us(fn, iters: int = 200, rounds: int = 15) -> dict:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e6 / iters)
    return dict(min=min(times), median=statistics.median(times))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("fd_call_ms: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import kvq
    from repro_torch.kernels import ops

    b, kvh, g, d, c, n = 2, 8, 4, 128, 544, 528
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    q = torch.randn(b, kvh, g, d, generator=gen, device="cuda")
    k32 = torch.randn(b, c, kvh, d, generator=gen, device="cuda")
    v32 = torch.randn(b, c, kvh, d, generator=gen, device="cuda")
    y = torch.randn(2, 4096, generator=gen, device="cuda").to(torch.bfloat16)
    kv_len = torch.tensor(n, dtype=torch.int32, device="cuda")
    row = dict(label=args.label, src=os.path.relpath(os.path.abspath(args.src), ROOT))
    for fmt in ("f32", "int8_tok", "mxint4_blk"):
        k, v = (k32, v32) if fmt == "f32" else (kvq.encode(k32, fmt), kvq.encode(v32, fmt))
        row[f"flash_decode_{fmt}"] = call_us(
            lambda: ops.flash_decode(q, k, v, kv_len, impl="kernel"))
    row["rmsnorm_stats"] = call_us(lambda: ops.rmsnorm_stats(y, impl="kernel"))
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
