#!/usr/bin/env python3
"""retnet-1.3b prefill and its retention calls, one tree per process, on one
NVIDIA card.

    python3 tools/retention_turns.py [--tree DIR] [--label NAME]

``--tree`` is the checkout whose ``chip_smoke.py`` and ``repro_torch`` are
measured (by default this one), so that two trees can be compared in turns
on one card, one process each, for example:

    for t in a b b a; do python3 tools/retention_turns.py --tree $t --label $t; done

Each process loads the tree's ``chip_smoke.py`` (which puts that tree's
``src`` first on the path), builds the kernels the tree needs (into its own
build directory) and measures, at full width (B 2, S 512, 24 layers,
d_model 2048, seeded random weights in the default W8A8/MXINT4 deployment):

- ``call_ms``: the device time of one ``ops.retention_chunkwise`` call on
  the views the model hands over (transposes of ``[B, S, H, d]`` tensors,
  H 8, dk 256, dv 512, chunk 128), everything the call runs on the card
  included (a wrapper's copies as well as its kernels), by the tree's
  ``chip_smoke.time_ms`` (a CUDA graph of one call replayed between CUDA
  events, L2 flushed before each replay, median of 15); ``plain_ms`` the
  plain version the same way;
- ``prefill_ms``: ``InferenceEngine.generate`` with 32 greedy tokens, the
  median of 7 runs' prefill (host clock around a synchronised prefill), and
  ``decode_ms_per_token`` likewise;
- from one profiled prefill (torch.profiler): the device time of every
  kernel, of the retention kernels, and of copy kernels (names containing
  ``copy``), in ms, and the count of CUDA kernels.

Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("retention_turns: no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.abspath(args.tree), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ops, ref, ret = cs.ops, cs.ref, cs.ret

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    row = dict(label=args.label, tree=os.path.relpath(os.path.abspath(args.tree), ROOT),
               card=card)

    b, h, s, dk, dv, c = 2, 8, 512, 256, 512, 128
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    q, k = ((torch.randn(b, s, h, dk, generator=gen, device="cuda") * dk ** -0.5
             ).transpose(1, 2) for _ in range(2))
    v = torch.randn(b, s, h, dv, generator=gen, device="cuda").transpose(1, 2)
    gamma = ret.head_decays(h, device="cuda")
    row["call_ms"] = cs.time_ms(lambda: ops.retention_chunkwise(q, k, v, gamma, chunk=c,
                                                                impl="kernel"))
    row["plain_ms"] = cs.time_ms(lambda: ref.retention_chunkwise_ref(q, k, v, gamma, chunk=c))
    del q, k, v

    eng = cs.InferenceEngine.from_config("retnet-1.3b", cs.EngineSpec(), device="cuda")
    prompts = torch.randint(1, eng.cfg.vocab_size, (b, s), device="cuda",
                            generator=gen)
    gcfg = cs.GenerationConfig(max_new_tokens=32)
    eng.generate(prompts, gcfg)
    runs = [eng.generate(prompts, gcfg) for _ in range(7)]
    row["prefill_ms"] = statistics.median(r.prefill_s * 1e3 for r in runs)
    row["prefill_ms_runs"] = [r.prefill_s * 1e3 for r in runs]
    row["decode_ms_per_token"] = statistics.median(r.decode_s * 1e3 / r.decode_steps
                                                   for r in runs)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        eng.prefill(prompts, cache_len=s + 32)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev = lambda pick: sum(e.device_time_total for e in kernels if pick(e.name)) / 1e3  # noqa: E731
    row.update(prefill_device_ms=dev(lambda n: True),
               prefill_retention_ms=dev(lambda n: "retention" in n),
               prefill_copy_ms=dev(lambda n: "copy" in n.lower()),
               prefill_cuda_kernels=len(kernels))
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
