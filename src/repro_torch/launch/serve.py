"""Serving CLI: the single-`generate` path of the reference's serve demo.

Builds the model at the arch's configuration (random weights from a seed),
deploys the paper's formats (W8A8 prefill in the MMM dataflow, MXINT4 decode
in the MVM dataflow) unless ``--no-quant``, and serves one batch of prompts
sized by the LISO/SILO scenario presets through
`InferenceEngine.generate`: on the card each decode step is a replay of one
captured CUDA graph.

    python -m repro_torch.launch.serve --arch retnet-1.3b --scenario SILO \\
        --scale 0.1 --batch 2 [--temperature 1 --top-p 0.9]
    python -m repro_torch.launch.serve --arch retnet-1.3b --reduced \\
        --scale 0.02 --device cpu

Prompts come from a seeded ``torch.Generator``.  The reference's other
modes (the continuous-batching scheduler and what rides on it, the open-loop
front end, speculative decode, a device mesh, tracing and metrics) are not
ported yet: their flags are accepted by the parser, and each exits nonzero
naming the ROADMAP item that ports it.  The settings only those modes read
(``--slots``, ``--chunk-size``, ``--draft-k``, ``--rate``, ``--arrival``,
``--ttft-slo``, ``--virtual-clock``) come with them; until then the parser
rejects them.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import edge_model
from repro_torch.serving.engine import EngineSpec, InferenceEngine
from repro_torch.serving.sampling import GenerationConfig, SamplingParams

# Flags of modes that are not ported: (flag, the argparse dest, ROADMAP item,
# what the mode is).
UNPORTED = (
    ("--requests", "requests", "A11", "the continuous-batching scheduler"),
    ("--frontend", "frontend", "A11", "the open-loop front end"),
    ("--host-spill", "host_spill", "A11", "the scheduler's host-memory spill tier"),
    ("--prefix-cache", "prefix_cache", "A11", "the scheduler's shared-prefix cache"),
    ("--oversubscribe", "oversubscribe", "A11", "the scheduler's oversubscribed pool"),
    ("--trace", "trace", "A11", "request-lifecycle tracing"),
    ("--metrics", "metrics", "A11", "the metrics registry"),
    ("--speculative", "speculative", "A10c", "speculative decode"),
    ("--mesh", "mesh", "A12", "serving on a device mesh"),
)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--scenario", choices=["LISO", "SILO"], default="SILO")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="scale LISO/SILO token counts")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--no-quant", action="store_true",
                    help="serve fp master weights (ablation)")
    ap.add_argument("--unfused-norm", action="store_true",
                    help="disable the Eq.(4) fused RMSNorm (ablation)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain PyTorch path")
    # The reference's other modes, each refused in `main` (the settings only
    # they read come with them).
    ap.add_argument("--requests", type=int, default=0)
    ap.add_argument("--speculative", action="store_true")
    ap.add_argument("--host-spill", action="store_true")
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--frontend", action="store_true")
    ap.add_argument("--oversubscribe", type=float, default=0.0)
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--trace", metavar="FILE", default=None)
    ap.add_argument("--metrics", metavar="FILE", default=None)
    return ap


def main(argv: list[str] | None = None) -> None:
    ap = parser()
    args = ap.parse_args(argv)
    for flag, dest, item, what in UNPORTED:
        if getattr(args, dest):
            ap.error(f"{flag}: {what} is not ported to repro_torch yet "
                     f"(ROADMAP {item})")

    scen = edge_model.LISO if args.scenario == "LISO" else edge_model.SILO
    n_in = max(2, int(scen.tokens_in * args.scale))
    n_out = max(2, int(scen.tokens_out * args.scale))
    spec = EngineSpec(quantize=not args.no_quant, reduced=args.reduced,
                      fuse_rmsnorm=not args.unfused_norm)
    engine = InferenceEngine.from_config(args.arch, spec, device=args.device)
    cfg = engine.cfg
    print(f"[serve] {cfg.name} scenario={scen.name} in/out={n_in}/{n_out} "
          f"batch={args.batch}")
    if not args.no_quant:
        print("[serve] deployed: W8A8 prefill / MXINT4 (4.25b) decode weights")

    dev = engine.device
    prompts = torch.randint(1, cfg.vocab_size, (args.batch, n_in),
                            generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    gen = GenerationConfig(
        max_new_tokens=n_out,
        sampling=SamplingParams(temperature=args.temperature, top_k=args.top_k,
                                top_p=args.top_p))
    res = engine.generate(prompts, gen,
                          generator=torch.Generator(device=dev).manual_seed(2))
    total = n_in + n_out
    t_p, t_d = res.prefill_s, res.decode_s
    print(f"[serve] prefill {t_p*1e3:.0f} ms, decode {t_d*1e3:.0f} ms "
          f"({t_d/n_out*1e3:.1f} ms/token)")
    print(f"[serve] {scen.name} tokens/s (paper convention, prompt+output): "
          f"{args.batch * total / (t_p + t_d):.2f}")
    print(f"[serve] sample output tokens: {res.tokens[0, :16].tolist()}")


if __name__ == "__main__":
    main()
