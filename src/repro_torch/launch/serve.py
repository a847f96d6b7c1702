"""Serving CLI: the reference's serve demo on the port.

Builds the model at the arch's configuration (random weights from a seed),
deploys the paper's formats (W8A8 prefill in the MMM dataflow, MXINT4 decode
in the MVM dataflow) unless ``--no-quant``, and serves prompts sized by the
LISO/SILO scenario presets:

* by default one batch through `InferenceEngine.generate` (on the card each
  decode step is a replay of one captured CUDA graph);
* ``--requests N``: the continuous-batching `RequestScheduler` — N
  mixed-length requests chunk-admitted (``--chunk-size``) into a pool of
  ``--slots`` lanes in two slot classes while resident lanes decode (one
  captured step per class); ``--host-spill`` (with ``--oversubscribe R``)
  turns on the host tier: a late high-priority burst preempts resident
  lanes to host memory, and they resume bit-exactly; ``--prefix-cache``
  turns on shared-prefix reuse over the repeated-system-prompt stream
  (full-length prompts opening with one shared prefix): admissions adopt the
  cached prefix and prefill only their suffix, and a line reports the hits;
* ``--frontend``: the open-loop `ServingFrontend` — seeded Poisson or bursty
  arrivals (``--rate``, ``--arrival``) through SLO-aware admission
  (``--ttft-slo``), goodput and shed rate at the end; ``--virtual-clock``
  runs it on deterministic virtual time and exits nonzero unless goodput
  is nonzero with no unexplained shed (the smoke contract);
* ``--speculative`` (with ``--draft-k K``, default 4): speculative decode
  with the ngram drafter, in the single-`generate` mode (each verify step a
  replay of one captured graph) and in the scheduler mode (per-lane
  acceptance, one captured verify step per class), with its verify-step and
  acceptance lines;
* ``--trace FILE`` writes the request-lifecycle trace (Chrome trace events,
  for Perfetto), ``--metrics FILE`` the metrics snapshot (JSON).

    python -m repro_torch.launch.serve --arch retnet-1.3b --scenario SILO \\
        --scale 0.1 --batch 2 [--temperature 1 --top-p 0.9]
    python -m repro_torch.launch.serve --arch retnet-1.3b --reduced \\
        --scale 0.02 --device cpu [--requests 6 --host-spill --oversubscribe 2]
    python -m repro_torch.launch.serve --arch olmoe-1b-7b --scenario SILO \\
        --scale 0.1 --batch 2 [--requests 6 [--prefix-cache] | --speculative]

``--arch`` takes every family the port serves (retnet, dense GQA with
RMSNorm or LayerNorm and MLA, MoE, ssm, hybrid) in every mode.  It has no
drafter flag, as the reference's has none: ``--speculative`` drafts with
the ngram drafter.

Prompts come from seeded ``torch.Generator``s.  The reference's mode that
is not ported yet (a device mesh) is accepted by the parser and exits
nonzero naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core import edge_model
from repro_torch.obs import Observability, Tracer
from repro_torch.serving import (BurstyArrivals, FrontendConfig, LengthMix,
                                 MonotonicClock, PoissonArrivals, Request,
                                 RequestScheduler, ServingFrontend, VirtualClock,
                                 Workload, run_open_loop)
from repro_torch.serving.engine import EngineSpec, InferenceEngine
from repro_torch.serving.sampling import GenerationConfig, SamplingParams, SpeculativeConfig

# Flags of modes that are not ported: (flag, the argparse dest, ROADMAP item,
# what the mode is).
UNPORTED = (
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
    ap.add_argument("--requests", type=int, default=0,
                    help="> 0: continuous-batching scheduler demo with this many "
                         "mixed-length requests")
    ap.add_argument("--slots", type=int, default=4,
                    help="scheduler mode: decode lanes in the cache pool")
    ap.add_argument("--chunk-size", type=int, default=32,
                    help="scheduler mode: prefill chunk size (tokens/cycle)")
    ap.add_argument("--host-spill", action="store_true",
                    help="scheduler mode: the host-memory spill tier; a late "
                         "high-priority burst preempts resident lanes to it")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="scheduler mode: shared-prefix reuse over a repeated-system-"
                         "prompt stream")
    ap.add_argument("--oversubscribe", type=float, default=0.0,
                    help="scheduler mode: request-to-lane ratio; shrinks the pool "
                         "to ~requests/R lanes (pair with --host-spill)")
    ap.add_argument("--frontend", action="store_true",
                    help="open-loop front-end demo: seeded arrivals through "
                         "SLO-aware admission; --requests sets the count (default 8)")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="frontend mode: offered load, requests/second")
    ap.add_argument("--arrival", choices=["poisson", "bursty"], default="poisson",
                    help="frontend mode: arrival process")
    ap.add_argument("--ttft-slo", type=float, default=2.0,
                    help="frontend mode: TTFT SLO target in seconds")
    ap.add_argument("--virtual-clock", action="store_true",
                    help="frontend mode: deterministic virtual time (the smoke "
                         "contract: nonzero goodput, no unexplained shed)")
    ap.add_argument("--trace", metavar="FILE", default=None,
                    help="write the request-lifecycle trace as Chrome trace events")
    ap.add_argument("--metrics", metavar="FILE", default=None,
                    help="write the metrics-registry snapshot as JSON")
    ap.add_argument("--speculative", action="store_true",
                    help="speculative decode with the ngram drafter")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="speculative mode: drafted tokens per verify step")
    # The reference's mode that is not ported, refused in `main`.
    ap.add_argument("--mesh", default=None)
    return ap


def _sampling(args) -> SamplingParams:
    return SamplingParams(temperature=args.temperature, top_k=args.top_k,
                          top_p=args.top_p)


def _speculative(args) -> SpeculativeConfig | None:
    return SpeculativeConfig(k=args.draft_k) if args.speculative else None


def _run_scheduler_demo(engine: InferenceEngine, args, n_in: int, n_out: int) -> None:
    """Sequencer demo: mixed-length prompts chunk-admitted into a pool of two
    slot classes while resident lanes decode."""
    cfg, dev = engine.cfg, engine.device
    spec = _speculative(args)
    gen = GenerationConfig(max_new_tokens=n_out, sampling=_sampling(args), speculative=spec)
    shared: list[int] = []
    if args.prefix_cache:
        # The repeated-system-prompt stream prefix reuse targets: uniform
        # full-length prompts, each opening with the same shared prefix,
        # long enough to clear the one-page adoption floor.
        lengths = [n_in] * args.requests
        shared_len = min(n_in - 1, max(16, int(n_in * 0.75)))
        shared = torch.randint(1, cfg.vocab_size, (shared_len,),
                               generator=torch.Generator().manual_seed(5)).tolist()
    else:
        choice = torch.Generator().manual_seed(0)
        fracs = (0.25, 0.5, 1.0)
        lengths = [max(2, int(n_in * fracs[int(i)]))
                   for i in torch.randint(0, 3, (args.requests,), generator=choice)]
    extra = spec.k if spec else 0        # verify blocks overrun by k slots
    small = max(2, int(n_in * 0.5)) + n_out + extra
    large = n_in + n_out + extra
    classes = ([(args.slots, large)] if small >= large or args.slots < 2 else
               [(args.slots // 2, small), (args.slots - args.slots // 2, large)])
    sched = RequestScheduler(engine, classes=classes, gen=gen, chunk_size=args.chunk_size,
                             host_spill=args.host_spill, prefix_cache=args.prefix_cache,
                             seed=2, obs=engine.obs)

    def make_request(uid: int, s: int) -> Request:
        g = torch.Generator(device=dev).manual_seed(1000 + uid)
        tokens = torch.randint(1, cfg.vocab_size, (s,), generator=g, device=dev).tolist()
        return Request(uid=uid, prompt=shared + tokens[len(shared):])

    print(f"[serve] scheduler: {args.requests} requests, prompt lengths "
          f"{sorted(set(lengths))}, classes {classes}, chunk={args.chunk_size}"
          + (", host-spill preemption on" if args.host_spill else "")
          + (f", prefix-cache on ({len(shared)}-token shared prefix)"
             if args.prefix_cache else "")
          + f"; class steps captured in {sched.capture_s:.3f} s")
    t0 = time.perf_counter()
    if args.host_spill and args.requests > 1:
        # Oversubscription demo: fill the pool with default-priority residents
        # first, then a late high-priority burst that preempts them into the
        # host tier (they resume once lanes free up).
        n_burst = max(1, args.requests // 3)
        for uid, s in list(enumerate(lengths))[:-n_burst]:
            sched.submit(make_request(uid, s))
        while sched.stats["admitted"] < min(args.requests - n_burst, sched.pool.n_slots):
            sched.step()
        for uid, s in list(enumerate(lengths))[-n_burst:]:
            sched.submit(make_request(uid, s), priority=1)
    else:
        for uid, s in enumerate(lengths):
            sched.submit(make_request(uid, s))
    results = sched.run()
    dt = time.perf_counter() - t0
    total = sum(len(r.tokens) for r in results.values()) + sum(lengths)
    print(f"[serve] {sched.stats['steps']} cycles, {sched.stats['prefill_chunks']} prefill "
          f"chunks, {sched.stats['decode_stall_steps']} decode-stall steps")
    if args.host_spill:
        ss = sched.pool.spill_stats
        print(f"[serve] host tier: {sched.stats['preempted']} preempted / "
              f"{sched.stats['resumed']} resumed, {ss['spills']} spills "
              f"({ss['bytes_to_host']} B to host), {ss['fetches']} fetches "
              f"({ss['bytes_to_device']} B back)")
    if args.prefix_cache:
        px = sched.pool.prefix
        ps = px.stats
        print(f"[serve] prefix cache [{px.mode}]: {ps['prefix_hits']}/"
              f"{ps['prefix_lookups']} admissions adopted a cached prefix, "
              f"{ps['prefix_hit_tokens']} prefill tokens skipped, {px.n_pages} pages "
              f"resident ({ps['cow_copies']} COW copies)")
    if spec:
        for uid in sorted(results):
            r = results[uid]
            print(f"[serve]   req {uid}: {len(r.tokens)} tokens in {r.verify_steps} verify "
                  f"steps ({r.tokens_per_step:.2f} tokens/step, {r.accepted_drafts} drafts "
                  f"accepted)")
        vs = max(1, sched.stats["verify_steps"])
        print(f"[serve] speculative: {sched.stats['accepted_drafts']} drafts accepted over "
              f"{vs} verify steps ({1 + sched.stats['accepted_drafts'] / vs:.2f} "
              f"tokens/step)")
    bad = [u for u, r in results.items()
           if r.cancelled or not all(0 <= t < cfg.vocab_size for t in r.tokens)]
    if len(results) != args.requests or bad:
        raise SystemExit(f"[serve] scheduler FAILED: {len(results)} of {args.requests} "
                         f"results, bad {bad}")
    print(f"[serve] tokens/s (paper convention, prompt+output): {total / dt:.2f}")


def _run_frontend_demo(engine: InferenceEngine, args, n_in: int, n_out: int) -> None:
    """Open-loop front-end demo: seeded arrivals (`--rate`, `--arrival`)
    through the asyncio `ServingFrontend` with SLO-aware admission
    (`--ttft-slo`), reporting goodput / shed rate.  With `--virtual-clock`
    the run is deterministic and holds the smoke contract: nonzero goodput,
    zero unexplained sheds (else exit nonzero)."""
    cfg = engine.cfg
    n_req = args.requests if args.requests > 0 else 8
    clock = VirtualClock() if args.virtual_clock else MonotonicClock()
    gen = GenerationConfig(max_new_tokens=n_out, sampling=_sampling(args))
    mix = LengthMix(prompt_min=max(2, n_in // 4), prompt_max=n_in,
                    new_min=max(2, n_out // 2), new_max=n_out)
    sched = RequestScheduler(engine, classes=[(args.slots, n_in + n_out)], gen=gen,
                             chunk_size=args.chunk_size, seed=2, obs=engine.obs,
                             clock=clock.now)
    frontend = ServingFrontend(
        sched, config=FrontendConfig(ttft_slo_s=args.ttft_slo, journal=True), clock=clock)
    arrivals = (BurstyArrivals(args.rate) if args.arrival == "bursty"
                else PoissonArrivals(args.rate))
    workload = Workload(arrivals=arrivals, lengths=mix, n_requests=n_req,
                        vocab_size=cfg.vocab_size, seed=4)

    async def drive():
        async with frontend:
            return await run_open_loop(frontend, workload)

    print(f"[serve] frontend: {n_req} open-loop requests, {args.arrival} arrivals at "
          f"{args.rate:.1f} req/s, TTFT SLO {args.ttft_slo:.2f}s, "
          f"{'virtual' if args.virtual_clock else 'monotonic'} clock")
    report = clock.run(drive())
    print(f"[serve] elapsed {report.elapsed_s:.3f}s"
          f"{' (virtual)' if args.virtual_clock else ''}: "
          f"{report.completed}/{report.n_requests} completed, {report.met_slo} met SLO "
          f"-> goodput {report.goodput_rps:.2f} req/s, shed rate {report.shed_rate:.2f}")
    ttft = report.to_dict().get("ttft")
    if ttft:
        print(f"[serve] TTFT p50/p95/p99: {ttft['p50']:.4f}/{ttft['p95']:.4f}/"
              f"{ttft['p99']:.4f} s")
    if args.virtual_clock:
        if report.goodput_rps <= 0:
            raise SystemExit("[serve] frontend smoke FAILED: zero goodput")
        if report.sheds_unexplained:
            raise SystemExit(f"[serve] frontend smoke FAILED: "
                             f"{report.sheds_unexplained} unexplained sheds")
        print(f"[serve] frontend smoke OK: goodput {report.goodput_rps:.2f} req/s, "
              f"0 unexplained sheds, {len(frontend.journal)} journal events")


def _export_obs(obs: Observability, args) -> None:
    """Write the run's trace / metrics artifacts, when asked for."""
    if args.trace:
        obs.tracer.export(args.trace)
        print(f"[serve] trace: {len(obs.tracer.events)} events -> {args.trace} "
              f"(open in Perfetto / chrome://tracing)")
    if args.metrics:
        with open(args.metrics, "w") as f:
            json.dump(obs.metrics.snapshot(), f, indent=2)
            f.write("\n")
        print(f"[serve] metrics snapshot -> {args.metrics}")


def main(argv: list[str] | None = None) -> None:
    ap = parser()
    args = ap.parse_args(argv)
    for flag, dest, item, what in UNPORTED:
        if getattr(args, dest):
            ap.error(f"{flag}: {what} is not ported to repro_torch yet "
                     f"(ROADMAP {item})")

    if args.oversubscribe:
        if args.oversubscribe <= 1.0:
            ap.error("--oversubscribe is a request-to-lane ratio and must be > 1.0 "
                     "(omit it to disable)")
        if args.requests > 0:
            args.slots = max(1, round(args.requests / args.oversubscribe))

    scen = edge_model.LISO if args.scenario == "LISO" else edge_model.SILO
    n_in = max(2, int(scen.tokens_in * args.scale))
    n_out = max(2, int(scen.tokens_out * args.scale))
    spec = EngineSpec(quantize=not args.no_quant, reduced=args.reduced,
                      fuse_rmsnorm=not args.unfused_norm)
    # One bundle across the engine, the scheduler and the pool.
    obs = Observability()
    if args.trace:
        obs.tracer = Tracer()
    engine = InferenceEngine.from_config(args.arch, spec, device=args.device, obs=obs)
    cfg = engine.cfg
    if args.frontend:
        _run_frontend_demo(engine, args, n_in, n_out)
        return _export_obs(obs, args)
    if args.requests > 0:
        _run_scheduler_demo(engine, args, n_in, n_out)
        return _export_obs(obs, args)
    print(f"[serve] {cfg.name} scenario={scen.name} in/out={n_in}/{n_out} "
          f"batch={args.batch}")
    if not args.no_quant:
        print("[serve] deployed: W8A8 prefill / MXINT4 (4.25b) decode weights")

    dev = engine.device
    prompts = torch.randint(1, cfg.vocab_size, (args.batch, n_in),
                            generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    gen = GenerationConfig(max_new_tokens=n_out, sampling=_sampling(args),
                           speculative=_speculative(args))
    res = engine.generate(prompts, gen,
                          generator=torch.Generator(device=dev).manual_seed(2))
    if args.speculative:
        print(f"[serve] speculative: {res.verify_steps} verify steps, "
              f"{res.accepted_drafts}/{res.drafted} drafts accepted "
              f"({res.tokens_per_step:.2f} tokens/step)")
    total = n_in + n_out
    t_p, t_d = res.prefill_s, res.decode_s
    print(f"[serve] prefill {t_p*1e3:.0f} ms, decode {t_d*1e3:.0f} ms "
          f"({t_d/n_out*1e3:.1f} ms/token)")
    print(f"[serve] {scen.name} tokens/s (paper convention, prompt+output): "
          f"{args.batch * total / (t_p + t_d):.2f}")
    print(f"[serve] sample output tokens: {res.tokens[0, :16].tolist()}")
    _export_obs(obs, args)


if __name__ == "__main__":
    main()
