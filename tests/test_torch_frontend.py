"""The asyncio serving front end of repro_torch, on virtual time.

Every async path — arrival pacing, SLO shedding, cancellation, the
stepper's idle parking — runs on the port's `VirtualClock`: sleeps and
timeouts resolve by jumping virtual time, so the module is wall-clock-free
and two runs are event-for-event identical.  The scheduler's latency
histograms record on the same timebase (``clock=clock.now``), which makes
the windowed SLO policy assertable to the sample.  These are the
reference's own front-end checks (tests/test_serving_frontend.py) on the
port's scheduler (reduced models, the JAX engines' fp weights carried over),
plus the open-loop load generator against the reference's for the same seed.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time

import pytest
from test_torch_scheduler import ARCH_IDS, ARCHS, engines, prompts

from repro.serving import BurstyArrivals as JBursty
from repro.serving import LengthMix as JLengthMix
from repro.serving import PoissonArrivals as JPoisson
from repro.serving import Workload as JWorkload
from repro_torch.obs import Observability
from repro_torch.serving import (BurstyArrivals, FinishedRequest, FrontendConfig,
                                 GenerationConfig, LengthMix, MonotonicClock,
                                 PoissonArrivals, Request, RequestScheduler, RequestShed,
                                 ServingFrontend, VirtualClock, Workload, run_open_loop)


def make_stack(arch: str = "retnet-1.3b", *, classes=((2, 48),), chunk_size: int = 8,
               max_new: int = 4, config: FrontendConfig | None = None, **sched_kw):
    _, engine = engines(arch)
    clock = VirtualClock()
    sched = RequestScheduler(engine, classes=[tuple(c) for c in classes],
                             gen=GenerationConfig(max_new_tokens=max_new),
                             chunk_size=chunk_size, obs=Observability(), clock=clock.now,
                             **sched_kw)
    frontend = ServingFrontend(
        sched, config=config if config is not None else FrontendConfig(journal=True),
        clock=clock)
    return engine, sched, frontend, clock


def prompt_of(engine, s: int, seed: int = 1) -> list[int]:
    return prompts(engine.cfg.vocab_size, [s], seed=seed)[0]


# -- the virtual clock itself -------------------------------------------------


def test_virtual_clock_orders_timers_without_wall_time():
    clock = VirtualClock()
    log = []

    async def sleeper(dt, name):
        await clock.sleep(dt)
        log.append((clock.now(), name))

    async def main():
        await asyncio.gather(sleeper(120.0, "b"), sleeper(60.0, "a"), sleeper(120.0, "c"))

    t0 = time.perf_counter()
    clock.run(main())
    wall = time.perf_counter() - t0
    # 4 simulated minutes; ties resolve in creation order, deterministically.
    assert log == [(60.0, "a"), (120.0, "b"), (120.0, "c")]
    assert wall < 5.0, f"virtual sleeps burned {wall:.1f}s of wall clock"


def test_virtual_clock_deadlock_raises():
    clock = VirtualClock()

    async def hang():
        await asyncio.Event().wait()      # nothing will ever set it

    with pytest.raises(RuntimeError, match="deadlock"):
        clock.run(hang())


def test_frontend_rejects_mismatched_clock():
    _, engine = engines("retnet-1.3b")
    sched = RequestScheduler(engine, classes=[(1, 32)],
                             gen=GenerationConfig(max_new_tokens=2), chunk_size=8)
    with pytest.raises(ValueError, match="timebase"):
        ServingFrontend(sched, clock=VirtualClock())
    ServingFrontend(sched, clock=MonotonicClock(sched._now))


# -- greedy token identity: front end against a direct run() --------------------

PROMPT_LENS = [5, 9, 14]


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_frontend_tokens_match_direct_run(arch):
    _, engine = engines(arch)
    reqs = {uid: prompt_of(engine, s, seed=2 + uid) for uid, s in enumerate(PROMPT_LENS)}

    def sched_for(clock=None):
        return RequestScheduler(engine, classes=[(2, 32)],
                                gen=GenerationConfig(max_new_tokens=4), chunk_size=8,
                                obs=Observability(), clock=clock.now if clock else None)

    direct = sched_for()
    for uid, p in reqs.items():
        direct.submit(Request(uid=uid, prompt=p))
    want = direct.run()

    clock = VirtualClock()
    frontend = ServingFrontend(sched_for(clock), clock=clock)

    async def main():
        got: dict[int, list[int]] = {}

        async def consume(stream):
            got[stream.uid] = [tok async for tok in stream]

        async with frontend:
            tasks = []
            for uid, p in reqs.items():
                # Staggered arrivals: the interleaving differs from the
                # closed-loop drain, the tokens must not.
                await clock.sleep(0.05 * (uid + 1))
                tasks.append(asyncio.ensure_future(consume(frontend.submit(p, uid=uid))))
            await asyncio.gather(*tasks)
        return got

    got = clock.run(main())
    assert set(got) == set(want)
    for uid in want:
        assert got[uid] == want[uid].tokens, f"{arch} uid {uid}"


# -- shed exactly at the windowed p99 crossing ------------------------------------


def _shed_config(**kw) -> FrontendConfig:
    base = dict(ttft_slo_s=0.5, slo_window_s=10.0, min_slo_samples=4, guaranteed_admit=0,
                journal=True)
    base.update(kw)
    return FrontendConfig(**base)


def test_shed_fires_exactly_at_p99_breach():
    engine, sched, frontend, clock = make_stack(config=_shed_config())
    hist = sched.obs.metrics.histogram("sched.ttft_s")
    prompt = prompt_of(engine, 5)

    async def main():
        async with frontend:
            # Below target: p99 of these == 0.49 < 0.5 -> admit.
            for v in (0.40, 0.45, 0.40, 0.49):
                hist.record(v, t=clock.now())
            s0 = frontend.submit(prompt, uid=0)
            assert [t async for t in s0] != []

            # Exactly AT the target: strict inequality -> still admit.
            for v in (0.50, 0.50, 0.50, 0.50):
                hist.record(v, t=clock.now())
            s1 = frontend.submit(prompt, uid=1)
            await s1.result()

            # Crossing: one tail sample pushes the windowed p99 over.
            hist.record(0.70, t=clock.now())
            with pytest.raises(RequestShed) as exc:
                frontend.submit(prompt, uid=2)
            assert exc.value.p99 is not None and exc.value.p99 > 0.5

            # Window expiry: the breach evidence ages out, admission resumes.
            await clock.sleep(frontend.config.slo_window_s + 1.0)
            s3 = frontend.submit(prompt, uid=3)
            await s3.result()

    clock.run(main())
    assert frontend.stats["shed"] == 1
    assert frontend.stats["shed_unexplained"] == 0
    assert frontend.stats["admitted"] == 3
    assert any(" shed uid=2" in line for line in frontend.journal)


def test_shed_respects_min_samples_floor():
    engine, sched, frontend, clock = make_stack(config=_shed_config(min_slo_samples=6))
    hist = sched.obs.metrics.histogram("sched.ttft_s")
    prompt = prompt_of(engine, 5)

    async def main():
        async with frontend:
            for v in (9.0, 9.0, 9.0):       # wildly over target, 3 < 6
                hist.record(v, t=clock.now())
            s = frontend.submit(prompt, uid=0)     # thin evidence -> admit
            await s.result()

    clock.run(main())
    assert frontend.stats["shed"] == 0


def test_deprioritize_action_admits_at_lower_priority():
    engine, sched, frontend, clock = make_stack(
        config=_shed_config(shed_action="deprioritize", deprioritize_level=-3))
    hist = sched.obs.metrics.histogram("sched.ttft_s")
    prompt = prompt_of(engine, 5)
    seen: dict[int, int] = {}
    orig_submit = sched.submit
    sched.submit = lambda req, priority=None: (
        seen.__setitem__(req.uid, req.priority), orig_submit(req, priority))[1]

    async def main():
        async with frontend:
            for v in (0.9,) * 5:
                hist.record(v, t=clock.now())
            s = frontend.submit(prompt, uid=0)      # breached -> deprioritize
            await s.result()

    clock.run(main())
    assert frontend.stats["deprioritized"] == 1
    assert frontend.stats["shed"] == 0
    assert seen[0] == -3


# -- cancellation -------------------------------------------------------------------


def test_midstream_cancel_releases_the_slot():
    engine, sched, frontend, clock = make_stack("qwen3-8b", classes=((2, 64),), max_new=6)
    prompt = prompt_of(engine, 40, seed=3)

    async def main():
        async with frontend:
            s1 = frontend.submit(prompt, uid=1)
            got = []
            async for tok in s1:
                got.append(tok)
                if len(got) == 2:
                    break
            await s1.aclose()
            fin = await s1.result()
            assert fin.cancelled
            assert fin.tokens[:2] == got
            assert sched.pool.free_slots == 2

            # The pool is reusable: another request drains clean.
            s2 = frontend.submit(prompt_of(engine, 12, seed=5), uid=2)
            async for _ in s2:
                pass
            assert not (await s2.result()).cancelled

    clock.run(main())
    assert frontend.stats["cancelled"] == 1
    assert frontend.stats["completed"] == 1


def test_cancel_mid_chunked_prefill_reports_and_frees():
    _, engine = engines("qwen3-8b")
    finished: list[FinishedRequest] = []
    sched = RequestScheduler(engine, classes=[(2, 64)], gen=GenerationConfig(max_new_tokens=4),
                             chunk_size=8, on_finish=finished.append)
    sched.submit(Request(uid=1, prompt=prompt_of(engine, 40, seed=9)))
    sched.step()                               # chunk 1 of 5
    assert sched._admitting is not None and not sched._admitting["prefill"].done
    assert sched.pool.free_slots == 1
    assert sched.cancel(1)
    assert sched.pool.free_slots == 2, "cancel leaked the admitting slot"
    assert [f.uid for f in finished] == [1]
    assert finished[0].cancelled and finished[0].tokens == []
    results = sched.run()
    assert 1 in results and results[1].cancelled


def test_queued_cancel_resolves_stream():
    # More requests than lanes: uid 2 is still queued when cancelled; the
    # scheduler records nothing for it and the front end makes the record.
    engine, sched, frontend, clock = make_stack(classes=((1, 48),))
    prompt = prompt_of(engine, 30)

    async def main():
        async with frontend:
            s0 = frontend.submit(prompt, uid=0)
            s2 = frontend.submit(prompt_of(engine, 20, seed=4), uid=2)
            await asyncio.sleep(0)           # let the stepper start uid 0
            assert await frontend.cancel(2)
            fin = await s2.result()
            assert fin.cancelled and fin.tokens == [] and fin.slot == -1
            async for _ in s0:
                pass

    clock.run(main())
    assert frontend.stats["cancelled"] == 1


# -- seeded runs and the load generator --------------------------------------------


def _seeded_run():
    engine, sched, frontend, clock = make_stack(max_new=4)
    workload = Workload(arrivals=BurstyArrivals(20.0), lengths=LengthMix(4, 16, 2, 4),
                        n_requests=6, vocab_size=engine.cfg.vocab_size, seed=7)

    async def main():
        async with frontend:
            return await run_open_loop(frontend, workload)

    return frontend.journal, clock.run(main())


def test_seeded_runs_byte_identical():
    journal1, report1 = _seeded_run()
    journal2, report2 = _seeded_run()
    assert journal1, "journal unexpectedly empty"
    assert ("\n".join(journal1)).encode() == ("\n".join(journal2)).encode()
    assert ([dataclasses.asdict(o) for o in report1.outcomes]
            == [dataclasses.asdict(o) for o in report2.outcomes])
    assert report1.elapsed_s == report2.elapsed_s
    assert report1.completed == 6 and report1.sheds_unexplained == 0
    assert report1.goodput_rps > 0 and report1.to_dict()["ttft"]["p99"] >= 0


@pytest.mark.parametrize("arrival", ["poisson", "bursty"])
@pytest.mark.parametrize("seed", [0, 13, 29])
def test_workload_requests_equal_the_reference(arrival, seed):
    mine_a, ref_a = ((PoissonArrivals(3.5), JPoisson(3.5)) if arrival == "poisson"
                     else (BurstyArrivals(3.5), JBursty(3.5)))
    mine = Workload(arrivals=mine_a, lengths=LengthMix(6, 24, 8, 8), n_requests=8,
                    vocab_size=32000, seed=seed).requests()
    ref = JWorkload(arrivals=ref_a, lengths=JLengthMix(6, 24, 8, 8), n_requests=8,
                    vocab_size=32000, seed=seed).requests()
    assert [dataclasses.asdict(r) for r in mine] == [dataclasses.asdict(r) for r in ref]
