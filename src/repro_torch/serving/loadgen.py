"""Open-loop load generation for the serving front end.

Closed-loop benches (submit N, drain, divide) measure a server that is
never actually under pressure: the arrival process *is* the completion
process.  Production traffic is open-loop — arrivals come when they come —
and the number that matters is **goodput**: requests that met their SLO
per second, against the offered rate, with the shed rate alongside.

This module supplies the three pieces:

  * arrival processes — seeded `PoissonArrivals` and `BurstyArrivals`
    (a 2-state Markov-modulated Poisson process: calm/burst rates with a
    geometric dwell, parametrized so the *stationary mean* rate equals the
    configured ``rate_rps`` — burstiness changes variance, not offered
    load);
  * `LengthMix` — shareGPT-shaped lognormal prompt/output lengths clipped
    to a configured support (so cache-class sizing stays honest);
  * `Workload` (a fully seeded request set: uid, arrival time, prompt,
    budget) and `run_open_loop`, which paces submissions on the
    frontend's clock — virtual in tests and smoke runs, monotonic on the card —
    consumes every admitted stream concurrently, and folds the outcomes
    into a `GoodputReport`.

Everything is reproducible by construction: one `numpy` Generator seeded
from `Workload.seed` drives arrivals, lengths, and prompt tokens, and
`run_open_loop` consults no other randomness: from the same seed a
`Workload` gives the reference's arrivals, lengths and prompt tokens.
"""

from __future__ import annotations

import asyncio
import dataclasses
import math

import numpy as np

from repro_torch.obs.metrics import percentile
from repro_torch.serving.frontend import RequestShed, ServingFrontend

__all__ = ["ArrivalProcess", "BurstyArrivals", "GoodputReport", "LengthMix",
           "OpenLoopRequest", "PoissonArrivals", "RequestOutcome", "Workload",
           "run_open_loop"]


class ArrivalProcess:
    """Seeded interarrival sampler; ``rate_rps`` is the stationary mean."""

    rate_rps: float

    def interarrivals(self, n: int, rng: np.random.Generator) -> list[float]:
        raise NotImplementedError

    def times(self, n: int, rng: np.random.Generator) -> list[float]:
        """Cumulative arrival times of the first ``n`` requests."""
        out, t = [], 0.0
        for dt in self.interarrivals(n, rng):
            t += dt
            out.append(t)
        return out


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Memoryless arrivals: i.i.d. exponential interarrivals."""

    rate_rps: float

    def __post_init__(self):
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")

    def interarrivals(self, n: int, rng: np.random.Generator) -> list[float]:
        return rng.exponential(1.0 / self.rate_rps, size=n).tolist()


@dataclasses.dataclass(frozen=True)
class BurstyArrivals(ArrivalProcess):
    """2-state Markov-modulated Poisson process.

    Arrivals alternate between a *calm* regime and a *burst* regime whose
    instantaneous rate is ``burst_factor`` times the calm rate; regime
    dwell is geometric with ``mean_burst_len`` arrivals per burst, and
    ``p_burst`` is the stationary fraction of arrivals drawn in the burst
    regime.  The calm/burst rates are solved so the stationary mean
    interarrival is exactly ``1 / rate_rps`` — the same offered load as
    `PoissonArrivals(rate_rps)`, with the variance (and queue pain)
    concentrated into bursts.
    """

    rate_rps: float
    burst_factor: float = 4.0
    p_burst: float = 0.25
    mean_burst_len: float = 8.0

    def __post_init__(self):
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        if self.burst_factor < 1.0:
            raise ValueError(f"burst_factor must be >= 1, got "
                             f"{self.burst_factor}")
        if not 0.0 < self.p_burst < 1.0:
            raise ValueError(f"p_burst must be in (0, 1), got {self.p_burst}")
        if self.mean_burst_len < 1.0:
            raise ValueError(f"mean_burst_len must be >= 1, got "
                             f"{self.mean_burst_len}")

    def interarrivals(self, n: int, rng: np.random.Generator) -> list[float]:
        # E[dt] = p_burst/rate_burst + (1-p_burst)/rate_calm = 1/rate_rps
        # with rate_burst = burst_factor * rate_calm.
        rate_calm = self.rate_rps * (
            1.0 - self.p_burst + self.p_burst / self.burst_factor)
        rate_burst = self.burst_factor * rate_calm
        # Per-arrival switch probabilities whose stationary occupancy of the
        # burst state is p_burst with geometric mean dwell mean_burst_len.
        q_leave = 1.0 / self.mean_burst_len
        q_enter = q_leave * self.p_burst / (1.0 - self.p_burst)
        in_burst = bool(rng.random() < self.p_burst)
        out = []
        for _ in range(n):
            rate = rate_burst if in_burst else rate_calm
            out.append(float(rng.exponential(1.0 / rate)))
            if rng.random() < (q_leave if in_burst else q_enter):
                in_burst = not in_burst
        return out


@dataclasses.dataclass(frozen=True)
class LengthMix:
    """shareGPT-shaped request sizes: lognormal around the geometric middle
    of the support, clipped to ``[min, max]`` — most requests modest, a
    heavy right tail, and a hard ceiling the cache classes can be sized
    against."""

    prompt_min: int = 4
    prompt_max: int = 64
    new_min: int = 2
    new_max: int = 16
    sigma: float = 0.6

    def __post_init__(self):
        for lo, hi, what in ((self.prompt_min, self.prompt_max, "prompt"),
                             (self.new_min, self.new_max, "new")):
            if not 1 <= lo <= hi:
                raise ValueError(f"need 1 <= {what}_min <= {what}_max, got "
                                 f"[{lo}, {hi}]")
        if self.sigma < 0:
            raise ValueError(f"sigma must be >= 0, got {self.sigma}")

    def sample(self, n: int,
               rng: np.random.Generator) -> list[tuple[int, int]]:
        """``n`` (prompt_len, max_new_tokens) pairs within the support."""

        def draw(lo: int, hi: int) -> list[int]:
            median = math.sqrt(lo * hi)
            raw = median * rng.lognormal(0.0, self.sigma, size=n)
            return [int(min(hi, max(lo, round(x)))) for x in raw.tolist()]

        return list(zip(draw(self.prompt_min, self.prompt_max),
                        draw(self.new_min, self.new_max)))


@dataclasses.dataclass(frozen=True)
class OpenLoopRequest:
    uid: int
    at_s: float                  # arrival offset from the run's t0
    prompt: tuple[int, ...]
    max_new_tokens: int


@dataclasses.dataclass(frozen=True)
class Workload:
    """A fully materialized, seeded open-loop request set."""

    arrivals: ArrivalProcess
    lengths: LengthMix = LengthMix()
    n_requests: int = 16
    vocab_size: int = 256
    seed: int = 0

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError(f"n_requests must be >= 1, got "
                             f"{self.n_requests}")
        if self.vocab_size < 2:
            raise ValueError(f"vocab_size must be >= 2, got "
                             f"{self.vocab_size}")

    def requests(self) -> list[OpenLoopRequest]:
        rng = np.random.default_rng(self.seed)
        times = self.arrivals.times(self.n_requests, rng)
        sizes = self.lengths.sample(self.n_requests, rng)
        out = []
        for uid, (at, (plen, budget)) in enumerate(zip(times, sizes)):
            prompt = tuple(int(t) for t in rng.integers(
                1, self.vocab_size, size=plen).tolist())
            out.append(OpenLoopRequest(uid=uid, at_s=float(at),
                                       prompt=prompt,
                                       max_new_tokens=budget))
        return out


@dataclasses.dataclass
class RequestOutcome:
    """One request as `run_open_loop` saw it."""

    uid: int
    status: str                  # 'ok' | 'shed' | 'cancelled'
    submitted_s: float           # offset from the run's t0
    ttft_s: float | None = None
    latency_s: float | None = None
    n_tokens: int = 0
    met_slo: bool = False


@dataclasses.dataclass
class GoodputReport:
    """Offered load vs delivered: the goodput-under-load result block."""

    offered_rps: float
    ttft_slo_s: float
    elapsed_s: float
    outcomes: list[RequestOutcome]
    sheds_unexplained: int

    @property
    def n_requests(self) -> int:
        return len(self.outcomes)

    @property
    def completed(self) -> int:
        return sum(1 for o in self.outcomes if o.status == "ok")

    @property
    def shed(self) -> int:
        return sum(1 for o in self.outcomes if o.status == "shed")

    @property
    def met_slo(self) -> int:
        return sum(1 for o in self.outcomes if o.met_slo)

    @property
    def shed_rate(self) -> float:
        return self.shed / self.n_requests if self.outcomes else 0.0

    @property
    def goodput_rps(self) -> float:
        return self.met_slo / self.elapsed_s if self.elapsed_s > 0 else 0.0

    def to_dict(self) -> dict:
        """JSON-ready block for `serve.py` and `chip_smoke.py`."""
        ttfts = [o.ttft_s for o in self.outcomes if o.ttft_s is not None]
        out = {
            "offered_rps": self.offered_rps,
            "ttft_slo_s": self.ttft_slo_s,
            "elapsed_s": self.elapsed_s,
            "n_requests": self.n_requests,
            "completed": self.completed,
            "shed": self.shed,
            "shed_rate": self.shed_rate,
            "met_slo": self.met_slo,
            "goodput_rps": self.goodput_rps,
            "sheds_unexplained": self.sheds_unexplained,
        }
        if ttfts:
            out["ttft"] = {"p50": percentile(ttfts, 50.0),
                           "p95": percentile(ttfts, 95.0),
                           "p99": percentile(ttfts, 99.0)}
        return out


async def run_open_loop(frontend: ServingFrontend, workload: Workload, *,
                        ttft_slo_s: float | None = None) -> GoodputReport:
    """Drive ``workload`` through ``frontend`` open-loop.

    Submission times follow the workload's arrival process on the
    frontend's clock regardless of completions (that is what makes it open
    loop); every admitted stream is consumed by its own task, so slow
    requests never delay later arrivals.  ``ttft_slo_s`` defaults to the
    frontend's configured target and defines ``met_slo``.
    """
    slo = (ttft_slo_s if ttft_slo_s is not None
           else frontend.config.ttft_slo_s)
    clock = frontend.clock
    requests = workload.requests()
    outcomes: list[RequestOutcome] = []
    consumers: list[asyncio.Task] = []
    t0 = clock.now()

    async def consume(stream, t_sub: float) -> None:
        o = RequestOutcome(uid=stream.uid, status="ok",
                           submitted_s=t_sub - t0)
        async for _tok in stream:
            if o.ttft_s is None:
                o.ttft_s = clock.now() - t_sub
            o.n_tokens += 1
        fr = await stream.result()
        o.latency_s = clock.now() - t_sub
        if fr.cancelled:
            o.status = "cancelled"
        else:
            o.met_slo = o.ttft_s is not None and o.ttft_s <= slo
        outcomes.append(o)

    for req in requests:
        await clock.sleep(t0 + req.at_s - clock.now())
        t_sub = clock.now()
        try:
            stream = frontend.submit(req.prompt, uid=req.uid,
                                     max_new_tokens=req.max_new_tokens)
        except RequestShed:
            outcomes.append(RequestOutcome(uid=req.uid, status="shed",
                                           submitted_s=t_sub - t0))
            continue
        consumers.append(asyncio.ensure_future(consume(stream, t_sub)))
    if consumers:
        await asyncio.gather(*consumers)
    outcomes.sort(key=lambda o: o.uid)
    return GoodputReport(offered_rps=workload.arrivals.rate_rps,
                         ttft_slo_s=slo,
                         elapsed_s=clock.now() - t0,
                         outcomes=outcomes,
                         sheds_unexplained=frontend.stats["shed_unexplained"])
