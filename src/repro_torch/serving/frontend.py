"""Async serving front end: open-loop arrivals over `RequestScheduler`.

`ServingFrontend` is the seam between callers that arrive whenever they
like and the scheduler's synchronous sequencer cycle:

  * **submit** is non-blocking: it runs the SLO admission policy, enqueues
    the request, and hands back a `TokenStream` — an async iterator that
    yields tokens as the scheduler commits them and resolves to the
    request's `FinishedRequest`.  ``await stream.aclose()`` (or
    ``frontend.cancel(uid)``) cancels mid-stream: the scheduler drops the
    slot and the stream finishes with
    ``cancelled=True``.
  * a **stepper task** owns the scheduler: one `step()` per loop iteration
    while work is pending, a cooperative ``clock.sleep(step_period_s)``
    between cycles, and an idle wait when the pool drains — requests from
    any number of concurrent submitters serialize through it, so the
    scheduler itself stays single-threaded and lock-free.
  * the **SLO admission policy** reads the live windowed p99 of
    ``sched.ttft_s`` from the metrics registry and sheds (or
    deprioritizes) new arrivals while the tail breaches the target —
    goodput protection under open-loop overload.  A guaranteed-admit floor
    and a minimum-evidence threshold keep it from shedding an idle or
    cold system; a shed without a justifying breach would be a policy bug
    and is counted separately (``frontend.shed_unexplained`` — the CI
    smoke asserts it stays zero).

Everything time-shaped goes through the injectable `Clock` (clock.py): the
frontend requires its clock and the scheduler's latency timebase to be the
same object's ``now`` — windowed percentiles filter recorded timestamps
against the policy's "now", and mixing timebases would silently empty or
flood the window.  Under `VirtualClock` the whole stack is wall-clock-free
and deterministic (tests/test_torch_frontend.py); under the default
`MonotonicClock` it serves real arrivals (`serve.py --frontend`).

Metrics (`frontend.*`): submitted / admitted / shed / shed_unexplained /
deprioritized / completed / cancelled counters, an ``inflight`` gauge, and
a ``ttft_p99_s`` gauge tracking what the policy last saw.  A copy of the
reference's `serving/frontend.py` over the port's scheduler.
"""

from __future__ import annotations

import asyncio
import dataclasses
from typing import Callable, Sequence

from repro_torch.obs.metrics import MetricsRegistry, percentile
from repro_torch.serving.clock import Clock, MonotonicClock
from repro_torch.serving.scheduler import (FinishedRequest, Request,
                                     RequestScheduler)

__all__ = ["AdmissionDecision", "FrontendConfig", "RequestShed",
           "SLOAdmissionPolicy", "ServingFrontend", "TokenStream"]

_SHED_ACTIONS = ("shed", "deprioritize", "off")


class RequestShed(RuntimeError):
    """Raised by `ServingFrontend.submit` when the admission policy sheds
    the arrival.  Carries what the policy saw so callers (and the load
    generator's goodput report) can attribute the decision."""

    def __init__(self, uid: int, p99: float | None, target: float):
        tail = "no window evidence" if p99 is None else f"p99 {p99:.4f}s"
        super().__init__(f"request {uid} shed: recent TTFT {tail} vs "
                         f"{target:.4f}s SLO target")
        self.uid = uid
        self.p99 = p99
        self.target = target


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Knobs for the SLO admission policy and the stepper.

    ``ttft_slo_s`` is the target the windowed ``sched.ttft_s`` tail is held
    against; ``slo_quantile``/``slo_window_s`` define "the tail";
    ``min_slo_samples`` is the evidence floor below which the policy always
    admits (a cold window proves nothing); ``guaranteed_admit`` is the
    inflight floor below which arrivals are *never* shed (an idle server
    must take work no matter what the trailing window says);
    ``shed_action`` picks the breach response — refuse (``'shed'``), admit
    at ``deprioritize_level`` (``'deprioritize'``, pairs with the
    scheduler's priority admission/preemption), or ``'off'`` (policy
    disabled, every arrival admits — the token-identity tests run here).
    ``step_period_s`` spaces sequencer cycles (0 = cooperative yield only);
    ``journal=True`` records a deterministic per-event text log.
    """

    ttft_slo_s: float = 1.0
    slo_quantile: float = 99.0
    slo_window_s: float = 30.0
    min_slo_samples: int = 8
    guaranteed_admit: int = 1
    shed_action: str = "shed"
    deprioritize_level: int = -1
    step_period_s: float = 0.0
    journal: bool = False

    def __post_init__(self):
        if self.shed_action not in _SHED_ACTIONS:
            raise ValueError(f"shed_action must be one of {_SHED_ACTIONS}, "
                             f"got {self.shed_action!r}")
        if self.ttft_slo_s <= 0:
            raise ValueError(f"ttft_slo_s must be > 0, got {self.ttft_slo_s}")
        if not 0.0 <= self.slo_quantile <= 100.0:
            raise ValueError(f"slo_quantile must be in [0, 100], got "
                             f"{self.slo_quantile}")
        if self.slo_window_s <= 0:
            raise ValueError(f"slo_window_s must be > 0, got "
                             f"{self.slo_window_s}")
        if self.min_slo_samples < 0 or self.guaranteed_admit < 0:
            raise ValueError("min_slo_samples and guaranteed_admit must be "
                             ">= 0")
        if self.step_period_s < 0:
            raise ValueError(f"step_period_s must be >= 0, got "
                             f"{self.step_period_s}")


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """What the policy decided and the evidence it decided on."""

    action: str                  # 'admit' | 'shed' | 'deprioritize'
    p99: float | None            # windowed TTFT quantile (None: empty window)
    n_samples: int               # samples inside the window
    inflight: int                # frontend-accepted, not yet finished

    def justified(self, cfg: FrontendConfig) -> bool:
        """A non-admit is *explained* iff every gate actually passed: enough
        evidence, above the floor, and a real breach.  Anything else is a
        policy bug (`frontend.shed_unexplained`)."""
        return (self.p99 is not None
                and self.n_samples >= cfg.min_slo_samples
                and self.inflight >= cfg.guaranteed_admit
                and self.p99 > cfg.ttft_slo_s)


class SLOAdmissionPolicy:
    """Windowed-tail admission: shed/deprioritize while recent TTFT p99
    breaches the target.  Stateless between calls — every decision re-reads
    the live histogram, so recovery is automatic once the breach samples
    age out of the window."""

    def __init__(self, cfg: FrontendConfig, metrics: MetricsRegistry,
                 now: Callable[[], float]):
        self.cfg = cfg
        self._metrics = metrics
        self._now = now

    def decide(self, inflight: int) -> AdmissionDecision:
        cfg = self.cfg
        window = self._metrics.histogram("sched.ttft_s").window_samples(
            cfg.slo_window_s, self._now())
        p99 = (percentile(window, cfg.slo_quantile) if window else None)
        d = AdmissionDecision("admit", p99, len(window), inflight)
        if cfg.shed_action == "off":
            return d
        if d.justified(cfg):
            return dataclasses.replace(d, action=cfg.shed_action)
        return d


class TokenStream:
    """One submitted request's token stream.

    ``async for tok in stream`` yields tokens in commit order;
    ``await stream.result()`` resolves to the `FinishedRequest` (set for
    every terminal state — drained, cancelled, queued-cancel);
    ``await stream.aclose()`` cancels the request mid-stream.  If the
    frontend's stepper dies, the failure is re-raised here rather than
    leaving consumers waiting forever.
    """

    _DONE = object()

    def __init__(self, frontend: "ServingFrontend", uid: int,
                 prompt_len: int):
        self._frontend = frontend
        self.uid = uid
        self.prompt_len = prompt_len
        self._queue: asyncio.Queue = asyncio.Queue()
        self._done = asyncio.Event()
        self._result: FinishedRequest | None = None
        self._error: BaseException | None = None
        self._saw_token = False

    def __aiter__(self) -> "TokenStream":
        return self

    async def __anext__(self) -> int:
        tok = await self._queue.get()
        if tok is TokenStream._DONE:
            self._queue.put_nowait(TokenStream._DONE)  # keep re-iterable
            if self._error is not None:
                raise self._error
            raise StopAsyncIteration
        return tok

    async def result(self) -> FinishedRequest:
        await self._done.wait()
        if self._error is not None:
            raise self._error
        if self._result is None:
            raise RuntimeError(f"stream {self.uid} finished without a result")
        return self._result

    async def aclose(self) -> None:
        await self._frontend.cancel(self.uid)

    # -- frontend-side completion --------------------------------------------

    def _push(self, tok: int) -> None:
        self._queue.put_nowait(tok)

    def _finish(self, fr: FinishedRequest) -> None:
        self._result = fr
        self._done.set()
        self._queue.put_nowait(TokenStream._DONE)

    def _fail(self, exc: BaseException) -> None:
        if self._done.is_set():
            return
        self._error = exc
        self._done.set()
        self._queue.put_nowait(TokenStream._DONE)


class ServingFrontend:
    """Asyncio front end over one `RequestScheduler` (module docstring has
    the full story).  Use as an async context manager::

        async with ServingFrontend(sched, config=cfg, clock=clock) as fe:
            stream = fe.submit(prompt)          # may raise RequestShed
            async for tok in stream: ...
            finished = await stream.result()
    """

    def __init__(self, scheduler: RequestScheduler, *,
                 config: FrontendConfig | None = None,
                 clock: Clock | None = None):
        if scheduler.on_token is not None or scheduler.on_finish is not None:
            raise ValueError("ServingFrontend needs exclusive use of the "
                             "scheduler's on_token/on_finish callbacks")
        self.scheduler = scheduler
        self.config = config if config is not None else FrontendConfig()
        if clock is None:
            # Adopt the scheduler's timebase (perf_counter unless the
            # scheduler itself was built with an injected clock).
            clock = MonotonicClock(scheduler._now)
        elif clock.now != scheduler._now and not (
                isinstance(clock, MonotonicClock)
                and clock._now_fn == scheduler._now):
            raise ValueError(
                "frontend clock and scheduler timebase differ: build the "
                "scheduler with clock=<clock>.now so windowed SLO "
                "percentiles and the policy's `now` share one timebase")
        self.clock = clock
        self.obs = scheduler.obs
        self._now = scheduler._now
        m = self.obs.metrics
        self.stats = m.counter_view(
            "frontend.", ["submitted", "admitted", "shed", "shed_unexplained",
                          "deprioritized", "completed", "cancelled"])
        self.policy = SLOAdmissionPolicy(self.config, m, self._now)
        self.journal: list[str] = []
        self._streams: dict[int, TokenStream] = {}
        self._next_uid = 0
        self._wake: asyncio.Event | None = None
        self._stepper_task: asyncio.Task | None = None
        self._stepper_error: BaseException | None = None
        scheduler.on_token = self._on_token
        scheduler.on_finish = self._on_finish

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        if self._stepper_task is not None:
            raise RuntimeError("frontend already started")
        self._wake = asyncio.Event()
        if self.scheduler.pending:
            self._wake.set()
        self._stepper_task = asyncio.ensure_future(self._stepper())

    async def stop(self) -> None:
        """Stop the stepper.  In-flight requests stay resident in the
        scheduler (a restarted frontend, or a direct ``run()``, can drain
        them); streams of a *crashed* stepper have already been failed."""
        task, self._stepper_task = self._stepper_task, None
        if task is None:
            return
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass

    async def __aenter__(self) -> "ServingFrontend":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    @property
    def inflight(self) -> int:
        """Accepted and not yet finished (queued + admitting + active +
        preempted, as seen from the frontend)."""
        return len(self._streams)

    # -- submission / cancellation -------------------------------------------

    def submit(self, prompt: Sequence[int], *, uid: int | None = None,
               max_new_tokens: int | None = None,
               priority: int = 0) -> TokenStream:
        """Admit one open-loop arrival (non-blocking).  Raises `RequestShed`
        when the SLO policy refuses it; propagates the scheduler's
        submission-time validation errors (e.g. `CacheCapacityError`)."""
        if self._stepper_task is None:
            raise RuntimeError("frontend not started — use "
                               "`async with frontend:` or await start()")
        if self._stepper_error is not None:
            raise RuntimeError("frontend stepper failed") \
                from self._stepper_error
        if uid is None:
            uid = self._next_uid
        if uid in self._streams:
            raise ValueError(f"uid {uid} is already in flight")
        self._next_uid = max(self._next_uid, uid + 1)
        self.stats["submitted"] += 1
        d = self.policy.decide(self.inflight)
        m = self.obs.metrics
        if d.p99 is not None:
            m.gauge("frontend.ttft_p99_s").set(d.p99)
        if d.action == "shed":
            self.stats["shed"] += 1
            if not d.justified(self.config):
                self.stats["shed_unexplained"] += 1
            self._journal("shed", uid, p99=_fmt(d.p99), n=d.n_samples)
            raise RequestShed(uid, d.p99, self.config.ttft_slo_s)
        if d.action == "deprioritize":
            self.stats["deprioritized"] += 1
            priority = min(priority, self.config.deprioritize_level)
            self._journal("deprioritize", uid, p99=_fmt(d.p99),
                          level=priority)
        stream = TokenStream(self, uid, len(prompt))
        self._streams[uid] = stream
        try:
            self.scheduler.submit(Request(uid=uid, prompt=list(prompt),
                                          max_new_tokens=max_new_tokens,
                                          priority=priority))
        except Exception:
            del self._streams[uid]
            raise
        self.stats["admitted"] += 1
        self._journal("submit", uid, prompt=len(prompt))
        self._set_gauges()
        self._wake.set()
        return stream

    async def cancel(self, uid: int) -> bool:
        """Cancel an in-flight request.  The stream resolves with
        ``cancelled=True`` (partial tokens preserved); returns False when
        the uid is unknown or already finished."""
        stream = self._streams.get(uid)
        if stream is None:
            return False
        self.stats["cancelled"] += 1
        self._journal("cancel", uid)
        self.scheduler.cancel(uid)
        if stream._result is None:
            # Queued-but-unstarted cancels record no FinishedRequest in the
            # scheduler (nothing ever held a slot); synthesize the terminal
            # record so `result()` awaiters resolve.
            self._finish_stream(FinishedRequest(
                uid=uid, prompt_len=stream.prompt_len, tokens=[], slot=-1,
                cache_len=0, cancelled=True))
        return True

    # -- scheduler callbacks (fire inside step()/cancel()) -------------------

    def _on_token(self, uid: int, tok: int) -> None:
        stream = self._streams.get(uid)
        if stream is not None:
            if not stream._saw_token:
                stream._saw_token = True
                self._journal("first_token", uid)
            stream._push(tok)

    def _on_finish(self, fr: FinishedRequest) -> None:
        self._finish_stream(fr)

    def _finish_stream(self, fr: FinishedRequest) -> None:
        stream = self._streams.pop(fr.uid, None)
        if stream is None:
            return
        if not fr.cancelled:
            self.stats["completed"] += 1
        self._journal("finish", fr.uid, tokens=len(fr.tokens),
                      cancelled=fr.cancelled)
        stream._finish(fr)
        self._set_gauges()

    # -- the stepper ---------------------------------------------------------

    async def _stepper(self) -> None:
        """The one task allowed to call ``scheduler.step()``: drains while
        work is pending, parks on the wake event when idle, and on failure
        fails every live stream (consumers see the exception, not a hang)."""
        sched = self.scheduler
        try:
            while True:
                if not sched.pending:
                    self._wake.clear()
                    if not sched.pending:       # nothing raced in before clear
                        await self._wake.wait()
                    continue
                sched.step()
                self._set_gauges()
                await self.clock.sleep(self.config.step_period_s)
        except asyncio.CancelledError:
            raise
        except BaseException as e:
            self._stepper_error = e
            for stream in list(self._streams.values()):
                stream._fail(e)
            self._streams.clear()
            raise

    # -- misc ----------------------------------------------------------------

    def _set_gauges(self) -> None:
        self.obs.metrics.gauge("frontend.inflight").set(len(self._streams))

    def _journal(self, event: str, uid: int, **kw) -> None:
        if not self.config.journal:
            return
        extra = "".join(f" {k}={kw[k]}" for k in sorted(kw))
        self.journal.append(f"{self._now():.9f} {event} uid={uid}{extra}")


def _fmt(x: float | None) -> str:
    return "none" if x is None else f"{x:.9f}"
