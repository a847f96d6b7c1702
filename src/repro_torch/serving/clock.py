"""Injectable time for the async serving front end.

Everything latency-shaped in the serving stack — arrival pacing, SLO
windows, TTFT stamps, the stepper's inter-step yield — flows through one
seam: a `Clock` with ``now()`` (the timebase handed to `RequestScheduler`
and the metrics registry) and ``sleep()`` (the only way front-end code is
allowed to wait).  Two implementations:

  * `MonotonicClock` — real deployments: ``time.perf_counter`` +
    ``asyncio.sleep``.
  * `VirtualClock` — tests and CI smoke runs: time is a number this object
    owns.  ``run(coro)`` drives the coroutine on a private event loop whose
    ``time()`` is virtual and whose selector never blocks — when every task
    is waiting on a timer, the loop *jumps* virtual time to the earliest
    deadline instead of sleeping.  Async code under it is wall-clock-free
    (a 10-minute simulated load run finishes in milliseconds) and
    deterministic: asyncio's ready queue and timer heap are FIFO-stable, so
    two runs of the same coroutine see the same interleaving, timestamps
    and all.

The virtual loop still polls real file descriptors (with timeout 0), so
incidental I/O readiness keeps working; but if nothing is ready *and* no
timer is scheduled, every task is blocked forever — that is a deadlock,
and the loop raises instead of hanging the test.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Coroutine

__all__ = ["Clock", "MonotonicClock", "VirtualClock"]


class Clock:
    """The front end's time seam: ``now()`` for stamps, ``sleep()`` for
    waits, ``run()`` to drive a coroutine to completion on a loop whose
    notion of time matches ``now()``."""

    def now(self) -> float:
        raise NotImplementedError

    async def sleep(self, dt: float) -> None:
        raise NotImplementedError

    def run(self, coro: Coroutine[Any, Any, Any]) -> Any:
        raise NotImplementedError


class MonotonicClock(Clock):
    """Real time.  ``now_fn`` defaults to ``time.perf_counter`` — the same
    default the scheduler uses — and may be overridden to adopt an existing
    scheduler's timebase (`ServingFrontend` does exactly that)."""

    def __init__(self, now_fn=None):
        self._now_fn = now_fn if now_fn is not None else time.perf_counter

    def now(self) -> float:
        return self._now_fn()

    async def sleep(self, dt: float) -> None:
        await asyncio.sleep(max(0.0, dt))

    def run(self, coro: Coroutine[Any, Any, Any]) -> Any:
        return asyncio.run(coro)


class _JumpingSelector:
    """Selector wrapper that never blocks.

    The event loop computes how long it *would* sleep in ``select()``; this
    wrapper polls real FDs with timeout 0 and, when nothing is ready,
    credits that whole duration to the virtual clock — timers then fire on
    schedule in virtual time.  A would-be infinite select (no timers, no
    ready FDs) can never make progress: raise loudly rather than hang.
    """

    def __init__(self, inner, clock: "VirtualClock"):
        self._inner = inner
        self._clock = clock

    def select(self, timeout=None):
        ready = self._inner.select(0)
        if not ready and timeout:
            self._clock._t += timeout
        if not ready and timeout is None:
            raise RuntimeError(
                "virtual-clock deadlock: every task is blocked and no timer "
                "is scheduled (an await that only real time could satisfy)")
        return ready

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _VirtualTimeLoop(asyncio.SelectorEventLoop):
    """SelectorEventLoop on `VirtualClock` time: ``loop.time()`` is the
    virtual clock, so every ``call_later``/``asyncio.sleep``/timeout in the
    program schedules in virtual time; `_JumpingSelector` advances it."""

    def __init__(self, clock: "VirtualClock"):
        super().__init__()
        self._virtual = clock
        self._selector = _JumpingSelector(self._selector, clock)

    def time(self) -> float:
        return self._virtual._t


class VirtualClock(Clock):
    """Deterministic virtual time.  ``now()`` reads the owned counter;
    ``sleep()`` is a plain ``asyncio.sleep`` that the virtual loop resolves
    by jumping the counter; ``run()`` builds the loop, drives the coroutine,
    and tears down like ``asyncio.run`` (pending tasks cancelled, async
    generators shut down)."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    async def sleep(self, dt: float) -> None:
        await asyncio.sleep(max(0.0, dt))

    def run(self, coro: Coroutine[Any, Any, Any]) -> Any:
        loop = _VirtualTimeLoop(self)
        try:
            asyncio.set_event_loop(loop)
            return loop.run_until_complete(coro)
        finally:
            try:
                _cancel_pending(loop)
                loop.run_until_complete(loop.shutdown_asyncgens())
            finally:
                asyncio.set_event_loop(None)
                loop.close()


def _cancel_pending(loop: asyncio.AbstractEventLoop) -> None:
    tasks = [t for t in asyncio.all_tasks(loop) if not t.done()]
    for t in tasks:
        t.cancel()
    if tasks:
        loop.run_until_complete(
            asyncio.gather(*tasks, return_exceptions=True))
