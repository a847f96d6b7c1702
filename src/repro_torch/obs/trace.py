"""Structured request-lifecycle tracer emitting Chrome-trace-event JSON.

Records the serving stack's lifecycle spans — submit → admit → prefill
chunks → first token → decode steps → preempt/resume → finish — as
Trace Event Format events (``B``/``E`` duration pairs, ``i`` instants,
``C`` counter series) that Perfetto / ``chrome://tracing`` load directly:
each request gets its own named track, the scheduler's sequencer cycle its
own, so a preemption reads as a gap on the request's track bracketed by
``preempt``/``resume`` markers while the high-priority request's admit span
runs on a sibling track.

Hot-path discipline:

  * Recording appends a dict to a python list — no device access, no
    serialization, no I/O.  `NullTracer` is the default everywhere and
    no-ops every method, so an untraced run pays one attribute lookup per
    potential span; the captured decode steps are the same graphs either
    way.
  * Span/instant ``args`` may carry **tensors**: they are stored as-is at
    record time and copied to the host together at `flush` (export calls
    it) — deferred args never force a sync inside the sequencer cycle.
    `Tracer.flush` is the tracer's one host-sync point.

A port of the reference's `obs/trace.py`: the events, tracks and names are
the same.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Iterator

import torch

__all__ = ["Tracer", "NullTracer", "SCHED_TRACK", "ENGINE_TRACK",
           "request_track"]

SCHED_TRACK = "scheduler"
ENGINE_TRACK = "engine"


def request_track(uid: int) -> str:
    """The per-request track name (`tid`) a request's lifecycle lives on."""
    return f"req {uid}"


def _is_device_array(v: Any) -> bool:
    """A tensor (on any device), as opposed to a host scalar or list."""
    return isinstance(v, torch.Tensor)


class NullTracer:
    """The disabled tracer: every record is a no-op, `span` yields nothing.

    This is the default on every engine/scheduler — observability off means
    the serving loop executes the same statements it always did.
    """

    enabled = False

    def begin(self, name: str, track: str = SCHED_TRACK, **args) -> None:
        pass

    def end(self, name: str, track: str = SCHED_TRACK, **args) -> None:
        pass

    def instant(self, name: str, track: str = SCHED_TRACK, **args) -> None:
        pass

    def counter(self, name: str, value: float,
                track: str = SCHED_TRACK) -> None:
        pass

    @contextlib.contextmanager
    def span(self, name: str, track: str = SCHED_TRACK,
             **args) -> Iterator[None]:
        yield

    def flush(self) -> None:
        pass


class Tracer(NullTracer):
    """Chrome-trace-event recorder with per-track span nesting.

    ``ts`` is microseconds since the tracer's construction; every event
    lands on one process (``pid`` 0) with the *track* name as its thread,
    declared via ``thread_name`` metadata so Perfetto labels the lanes.
    ``B``/``E`` events must nest per track — `end` checks the name against
    the track's open-span stack and raises on a mismatch, so a mis-paired
    instrumentation site fails loudly in tests instead of producing a trace
    Perfetto silently mis-renders.
    """

    enabled = True

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._events: list[dict] = []
        self._open: dict[str, list[str]] = {}    # track -> span-name stack
        self._tids: dict[str, int] = {}
        self._pending_args: list[dict] = []      # device-array args to gather

    # -- recording ----------------------------------------------------------

    def _now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = self._tids[track] = len(self._tids)
            self._events.append({"ph": "M", "pid": 0, "tid": tid,
                                 "name": "thread_name",
                                 "args": {"name": track}})
        return tid

    def _args(self, args: dict) -> dict | None:
        if not args:
            return None
        if any(_is_device_array(v) for v in args.values()):
            self._pending_args.append(args)
        return args

    def _event(self, ph: str, name: str, track: str, **fields) -> dict:
        ev = {"ph": ph, "name": name, "pid": 0, "tid": self._tid(track),
              "ts": self._now_us(), **fields}
        self._events.append(ev)
        return ev

    def begin(self, name: str, track: str = SCHED_TRACK, **args) -> None:
        """Open a span on ``track``; close it with `end` (LIFO per track)."""
        ev = self._event("B", name, track)
        a = self._args(args)
        if a is not None:
            ev["args"] = a
        self._open.setdefault(track, []).append(name)

    def end(self, name: str, track: str = SCHED_TRACK, **args) -> None:
        stack = self._open.get(track, [])
        if not stack or stack[-1] != name:
            raise ValueError(
                f"span end({name!r}) on track {track!r} does not match the "
                f"innermost open span ({stack[-1] if stack else None!r})")
        stack.pop()
        ev = self._event("E", name, track)
        a = self._args(args)
        if a is not None:
            ev["args"] = a

    def instant(self, name: str, track: str = SCHED_TRACK, **args) -> None:
        ev = self._event("i", name, track, s="t")
        a = self._args(args)
        if a is not None:
            ev["args"] = a

    def counter(self, name: str, value: float,
                track: str = SCHED_TRACK) -> None:
        """A Perfetto counter-series sample (e.g. queue depth per cycle)."""
        self._event("C", name, track, args={"value": value})

    @contextlib.contextmanager
    def span(self, name: str, track: str = SCHED_TRACK,
             **args) -> Iterator[None]:
        self.begin(name, track, **args)
        try:
            yield
        finally:
            self.end(name, track)

    # -- introspection / export ---------------------------------------------

    @property
    def events(self) -> list[dict]:
        return list(self._events)

    def open_spans(self, track: str = SCHED_TRACK) -> list[str]:
        """Names of the track's currently-open spans, outermost first."""
        return list(self._open.get(track, []))

    def flush(self) -> None:
        """Resolve deferred tensor args, copied to the host.

        The ONLY point in the tracer that synchronizes with the device —
        called from `export` / end-of-run, never from the sequencer cycle.
        """
        if not self._pending_args:
            return
        pending, self._pending_args = self._pending_args, []
        for args in pending:
            for k, v in args.items():
                if _is_device_array(v):
                    args[k] = v.detach().cpu().tolist()

    def to_dict(self) -> dict:
        self.flush()
        return {"traceEvents": self._events,
                "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        """Write the Perfetto-loadable JSON (gathers deferred args first)."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
            f.write("\n")
