"""Serving metrics registry: counters, gauges, and percentile recorders.

The registry is the one sink every serving-layer statistic flows through —
the scheduler's sequencer counters, the cache pool's spill accounting, the
per-request latency recorders (TTFT, inter-token), queue depth and cache
occupancy — so `serve.py`, `chip_smoke.py` and the tests all read the same
numbers instead of each layer keeping an ad-hoc dict.  A copy of the
reference's `obs/metrics.py` (pure Python), with its semantics.

Design constraints, in order:

  * **Hot-path free.**  Recording is plain-Python arithmetic on host scalars
    the serving loop already holds (wall-clock floats, queue lengths, byte
    counts from abstract shapes).  Nothing here touches a device array, so
    instrumentation cannot introduce a host sync, and a captured decode
    step is the same graph with observability on and off.
  * **Live dict views.**  The scheduler's historical ``stats`` /
    ``spill_stats`` dict attributes survive as `CounterView`s over the
    registry: same keys, same ``stats["steps"] += 1`` spelling, but the
    values *are* the registry counters — one source of truth.
  * **numpy-faithful percentiles.**  `Histogram.percentile` matches
    ``numpy.percentile(..., method="linear")`` exactly (test-enforced), so
    p50/p95/p99 mean what a reader armed with numpy expects.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Iterable, Iterator, MutableMapping, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "CounterView", "MetricsRegistry",
           "percentile"]


def percentile(samples: Sequence[float], q: float) -> float:
    """q-th percentile (0..100) with linear interpolation — the same
    estimator as ``numpy.percentile(samples, q)`` on an unsorted 1-D input.
    """
    if not samples:
        raise ValueError("percentile of an empty sample set")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    xs = sorted(float(x) for x in samples)
    if len(xs) == 1:
        return xs[0]
    rank = (q / 100.0) * (len(xs) - 1)
    lo = math.floor(rank)
    hi = math.ceil(rank)
    if lo == hi:
        return xs[lo]
    frac = rank - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


@dataclasses.dataclass
class Counter:
    """Monotone-in-spirit integer counter (`CounterView` may also assign)."""

    name: str
    value: int = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


@dataclasses.dataclass
class Gauge:
    """Last-value metric with min/max watermarks (e.g. device-tier bytes)."""

    name: str
    value: float | None = None
    min: float | None = None
    max: float | None = None

    def set(self, v: float) -> None:
        self.value = v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)


class Histogram:
    """Exact-sample percentile recorder.

    Keeps every observation (serving runs here are seconds to minutes; the
    sample vectors are small) up to ``max_samples``, after which the vector
    is *decimated*: every other retained sample is dropped and the keep-rate
    halves, so long runs degrade to a uniform subsample instead of
    unbounded memory.  count/sum/min/max stay exact regardless.

    Every retained sample carries a timestamp (caller-supplied via
    ``record(v, t=...)``, else ``time.monotonic()``), so consumers that need
    *recent* tail behavior — the front end's SLO admission policy reads the
    p99 of the last N seconds of TTFT, not the lifetime p99 — can ask for
    ``percentile(q, window_s=..., now=...)`` over the windowed slice.
    """

    def __init__(self, name: str, max_samples: int = 65536):
        if max_samples < 2:
            raise ValueError(f"max_samples must be >= 2, got {max_samples}")
        self.name = name
        self.max_samples = max_samples
        self.count = 0
        self.total = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self._samples: list[float] = []
        self._times: list[float] = []   # kept in lockstep with _samples
        self._stride = 1          # record every _stride-th observation
        self._skip = 0

    def record(self, v: float, t: float | None = None) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if self._skip:
            self._skip -= 1
            return
        self._skip = self._stride - 1
        self._samples.append(v)
        self._times.append(time.monotonic() if t is None else float(t))
        if len(self._samples) >= self.max_samples:
            self._samples = self._samples[::2]
            self._times = self._times[::2]
            self._stride *= 2

    def reset(self) -> None:
        """Forget every observation (keeps name/max_samples; see
        `MetricsRegistry.reset`)."""
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._samples = []
        self._times = []
        self._stride = 1
        self._skip = 0

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def samples(self) -> list[float]:
        """The retained sample vector (exact until decimation kicks in)."""
        return list(self._samples)

    def window_samples(self, window_s: float, now: float) -> list[float]:
        """Retained samples recorded at ``t >= now - window_s``.

        ``now`` must come from the same timebase the samples were recorded
        against (the scheduler's injected clock, or ``time.monotonic()`` for
        untimed records) — mixing timebases silently empties or floods the
        window, which is why `percentile` refuses a window without an
        explicit ``now``.
        """
        if window_s <= 0.0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        cutoff = now - window_s
        return [v for t, v in zip(self._times, self._samples) if t >= cutoff]

    def percentile(self, q: float, *, window_s: float | None = None,
                   now: float | None = None) -> float:
        """Lifetime percentile, or — with ``window_s`` — the percentile over
        samples recorded in the trailing window ending at ``now``.  Same
        numpy-linear estimator either way; raises ``ValueError`` when the
        window holds no samples (callers decide the no-evidence policy)."""
        if window_s is None:
            return percentile(self._samples, q)
        if now is None:
            raise ValueError("windowed percentile needs an explicit `now` "
                             "from the recording timebase")
        return percentile(self.window_samples(window_s, now), q)

    def summary(self) -> dict:
        """One metric's block in a snapshot: count, mean, and the SLO
        percentiles.  Zero-observation histograms summarize to counts only,
        so an idle metric cannot crash a report."""
        out: dict = {"count": self.count}
        if not self._samples:
            return out
        out.update({
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50.0),
            "p95": self.percentile(95.0),
            "p99": self.percentile(99.0),
        })
        return out


class CounterView(MutableMapping):
    """A dict-shaped live view over a group of registry counters.

    ``view["steps"] += 1`` reads and writes the underlying `Counter`, so
    legacy callers of the scheduler's ``stats`` / the pool's ``spill_stats``
    keep working unchanged while the registry stays the single source of
    truth.  Unknown keys raise (a typo would otherwise silently mint a new
    counter and the historical dict would have KeyError'd too); new keys may
    only be introduced through `MetricsRegistry.counter_view`.
    """

    def __init__(self, registry: "MetricsRegistry", prefix: str,
                 keys: Iterable[str]):
        self._registry = registry
        self._prefix = prefix
        self._keys = list(keys)
        for k in self._keys:
            registry.counter(prefix + k)

    def _counter(self, key: str) -> Counter:
        if key not in self._keys:
            raise KeyError(key)
        return self._registry.counter(self._prefix + key)

    def __getitem__(self, key: str) -> int:
        return self._counter(key).value

    def __setitem__(self, key: str, value: int) -> None:
        self._counter(key).value = int(value)

    def __delitem__(self, key: str) -> None:
        raise TypeError("CounterView keys are fixed at construction")

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __repr__(self) -> str:
        return repr(dict(self))

    def __eq__(self, other) -> bool:
        if isinstance(other, (dict, CounterView)):
            return dict(self) == dict(other)
        return NotImplemented


class MetricsRegistry:
    """Get-or-create registry of named metrics.

    Names are dot-scoped by convention (``sched.steps``, ``pool.spills``,
    ``req.ttft_s``, ``engine.inter_token_s``); `snapshot` renders the whole
    registry to plain JSON-ready python (serve.py's ``--metrics`` artifact).
    """

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def _fresh(self, name: str) -> None:
        if (name in self._counters or name in self._gauges
                or name in self._histograms):
            raise ValueError(f"metric {name!r} already registered with a "
                             f"different type")

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            self._fresh(name)
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            self._fresh(name)
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            self._fresh(name)
            h = self._histograms[name] = Histogram(name)
        return h

    def counter_view(self, prefix: str, keys: Iterable[str]) -> CounterView:
        return CounterView(self, prefix, keys)

    def reset(self) -> None:
        """Zero every registered metric *in place* — counters to 0, gauges to
        unset, histograms emptied — while keeping the metric objects (and
        every live `CounterView` over them) attached.  The warm-vs-measured
        seam: a caller runs a warmup pass through a scheduler to pay its
        build and capture costs, resets, then measures a clean run on the
        same instance (`chip_smoke.py`'s goodput leg)."""
        for c in self._counters.values():
            c.value = 0
        for g in self._gauges.values():
            g.value = g.min = g.max = None
        for h in self._histograms.values():
            h.reset()

    def snapshot(self) -> dict:
        """JSON-ready dump: counters as ints, gauges as value/min/max,
        histograms as their summary blocks."""
        return {
            "counters": {n: c.value for n, c in sorted(self._counters.items())},
            "gauges": {n: {"value": g.value, "min": g.min, "max": g.max}
                       for n, g in sorted(self._gauges.items())},
            "histograms": {n: h.summary()
                           for n, h in sorted(self._histograms.items())},
        }
