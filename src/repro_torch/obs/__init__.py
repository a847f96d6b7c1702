"""`repro_torch.obs` — the serving observability layer.

Three pieces, one bundle, as the reference's `repro.obs`:

  * `metrics` — a `MetricsRegistry` of counters / gauges / percentile
    histograms (p50/p95/p99 faithful to numpy): per-request TTFT and
    inter-token latency, queue depth, cache occupancy per tier, spill/fetch
    bytes, chunked-prefill pacing.  The scheduler's ``stats`` /
    ``spill_stats`` dicts are live `CounterView`s over this registry.
  * `trace` — a structured span `Tracer` recording each request's lifecycle
    (submit → admit → prefill chunks → first token → decode steps →
    preempt/resume → finish) as Chrome-trace-event JSON loadable in
    Perfetto; `NullTracer` (the default) no-ops everything.
  * `profiler` — ``torch.profiler`` / NVTX ranges around the engine's and
    the scheduler's dispatch sites, off unless ``profile`` is set.

`Observability` carries all three through the serving stack
(`InferenceEngine(obs=...)`, `RequestScheduler(obs=...)`); every piece is
host-side only.
"""

from __future__ import annotations

import dataclasses

from repro_torch.obs import profiler
from repro_torch.obs.metrics import (Counter, CounterView, Gauge, Histogram,
                                     MetricsRegistry, percentile)
from repro_torch.obs.trace import (ENGINE_TRACK, SCHED_TRACK, NullTracer, Tracer,
                                   request_track)

__all__ = ["Counter", "CounterView", "Gauge", "Histogram", "MetricsRegistry",
           "NullTracer", "Observability", "Tracer", "percentile", "profiler",
           "SCHED_TRACK", "ENGINE_TRACK", "request_track"]


@dataclasses.dataclass
class Observability:
    """The bundle a serving component records through.

    ``metrics`` is always a real registry (recording a counter is cheaper
    than branching around it); ``tracer`` defaults to the no-op
    `NullTracer`; ``profile`` gates the profiler ranges around dispatch
    sites.  One bundle may be shared across the engine, the scheduler, and
    the pool — their metric names are dot-prefixed (``engine.``,
    ``sched.``, ``pool.``, ``frontend.``) so a shared registry stays
    collision-free.
    """

    metrics: MetricsRegistry = dataclasses.field(default_factory=MetricsRegistry)
    tracer: NullTracer = dataclasses.field(default_factory=NullTracer)
    profile: bool = False

    def annotation(self, name: str):
        """Profiler range for one dispatch site (no-op unless ``profile``
        is set)."""
        return profiler.annotation(name, self.profile)
