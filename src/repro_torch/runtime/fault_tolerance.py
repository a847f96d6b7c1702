"""Fault tolerance for long runs: heartbeats, straggler detection, elastic
re-meshing.  Pure Python, a copy of the reference's
`runtime/fault_tolerance.py`.

  1. `HeartbeatMonitor` tracks per-host liveness (hosts are simulated, so
     the failure path is testable on one machine).
  2. `StragglerDetector` flags hosts whose step times exceed ``threshold x``
     the fleet median over a sliding window; the launcher's mitigation is
     checkpoint + exclude + re-mesh (the path of a hard failure, taken early).
  3. `plan_elastic_mesh` maps the surviving chip count to the largest valid
     mesh that keeps the ``model`` axis (the TP degree cannot change: param
     shards would be orphaned) and shrinks the data-parallel axes; the
     launcher then restores the latest checkpoint.  On one card the plan is
     the one-device mesh, and the restore lands on the same device
     (`repro_torch.launch.train`).
  4. `FailureInjector` schedules simulated failures.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque


@dataclasses.dataclass
class HostState:
    last_seen: float
    alive: bool = True


class HeartbeatMonitor:
    def __init__(self, hosts: list[str], timeout_s: float = 60.0):
        now = time.monotonic()
        self.timeout = timeout_s
        self.hosts = {h: HostState(last_seen=now) for h in hosts}

    def beat(self, host: str, now: float | None = None) -> None:
        st = self.hosts[host]
        st.last_seen = now if now is not None else time.monotonic()
        st.alive = True

    def mark_failed(self, host: str) -> None:
        """Out-of-band failure report (e.g. launcher saw the process die)."""
        self.hosts[host].alive = False

    def check(self, now: float | None = None) -> list[str]:
        """Returns newly-dead hosts (timeout or marked)."""
        now = now if now is not None else time.monotonic()
        dead = []
        for h, st in self.hosts.items():
            if st.alive and now - st.last_seen > self.timeout:
                st.alive = False
            if not st.alive:
                dead.append(h)
        return dead

    def alive_hosts(self) -> list[str]:
        return [h for h, st in self.hosts.items() if st.alive]


class StragglerDetector:
    """Flags hosts persistently slower than the fleet median."""

    def __init__(self, threshold: float = 2.0, window: int = 16,
                 min_samples: int = 4):
        self.threshold = threshold
        self.window = window
        self.min_samples = min_samples
        self.times: dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window))

    def record(self, host: str, step_time_s: float) -> None:
        self.times[host].append(step_time_s)

    def stragglers(self) -> list[str]:
        meds = {h: sorted(ts)[len(ts) // 2]
                for h, ts in self.times.items() if len(ts) >= self.min_samples}
        if len(meds) < 2:
            return []
        fleet = sorted(meds.values())[len(meds) // 2]
        return [h for h, m in meds.items() if m > self.threshold * fleet]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]
    dropped_chips: int


def plan_elastic_mesh(alive_chips: int, model_parallel: int = 16,
                      pods: int = 1) -> MeshPlan:
    """Largest mesh with the TP degree preserved and DP shrunk to fit.

    TP ('model') cannot change across a restore — every param shard assumes
    that factor — so we keep it and give DP the biggest power-of-two (or
    exact) factor that fits the survivors.  Any remainder chips idle until
    the next full restart (reported as dropped).
    """
    if alive_chips < model_parallel:
        raise ValueError(f"fewer chips ({alive_chips}) than TP degree "
                         f"({model_parallel})")
    dp = alive_chips // (model_parallel * pods)
    # largest power of two <= dp keeps collectives ring-friendly
    p = 1
    while p * 2 <= dp:
        p *= 2
    used = p * model_parallel * pods
    if pods > 1:
        return MeshPlan(shape=(pods, p, model_parallel),
                        axes=("pod", "data", "model"),
                        dropped_chips=alive_chips - used)
    return MeshPlan(shape=(p, model_parallel), axes=("data", "model"),
                    dropped_chips=alive_chips - used)


class FailureInjector:
    """Deterministic failure schedule: {step: [hosts]}."""

    def __init__(self, schedule: dict[int, list[str]]):
        self.schedule = schedule

    def maybe_fail(self, step: int, monitor: HeartbeatMonitor) -> list[str]:
        failed = self.schedule.get(step, [])
        for h in failed:
            monitor.mark_failed(h)
        return failed
