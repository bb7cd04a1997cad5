"""Fault tolerance: heartbeats, monitor-driven straggler detection, and an
elastic re-mesh planner.

At pod scale, each host's step stream is itself a 'queue' the paper's
monitor can instrument: a host whose converged service rate (steps/s)
drops is a straggler (a service-rate *phase change*, paper Fig. 14); a
host whose heartbeat lapses is dead.  The elastic planner recomputes the
largest valid production mesh from the surviving device set and emits a
resharding plan to restart from the last checkpoint.

``FleetRateTracker`` keeps its fleet state on a ``device`` (the card by
default, where ``impl="cuda"`` is the ``monitor_fleet`` kernel); its
readouts come back to the host as numpy arrays.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.core.controller import StragglerDetector
from repro_torch.core.device import resolve_device
from repro_torch.core.monitor import (HostMonitor, MonitorConfig,
                                      fleet_monitor_init, fleet_rate_readout,
                                      run_monitor_fleet)

__all__ = ["HeartbeatRegistry", "HostRateTracker", "FleetRateTracker",
           "ElasticPlan", "plan_elastic_mesh", "FaultToleranceManager"]


class HeartbeatRegistry:
    def __init__(self, timeout_s: float = 30.0):
        self.timeout_s = timeout_s
        self._last: dict[str, float] = {}

    def beat(self, host: str, t: Optional[float] = None):
        self._last[host] = time.monotonic() if t is None else t

    def forget(self, host: str) -> None:
        """Drop a host from the registry.  A retired replica or a
        detached tenant must not linger in ``dead_hosts()`` forever —
        callers forget on retire/detach (``ReplicaSupervisor`` does
        this for pipeline workers; ``ControlGroup.detach`` for
        supervised tenants)."""
        self._last.pop(host, None)

    def dead_hosts(self, now: Optional[float] = None) -> list[str]:
        now = time.monotonic() if now is None else now
        return [h for h, t in self._last.items()
                if now - t > self.timeout_s]

    def alive(self, now: Optional[float] = None) -> list[str]:
        now = time.monotonic() if now is None else now
        return [h for h, t in self._last.items()
                if now - t <= self.timeout_s]


class HostRateTracker:
    """Per-host Algorithm-1 monitor over the step-completion stream."""

    def __init__(self, cfg: Optional[MonitorConfig] = None):
        self.cfg = cfg or MonitorConfig(window=16, min_q_samples=16)
        self.monitors: dict[str, HostMonitor] = {}
        self.detector = StragglerDetector()

    def record_steps(self, host: str, steps_in_period: float,
                     period_s: float, blocked: bool = False):
        hm = self.monitors.get(host)
        if hm is None:
            hm = HostMonitor(self.cfg, period_s=period_s)
            self.monitors[host] = hm
        hm.period_s = period_s
        if hm.update(steps_in_period, blocked):
            self.detector.report(host, hm.rate_items_per_s())

    def stragglers(self) -> list[str]:
        return self.detector.stragglers()


class FleetRateTracker:
    """Fleet-scale host-rate tracking: every host's step-completion
    stream rides one fused Algorithm-1 dispatch instead of a python
    ``HostMonitor`` per host, and converged rate arrays fold into the
    straggler detector with one batched report.

    Feed (Q, T) tiles of per-period step counts (``blocked`` marks
    periods where a host was stalled on I/O or a collective, which
    Algorithm 1 discards); readouts carry the Welford-count readiness
    gate, so an unconverged host reports 0 and is simply unobserved.
    The fleet state lives on ``device``; each tile is uploaded there.
    """

    def __init__(self, hosts, cfg: Optional[MonitorConfig] = None, *,
                 period_s: float = 1.0, chunk_t: int = 16,
                 impl: str = "rounds", block_q: int = 64,
                 device="cuda"):
        self.device = resolve_device(device)
        self.hosts = list(hosts)
        self.cfg = cfg or MonitorConfig(window=16, min_q_samples=16)
        self.period_s = float(period_s)
        self.chunk_t = int(chunk_t)
        self.impl = impl
        self.block_q = block_q
        self.detector = StragglerDetector()
        self._state = fleet_monitor_init(self.cfg, len(self.hosts),
                                         device=self.device)

    def record_tile(self, steps_per_period, blocked=None) -> np.ndarray:
        """(Q, T) step counts -> one donated fleet dispatch; returns the
        gated (Q,) rates after folding them into the detector."""
        self._state, _ = run_monitor_fleet(
            self.cfg, np.asarray(steps_per_period, float), blocked,
            state=self._state, chunk_t=self.chunk_t, impl=self.impl,
            mode="state", block_q=self.block_q, donate=True,
            device=self.device)
        rates = fleet_rate_readout(self.cfg, self._state, self.period_s)
        self.detector.report_fleet(self.hosts, rates)
        return rates

    def rates(self) -> np.ndarray:
        return fleet_rate_readout(self.cfg, self._state, self.period_s)

    def stragglers(self) -> list[str]:
        return self.detector.stragglers()


@dataclasses.dataclass
class ElasticPlan:
    old_shape: tuple
    new_shape: tuple
    new_axes: tuple
    dropped_hosts: list
    n_chips: int
    restart_step: Optional[int]
    note: str = ""


def plan_elastic_mesh(total_chips: int, failed_chips: int,
                      chips_per_host: int = 4,
                      restart_step: Optional[int] = None) -> ElasticPlan:
    """Largest (data, model) mesh from the surviving chips.

    Keeps model=16 (TP within a rack) and shrinks the data axis — the
    standard elastic-DP posture: every param shard stays reachable, only
    global batch shrinks; the train loop rescales grad accumulation.
    """
    survivors = total_chips - failed_chips
    model = 16 if survivors >= 16 else max(
        2 ** int(np.log2(max(survivors, 1))), 1)
    data = survivors // model
    if data < 1:
        raise RuntimeError("not enough chips for any mesh")
    return ElasticPlan(
        old_shape=(total_chips // 16, 16),
        new_shape=(data, model),
        new_axes=("data", "model"),
        dropped_hosts=[f"host{i}"
                       for i in range((failed_chips + chips_per_host - 1)
                                      // chips_per_host)],
        n_chips=data * model,
        restart_step=restart_step,
        note=f"elastic shrink {total_chips}->{data * model} chips; grad "
             f"accum x{max(1, round(total_chips / (data * model)))} keeps "
             "global batch")


class FaultToleranceManager:
    """Ties it together: heartbeats + straggler monitor + ckpt restart."""

    def __init__(self, n_hosts: int, chips_per_host: int = 4,
                 heartbeat_timeout_s: float = 30.0):
        self.n_hosts = n_hosts
        self.chips_per_host = chips_per_host
        self.heartbeats = HeartbeatRegistry(heartbeat_timeout_s)
        self.rates = HostRateTracker()

    def assess(self, latest_ckpt_step: Optional[int] = None
               ) -> Optional[ElasticPlan]:
        dead = set(self.heartbeats.dead_hosts())
        slow = set(self.rates.stragglers())
        to_drop = dead | slow
        if not to_drop:
            return None
        failed_chips = len(to_drop) * self.chips_per_host
        plan = plan_elastic_mesh(self.n_hosts * self.chips_per_host,
                                 failed_chips, self.chips_per_host,
                                 restart_step=latest_ckpt_step)
        plan.dropped_hosts = sorted(to_drop)
        return plan
