"""The paper's monitor thread ("the eye", Fig. 5) — in two generations.

``FleetMonitorThread`` is the production path: one timer thread runs the
batched collector of a ``FleetMonitorService`` every period T (one
vectorized copy-and-zero of the shared counter arena into the staging
tile, one fused estimator dispatch per ``chunk_t`` ticks) and adapts the
*shared* sampling period with the paper's controller (§IV-A) from the
fleet's any-blocked signal.  The per-tick monitor work is a constant
number of numpy ops regardless of fleet size — the Algorithm-1 math
runs amortized and vectorized off the tick.

``QueueMonitor``/``MonitorThread`` are the original per-queue design
(one ``HostMonitor`` update per queue end per period, per-queue adaptive
T).  They remain as the paper-faithful reference and as the baseline the
pipeline benchmark measures the fleet path against.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, TYPE_CHECKING

from repro_torch.core.monitor import (HostMonitor, MonitorConfig,
                                SamplingPeriodController)
from repro_torch.streams.queue import InstrumentedQueue

if TYPE_CHECKING:   # pragma: no cover - import cycle guard
    from repro_torch.streams.fleet import FleetMonitorService

__all__ = ["QueueMonitor", "MonitorThread", "FleetMonitorThread"]


class QueueMonitor:
    """Per-queue instrumentation state: head (departure/service-rate of the
    consumer) + tail (arrival-rate of the producer) monitors and a shared
    sampling-period controller."""

    def __init__(self, queue: InstrumentedQueue,
                 cfg: Optional[MonitorConfig] = None,
                 base_period_s: float = 1e-3):
        self.queue = queue
        self.cfg = cfg or MonitorConfig()
        self.period = SamplingPeriodController(
            base_latency_s=base_period_s, max_period_s=base_period_s * 64)
        self.head = HostMonitor(self.cfg, period_s=self.period.period_s,
                                item_bytes=queue.item_bytes)
        self.tail = HostMonitor(self.cfg, period_s=self.period.period_s,
                                item_bytes=queue.item_bytes)
        self._last_t = time.monotonic()

    def sample(self) -> None:
        now = time.monotonic()
        realized = now - self._last_t
        self._last_t = now
        h_tc, h_blk, _ = self.queue.head.sample_and_reset()
        t_tc, t_blk, _ = self.queue.tail.sample_and_reset()
        # scale counts to the nominal period so T drift does not alias rate
        scale = (self.period.period_s / realized) if realized > 0 else 1.0
        self.head.update(h_tc * scale, h_blk)
        self.tail.update(t_tc * scale, t_blk)
        new_T = self.period.observe(realized, h_blk or t_blk)
        self.head.period_s = new_T
        self.tail.period_s = new_T

    # readouts -----------------------------------------------------------
    def service_rate(self) -> float:
        """Consumer's non-blocking service rate, items/s."""
        return self.head.rate_items_per_s()

    def arrival_rate(self) -> float:
        return self.tail.rate_items_per_s()


class MonitorThread(threading.Thread):
    """One instrumentation thread for a whole pipeline (the paper's
    thread-per-queue design, folded into one timer thread)."""

    def __init__(self, monitors: list[QueueMonitor],
                 on_converged: Optional[Callable] = None,
                 min_sleep_s: float = 2e-4):
        super().__init__(daemon=True, name="repro-monitor")
        self.monitors = monitors
        self.on_converged = on_converged
        self.min_sleep_s = min_sleep_s
        self._stop_evt = threading.Event()

    def run(self) -> None:
        while not self._stop_evt.is_set():
            next_wake = time.monotonic() + 1.0
            for qm in self.monitors:
                due = qm._last_t + qm.period.period_s
                now = time.monotonic()
                if now >= due:
                    # both monitors advance on the same sample: a
                    # tail-only convergence (arrival-rate epoch) must
                    # fire the callback too, not just the head's
                    before_h, before_t = qm.head.epoch, qm.tail.epoch
                    qm.sample()
                    if self.on_converged and (qm.head.epoch > before_h
                                              or qm.tail.epoch > before_t):
                        self.on_converged(qm)
                    due = qm._last_t + qm.period.period_s
                next_wake = min(next_wake, due)
            delay = max(next_wake - time.monotonic(), self.min_sleep_s)
            self._stop_evt.wait(delay)

    def stop(self) -> None:
        """Stop and join (idempotent): a caller that proceeds to read
        the monitors must not race a final in-flight ``sample()``."""
        self._stop_evt.set()
        if self.is_alive() and threading.current_thread() is not self:
            self.join(timeout=10)


class FleetMonitorThread(threading.Thread):
    """One timer thread for the whole fleet: batched collection, one
    amortized estimator dispatch, shared adaptive sampling period.

    Every tick costs one ``FleetMonitorService.sample()`` (a vectorized
    arena copy-and-zero into the staging tile); the fused Algorithm-1
    dispatch fires once per ``chunk_t`` ticks inside ``sample``.  The paper's
    sampling-period controller observes the realized period and the
    fleet-wide any-blocked signal, so T widens/narrows for the fleet as
    a unit — the natural posture when all queues ride one dispatch.
    """

    def __init__(self, service: "FleetMonitorService",
                 period: Optional[SamplingPeriodController] = None,
                 adapt_period: bool = True, min_sleep_s: float = 2e-4,
                 fault_plan=None):
        super().__init__(daemon=True, name="repro-fleet-monitor")
        self.service = service
        self.period = period or SamplingPeriodController(
            base_latency_s=service.period_s,
            max_period_s=service.period_s * 64)
        self.adapt_period = adapt_period
        self.min_sleep_s = min_sleep_s
        # optional ft.inject.FaultPlan (duck-typed): monitor-thread
        # death + sampling clock skew.  One None-check per tick when
        # absent — the collector hot path is untouched.
        self.fault_plan = fault_plan
        self._stop_evt = threading.Event()

    def run(self) -> None:
        self.service.warmup()   # kernel build + first launch off the tick
        last = time.monotonic()
        next_due = last
        while not self._stop_evt.is_set():
            plan = self.fault_plan
            if plan is not None and plan.monitor_death_due():
                return   # injected silent daemon death (watchdog food)
            now = time.monotonic()
            if now < next_due:
                self._stop_evt.wait(max(next_due - now, self.min_sleep_s))
                continue
            blocked = self.service.sample()
            realized, last = now - last, now
            if plan is not None:
                # sampling clock skew: the period controller observes a
                # distorted realized period, exactly as a drifting or
                # preempted sampling clock would report
                realized *= plan.skew_factor(now)
            if self.adapt_period:
                self.service.period_s = self.period.observe(realized,
                                                            blocked)
            next_due = now + self.service.period_s

    def stop(self, flush: bool = True) -> None:
        """Stop the tick thread, join it, then flush (idempotent).

        The join must come first: ``flush()`` racing a final in-flight
        ``sample()`` could land between its partial-chunk dispatch and
        the sample's own chunk-boundary dispatch, double-folding the
        staged tile.  Mirrors ``ControlLoop.stop()``."""
        self._stop_evt.set()
        if self.is_alive() and threading.current_thread() is not self:
            self.join(timeout=10)
        if flush:
            self.service.flush()
