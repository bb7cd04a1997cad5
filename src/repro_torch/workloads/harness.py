"""The chaos-soak harness: run a scenario cell, run the whole matrix.

``run_cell(scenario, policy, fault)`` drives one cell of the
scenario x policy x fault matrix: the scenario's tenant sims behind a
real ``ControlGroup`` (one monitor service + one fused decision loop +
one shared arena — the exact stack the multi-tenant bench validates),
with the compiled ``FaultPlan`` interpreted in *simulated* time by
:class:`StormDriver`:

* ``crash``   -> ``sim.kill_replica()`` (the control loop's replica leg
  must notice the lost capacity and restore it);
* ``stall``   -> one replica stops serving for the event's duration
  (a straggler window);
* ``monitor_death`` -> the harness stops folding samples for the
  outage (estimates freeze exactly as they do when the real monitor
  thread dies);
* ``actuation``     -> the next matching actuator verb raises
  ``InjectedFault`` through the shared ``SimActuator.fail_verbs``
  gate (the loop's retry/rollback must absorb it — same contract as
  ``ft.inject.FaultyActuator`` on a real stack);
* ``clock_skew``    -> measured counters are distorted by ``1/factor``
  while the physical system is untouched (the monitor sees a drifted
  clock).

The *static* column runs the same sims and the same storm with no
control loop — so every "survives the storm" claim is relative to a
baseline that also had to survive it.

``run_matrix`` sweeps the axes and emits one summary row per cell
(sustained throughput, availability, delay p99, action count, recovery
window, vs-static ratio) — the table the JAX package's
``BENCH_control.json`` records.

The port's entry points (``run_cell``, ``run_matrix``) take a trailing
keyword-only ``device``: the group's monitor service (the
``monitor_fleet`` kernel on every dispatch) and its decision live there
— the card by default; ``device="cpu"`` runs the kernel's plain PyTorch
version on the host.  The simulated tandems stay numpy on the host.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.control import ControlGroup
from repro_torch.core.device import resolve_device
from repro_torch.core.monitor import MonitorConfig
from repro_torch.streams import CounterArena, InstrumentedQueue
from repro_torch.workloads.scenario import (FAULTS, POLICIES, SCENARIOS,
                                            FaultStorm, Scenario,
                                            make_policies)
from repro_torch.workloads.sim import SimActuator, SimTandem
from repro_torch.workloads.trace import Trace, TraceRecorder

__all__ = ["StormDriver", "CellResult", "run_cell", "run_matrix",
           "PERIOD_S", "DEFAULT_MCFG"]

PERIOD_S = 1e-3
DEFAULT_MCFG = dict(window=16, min_q_samples=16)


def _quick_default() -> bool:
    return os.environ.get("REPRO_BENCH_QUICK", "") not in ("", "0")


class StormDriver:
    """Interprets a compiled ``FaultPlan`` in simulated time: call
    ``apply(t, sims)`` once per period *before* stepping the sims; it
    fires due one-shots, expires stall windows, applies clock-skew
    measurement distortion, and returns whether the monitor is alive
    this period.  Keeps its own audit (the plan object stays pure data
    — the wall-clock consumption API is untouched for real stacks)."""

    def __init__(self, plan, fail_verbs: Optional[dict] = None):
        evs = sorted(plan.events(), key=lambda e: e.at_s) if plan else []
        self._oneshots = [e for e in evs if e.kind != "clock_skew"]
        self._skews = [e for e in evs if e.kind == "clock_skew"]
        self._i = 0
        self._stalls: list[tuple[float, SimTandem]] = []
        self._outage_until = -1.0
        self.fired: list[tuple[float, object]] = []
        # shared {verb: pending-failure count} — the same dict every
        # tenant's SimActuator gates on, so one "actuation" event fails
        # exactly the next matching verb the loop issues
        self.fail_verbs = fail_verbs if fail_verbs is not None else {}

    def _sim_for(self, target: str, sims: dict) -> SimTandem:
        return sims.get(target, next(iter(sims.values())))

    def apply(self, t: float, sims: dict) -> bool:
        for end, sim in list(self._stalls):
            if t >= end:
                sim.stalled = max(sim.stalled - 1, 0)
                self._stalls.remove((end, sim))
        while (self._i < len(self._oneshots)
               and self._oneshots[self._i].at_s <= t):
            e = self._oneshots[self._i]
            self._i += 1
            if e.kind == "crash":
                self._sim_for(e.target, sims).kill_replica()
            elif e.kind == "stall":
                sim = self._sim_for(e.target, sims)
                sim.stalled += 1
                self._stalls.append((t + e.duration_s, sim))
            elif e.kind == "monitor_death":
                self._outage_until = t + e.duration_s
            elif e.kind == "actuation":
                self.fail_verbs[e.target] = (
                    self.fail_verbs.get(e.target, 0) + 1)
            self.fired.append((t, e))
        f = 1.0
        for e in self._skews:
            if e.at_s <= t < e.at_s + e.duration_s:
                f *= e.factor
        m = 1.0 / f if f > 0 else 1.0
        for sim in sims.values():
            sim.meas_scale = m
        return not t < self._outage_until

    @property
    def fired_kinds(self) -> list[str]:
        return [e.kind for _, e in self.fired]


@dataclasses.dataclass
class CellResult:
    """One matrix cell's verdict (arrays kept for callers; ``row()``
    is the JSON-safe summary)."""
    scenario: str
    policy: str
    fault: str
    seed: int
    periods: int
    sustained: float               # items/period over the settle window
    availability: float            # served / offered, whole run
    delay_p99: float               # p99 of the per-period wait proxy
    actions: int                   # control log entries
    recovery: int                  # periods from last fault to 70% (-1: never)
    faults_fired: list
    replicas_final: list
    shed_fraction: float
    served: np.ndarray = dataclasses.field(repr=False, default=None)
    wait: np.ndarray = dataclasses.field(repr=False, default=None)
    trace: Optional[Trace] = dataclasses.field(repr=False, default=None)
    vs_static: Optional[float] = None

    def row(self) -> dict:
        return {
            "scenario": self.scenario, "policy": self.policy,
            "fault": self.fault, "seed": self.seed,
            "periods": self.periods,
            "sustained_items_per_period": round(self.sustained, 3),
            "availability": round(self.availability, 4),
            "delay_p99_periods": round(self.delay_p99, 3),
            "actions": self.actions, "recovery_periods": self.recovery,
            "faults_fired": self.faults_fired,
            "replicas_final": self.replicas_final,
            "shed_fraction": round(self.shed_fraction, 4),
            "vs_static": (round(self.vs_static, 3)
                          if self.vs_static is not None else None),
        }


def _resolve_scenario(scn: Union[str, Scenario]) -> Scenario:
    return SCENARIOS[scn] if isinstance(scn, str) else scn


def _resolve_storm(fault: Union[str, FaultStorm]) -> FaultStorm:
    return FAULTS[fault] if isinstance(fault, str) else fault


def run_cell(scenario: Union[str, Scenario], policy: str = "full",
             fault: Union[str, FaultStorm] = "none", *, seed: int = 0,
             quick: Optional[bool] = None, periods: Optional[int] = None,
             impl: str = "numpy", record: bool = False,
             policies=None, max_replicas: int = 16,
             device="cuda") -> CellResult:
    """One cell: scenario tenants x one policy rung x one fault storm.

    ``policies`` overrides the rung's ``PolicySet`` (pass the rung name
    in ``policy`` regardless — it labels the cell); ``record=True``
    attaches a :class:`~repro_torch.workloads.trace.Trace` for replay.
    The control group runs on ``device`` (the card by default)."""
    dev = resolve_device(device)
    scn = _resolve_scenario(scenario)
    storm = _resolve_storm(fault)
    quick = _quick_default() if quick is None else quick
    T = int(periods) if periods else scn.horizon(quick)
    built = scn.build(T, seed)
    sims = {spec.name: sim for spec, sim in built}
    ordered = [sim for _, sim in built]
    plan = storm.build(seed + 7919, T, [spec.name for spec, _ in built])
    fail_verbs: dict = {}
    driver = StormDriver(plan, fail_verbs)
    pol = policies if policies is not None else make_policies(
        policy, max_replicas=max_replicas, decide_every=scn.decide_every)

    group = None
    queues: list = []
    rec = TraceRecorder(len(ordered)) if record else None
    if pol is not None:
        arena = CounterArena(max(8, 4 * len(ordered)))
        group = ControlGroup(pol, arena=arena,
                             monitor_cfg=MonitorConfig(**DEFAULT_MCFG),
                             period_s=PERIOD_S, chunk_t=scn.decide_every,
                             scale_to_period=False, block_q=8, impl=impl,
                             device=dev)
        queues = [InstrumentedQueue(8, arena=arena) for _ in ordered]
        for (spec, sim), q in zip(built, queues):
            group.attach(([q], SimActuator(sim, fail_verbs=fail_verbs)),
                         name=spec.name)

    served = np.zeros(T)
    wait = np.zeros(T)
    de = scn.decide_every
    for t in range(T):
        sample_ok = driver.apply(float(t), sims)
        rows = []
        for sim, in_q in zip(ordered, queues or [None] * len(ordered)):
            before = sim.served_total
            tt, tb, ht, hb = sim.step(float(t))
            served[t] += sim.served_total - before
            rows.append((tt, tb, ht, hb))
            if in_q is not None:
                in_q.tail.tc, in_q.tail.blocked = tt, tb
                in_q.head.tc, in_q.head.blocked = ht, hb
        wait[t] = max(sim.wait for sim in ordered)
        if rec is not None:
            rec.period(rows, sample_ok and group is not None)
        if group is not None:
            if sample_ok:
                group.service.sample()
            if t % de == de - 1:
                if rec is not None:
                    reps = [s.replicas for s in ordered]
                    caps = [s.capacity for s in ordered]
                    occ = [s.occ_high for s in ordered]
                dec = group.tick()
                if rec is not None:
                    rec.tick(t, reps, caps, occ, dec)
    if group is not None:
        group.service.flush()
        group.service.stop()

    settle = int(scn.settle_frac * T)
    offered = sum(s.offered_total for s in ordered)
    total_served = sum(s.served_total for s in ordered)
    shed = sum(s.shed_total for s in ordered)
    recovery = _recovery(served, driver, T)
    trace = None
    if rec is not None:
        trace = rec.finish({
            "scenario": scn.name, "policy": policy, "fault": storm.name,
            "seed": seed, "periods": T, "decide_every": de,
            "period_s": PERIOD_S, "impl": impl, **DEFAULT_MCFG})
    return CellResult(
        scenario=scn.name, policy=policy, fault=storm.name, seed=seed,
        periods=T,
        sustained=float(served[settle:].mean()) if settle < T else 0.0,
        availability=total_served / max(offered, 1),
        delay_p99=float(np.percentile(wait[settle:], 99))
        if settle < T else 0.0,
        actions=int(group.log.total) if group is not None else 0,
        recovery=recovery,
        faults_fired=driver.fired_kinds,
        replicas_final=[int(s.replicas) for s in ordered],
        shed_fraction=shed / max(offered, 1),
        served=served, wait=wait, trace=trace)


def _recovery(served: np.ndarray, driver: StormDriver, T: int,
              frac: float = 0.7, win: int = 50) -> int:
    """Periods from the end of the last one-shot fault until the
    ``win``-period rolling throughput re-reaches ``frac`` of the
    pre-storm median (0 = no faults fired, -1 = never recovered)."""
    shots = [(t, e) for t, e in driver.fired]
    if not shots:
        return 0
    first = int(min(t for t, _ in shots))
    last = int(max(t + e.duration_s for t, e in shots))
    pre = served[max(T // 10, 1):max(first, T // 10 + 2)]
    base = float(np.median(pre)) if pre.size else 1.0
    post = served[min(last, T):]
    if post.size < win:
        return -1
    roll = np.convolve(post, np.ones(win) / win, mode="valid")
    above = np.nonzero(roll >= frac * base)[0]
    return int(above[0]) if above.size else -1


def run_matrix(scenarios: Sequence[Union[str, Scenario]] = (
        "step", "bursty", "flash_crowd", "pareto_tail"),
        policies: Sequence[str] = POLICIES,
        faults: Sequence[Union[str, FaultStorm]] = ("none", "storm"),
        *, seed: int = 0, quick: Optional[bool] = None,
        impl: str = "numpy", max_replicas: int = 16,
        device="cuda") -> dict:
    """Sweep the full matrix; every cell's ``vs_static`` normalizes
    against the static cell of the *same* scenario and fault (the
    baseline suffered the identical storm).  Every cell runs on
    ``device``."""
    dev = resolve_device(device)
    cells: list[CellResult] = []
    for scn in scenarios:
        for fault in faults:
            static: Optional[CellResult] = None
            for pol in policies:
                c = run_cell(scn, pol, fault, seed=seed, quick=quick,
                             impl=impl, max_replicas=max_replicas,
                             device=dev)
                if pol == "static":
                    static = c
                if static is not None:
                    c.vs_static = c.sustained / max(static.sustained,
                                                    1e-9)
                cells.append(c)
    return {"n_cells": len(cells), "seed": seed,
            "axes": {"scenarios": [_resolve_scenario(s).name
                                   for s in scenarios],
                     "policies": list(policies),
                     "faults": [_resolve_storm(f).name for f in faults]},
            "cells": [c.row() for c in cells]}
