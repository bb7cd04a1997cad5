"""Named scenarios: workload shape x policy ladder x fault storm, as data.

A :class:`Scenario` is everything a matrix cell needs except the two
axis choices the harness supplies (which :data:`POLICIES` rung, which
:data:`FAULTS` storm): tenant specs (arrival envelope + service model +
seed configuration per tenant) and horizon/measurement bookkeeping.
Scenarios are *pure data* — building one allocates nothing, and
``Scenario.build(T, seed)`` derives each tenant's rng stream from
``(seed, tenant index)`` so the whole matrix is reproducible from one
CLI ``--seed``.

The fault axis rides the same principle: a :class:`FaultStorm` is the
*spec* of a storm (how many crashes/stalls/skew windows, where in the
run), and ``storm.build(seed, T, targets)`` compiles it into a
concrete ``ft.inject.FaultPlan`` with event times in *periods* — the
scenario carries its fault storm as data, and the identical plan
object could be armed wall-clock against a real stack instead (that is
what the ``qos_soak`` bench does with its own storm).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

from repro_torch.control import (AdmissionPolicy, BufferPolicy, PolicySet,
                                 ReplicaPolicy)
from repro_torch.core.controller import BufferAutotuner, ParallelismController
from repro_torch.ft.inject import FaultPlan
from repro_torch.workloads.arrivals import (Diurnal, FlashCrowd, Ramp, Square,
                                            Step)
from repro_torch.workloads.sim import ParetoService, ServiceModel, SimTandem

__all__ = ["TenantSpec", "Scenario", "FaultStorm",
           "SCENARIOS", "FAULTS", "POLICIES", "make_policies"]


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's workload: arrival envelope (Process or rate),
    service model (ServiceModel, Process or rate — non-models are
    wrapped in the poisson sampler), and the seed configuration the
    static column never re-tunes."""
    name: str
    arrivals: object
    service: object
    replicas: int = 2
    capacity: int = 256

    def build(self, seed) -> SimTandem:
        svc = (self.service.clone()
               if isinstance(self.service, ServiceModel) else self.service)
        return SimTandem(seed, self.arrivals, svc, self.replicas,
                         self.capacity)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named workload shape.  ``make(T)`` returns the tenant specs
    for a ``T``-period horizon (specs scale their change points with
    the horizon, so quick and full mode exercise the same shape)."""
    name: str
    make: Callable[[int], Sequence[TenantSpec]]
    periods: int
    quick_periods: int
    decide_every: int = 16
    settle_frac: float = 0.25      # sustained window starts here

    def horizon(self, quick: bool) -> int:
        return self.quick_periods if quick else self.periods

    def tenants(self, T: int) -> tuple[TenantSpec, ...]:
        return tuple(self.make(T))

    def build(self, T: int, seed: int) -> list[tuple[TenantSpec, SimTandem]]:
        """Tenant sims with per-tenant rng streams derived from
        ``(seed, index)`` — same seed, same fleet-wide sample path."""
        return [(spec, spec.build([seed, i]))
                for i, spec in enumerate(self.tenants(T))]


# -- policy axis ----------------------------------------------------------

POLICIES = ("static", "replica", "full")


def make_policies(name: str, max_replicas: int = 16,
                  decide_every: int = 16) -> Optional[PolicySet]:
    """The policy ladder: ``static`` (no loop at all), ``replica``
    (scale-out only), ``full`` (replica + buffer + admission).  Probe
    knobs mirror the multi-tenant bench: the probe cycle must fit
    inside a load phase or an escalated tenant never re-converges."""
    if name == "static":
        return None
    rep = ReplicaPolicy(ParallelismController(max_replicas=max_replicas))
    knobs = dict(confirm_ticks=2, cooldown_ticks=4, block_q=8,
                 probe_period_ticks=6, probe_window_ticks=2)
    if name == "replica":
        return PolicySet(replica=rep, **knobs)
    if name == "full":
        return PolicySet(replica=rep,
                         buffer=BufferPolicy(BufferAutotuner(current=64)),
                         admission=AdmissionPolicy(), **knobs)
    raise KeyError(f"unknown policy rung {name!r} "
                   f"(one of {POLICIES})")


# -- fault axis -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultStorm:
    """The spec of a fault storm, horizon-relative: counts per kind
    plus window/duration *fractions* of the run, compiled to a concrete
    ``FaultPlan`` (event times in periods) by ``build``."""
    name: str
    n_crashes: int = 0
    n_stalls: int = 0
    stall_frac: float = 0.04       # each stall lasts this fraction of T
    n_skews: int = 0
    skew_frac: float = 0.06        # each skew window, fraction of T
    skew_factor: float = 2.0
    monitor_outage_frac: float = 0.0   # >0: monitor death + outage
    n_act_fails: int = 0           # injected actuation failures
    window: tuple[float, float] = (0.35, 0.6)   # storm window, frac of T

    def build(self, seed: int, T: int,
              targets: Sequence[str]) -> Optional[FaultPlan]:
        if not (self.n_crashes or self.n_stalls or self.n_skews
                or self.n_act_fails or self.monitor_outage_frac > 0):
            return None
        win = (self.window[0] * T, self.window[1] * T)
        death_at = win[0] if self.monitor_outage_frac > 0 else None
        return FaultPlan.chaos(
            seed, targets=list(targets),
            n_crashes=self.n_crashes, window_s=win,
            n_stalls=self.n_stalls, stall_s=self.stall_frac * T,
            n_skews=self.n_skews, skew_s=self.skew_frac * T,
            skew_factor=self.skew_factor,
            monitor_death_at=death_at,
            monitor_outage_s=self.monitor_outage_frac * T,
            n_act_fails=self.n_act_fails)


FAULTS: dict[str, FaultStorm] = {
    "none": FaultStorm("none"),
    "crash_storm": FaultStorm("crash_storm", n_crashes=3),
    "stall_storm": FaultStorm("stall_storm", n_stalls=4),
    "skew": FaultStorm("skew", n_skews=2, skew_factor=2.0),
    # actuation failures only: every verb the loop issues may raise —
    # proves the retry/rollback path under a storm of refused actuations
    "act_fail": FaultStorm("act_fail", n_act_fails=4),
    # the full soak storm: everything at once, monitor outage included
    "storm": FaultStorm("storm", n_crashes=2, n_stalls=2, n_skews=1,
                        monitor_outage_frac=0.03),
}


# -- scenario registry ----------------------------------------------------

SCENARIOS: dict[str, Scenario] = {}


def _register(scn: Scenario) -> Scenario:
    SCENARIOS[scn.name] = scn
    return scn


# the acceptance step: per-item kernel cost quadruples at T/3
_register(Scenario(
    "step",
    make=lambda T: (TenantSpec("app", 100.0, Step(60.0, 15.0, T // 3)),),
    periods=4000, quick_periods=1600, settle_frac=0.6))

# slow drift: service cost ramps 3.3x across the middle of the run
_register(Scenario(
    "drift",
    make=lambda T: (TenantSpec(
        "app", 100.0, Ramp(60.0, 18.0, T // 6, 5 * T // 6)),),
    periods=4800, quick_periods=2000, settle_frac=5 / 6))

# bursty offered load around a feasible mean, small seed buffer
_register(Scenario(
    "bursty",
    make=lambda T: (TenantSpec(
        "app", Square(160.0, 40.0, 200.0), 60.0, capacity=64),),
    periods=4800, quick_periods=1600, settle_frac=0.1))

# two tenants, anti-correlated square waves (the rebalance shape)
_register(Scenario(
    "antiphase",
    make=lambda T: (
        TenantSpec("pipe_a", Square(160.0, 40.0, 600.0), 30.0,
                   capacity=128),
        TenantSpec("pipe_b", Square(160.0, 40.0, 600.0, phase=300.0),
                   30.0, capacity=128)),
    periods=4800, quick_periods=2400, settle_frac=0.1))

# a compressed day with a flash crowd on the afternoon shoulder
_register(Scenario(
    "flash_crowd",
    make=lambda T: (TenantSpec(
        "app",
        Diurnal(base=90.0, amplitude=50.0, period=float(T))
        + FlashCrowd(peak=260.0, at=0.55 * T, rise=0.04 * T,
                     fall=0.12 * T),
        40.0, capacity=128),),
    periods=4000, quick_periods=1600, settle_frac=0.5))

# heavy-tailed item costs: one huge item stalls the stage for periods
_register(Scenario(
    "pareto_tail",
    make=lambda T: (TenantSpec(
        "app", 90.0, ParetoService(60.0, alpha=1.25), capacity=128),),
    periods=3000, quick_periods=1200, settle_frac=0.25))
