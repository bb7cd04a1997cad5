"""Seedable simulated tandem stages behind the real actuator protocol.

``SimTandem`` is the per-period discrete-time tandem the control
benchmarks have always validated against (producer -> finite queue ->
replicated consumer, counts per period — the same abstraction as
``core.simulate``'s event-driven tandem folded to the granularity the
monitor samples at), promoted out of ``benchmarks/control_bench.py``
into a first-class, composable form:

* offered load is a :class:`~repro_torch.workloads.arrivals.Process`
  envelope sampled poisson per period under the tandem's own seeded
  rng — same seed, same sample path, bit-for-bit;
* service is a :class:`ServiceModel`: :class:`PoissonService` (the
  classic M-ish server) or :class:`ParetoService` (heavy-tailed item
  costs with in-progress-item carry, so one huge item genuinely stalls
  the stage for multiple periods — the tail regime QoS enforcement
  lives or dies on);
* fault storms act through explicit knobs the scenario harness drives
  from a ``ft.inject.FaultPlan``: ``kill_replica()`` (crash),
  ``stall_scale`` (a stall window collapses the realized service
  rate), and ``meas_scale`` (clock skew: the *measured* counters are
  distorted while the physical system is not).

``SimActuator`` is the ``ControlLoop`` adapter over a tandem — the
same verb protocol ``streams.Pipeline``'s adapter implements, same
rejection contract (a shrink below the backlog is refused, items are
never dropped) — so simulated scenarios exercise the identical
sense/decide/actuate path the real stacks use.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.workloads.arrivals import Process, as_process

__all__ = ["ServiceModel", "PoissonService", "ParetoService",
           "SimTandem", "SimActuator"]


class ServiceModel:
    """Per-period service capacity sampler: how many items ``replicas``
    copies of the stage *could* drain this period.  ``mu`` is the
    per-replica rate envelope (items/period)."""

    def __init__(self, mu):
        self.mu: Process = as_process(mu)

    def clone(self) -> "ServiceModel":
        """A fresh instance sharing the (stateless) envelope — scenario
        builds must not share sampler state across runs."""
        return type(self)(self.mu)

    def draw(self, rng: np.random.Generator, t: float,
             replicas: int, scale: float = 1.0) -> int:
        raise NotImplementedError


class PoissonService(ServiceModel):
    """Memoryless server: ``poisson(replicas * mu(t) * scale)`` — the
    pre-foundry benchmarks' service model, exactly."""

    def draw(self, rng, t, replicas, scale=1.0) -> int:
        lam = max(0.0, replicas * self.mu.rate(t) * scale)
        return int(rng.poisson(lam))


class ParetoService(ServiceModel):
    """Heavy-tailed server: item costs are Pareto with tail index
    ``alpha`` and mean ``1/mu(t)`` periods, drawn against a shared
    per-period budget of ``replicas * scale`` period-units, with the
    in-progress item's remaining cost carried across periods.  For
    ``alpha`` near 1 the tail is so heavy that a single item can hold
    the stage for many periods — the straggler/occupancy regime the
    admission and escalation legs must handle.
    """

    def __init__(self, mu, alpha: float = 1.6):
        super().__init__(mu)
        if alpha <= 1.0:
            raise ValueError("ParetoService needs alpha > 1 "
                             "(finite mean item cost)")
        self.alpha = float(alpha)
        self._rem = 0.0               # in-progress item's remaining cost

    def clone(self) -> "ParetoService":
        return ParetoService(self.mu, self.alpha)

    def draw(self, rng, t, replicas, scale=1.0) -> int:
        mu = self.mu.rate(t) * scale
        if mu <= 0:
            return 0
        # lomax + 1 has mean alpha/(alpha-1); rescale to mean 1/mu
        mean_cost = 1.0 / mu
        unit = mean_cost * (self.alpha - 1.0) / self.alpha
        budget = float(max(replicas, 0))
        served = 0
        rem = self._rem
        while budget > 0.0:
            if rem <= 0.0:
                rem = (1.0 + rng.pareto(self.alpha)) * unit
            if rem <= budget:
                budget -= rem
                rem = 0.0
                served += 1
            else:
                rem -= budget
                budget = 0.0
        self._rem = rem
        return served


class SimTandem:
    """One simulated producer -> finite queue -> replicated consumer.

    ``step(t)`` advances one period and returns the same counter tuple
    the real instrumentation exposes: ``(tail_tc, tail_blocked,
    head_tc, head_blocked)`` — accepted/served counts plus blocked
    flags at the two ends.  ``lam`` / ``mu_r`` remain plain mutable
    floats when constructed from scalars (the legacy ``mutate``-closure
    form); envelope-driven tandems pass :class:`Process` /
    :class:`ServiceModel` objects instead.
    """

    def __init__(self, seed: int, arrivals, service, replicas: int,
                 capacity: int):
        self.rng = np.random.default_rng(seed)
        self._arrivals = as_process(arrivals)
        self.service: ServiceModel = (
            service if isinstance(service, ServiceModel)
            else PoissonService(service))
        self.replicas = int(replicas)
        self.capacity = int(capacity)
        self.backlog = 0
        self.shedding = False
        self.served_total = 0
        self.offered_total = 0
        self.shed_total = 0
        self.occ_high = 0.0
        # fault knobs (driven by the scenario harness)
        self.stall_scale = 1.0        # realized service multiplier
        self.stalled = 0              # replicas currently stalled
        self.meas_scale = 1.0         # measured-counter distortion (skew)
        self.killed = 0               # replicas lost to injected crashes
        # per-period Little's-law wait proxy (periods of queueing delay)
        self.wait = 0.0

    # -- legacy scalar access (mutate-closure scenarios) ------------------
    @property
    def lam(self) -> float:
        return self._arrivals.rate(0.0)

    @lam.setter
    def lam(self, v: float) -> None:
        self._arrivals = as_process(float(v))

    @property
    def mu_r(self) -> float:
        return self.service.mu.rate(0.0)

    @mu_r.setter
    def mu_r(self, v: float) -> None:
        self.service.mu = as_process(float(v))

    # -- fault verbs ------------------------------------------------------
    def kill_replica(self) -> bool:
        """An injected crash: one replica dies.  The control loop's
        replica leg (or a supervisor in the real stacks) restores it."""
        if self.replicas <= 1:
            return False
        self.replicas -= 1
        self.killed += 1
        return True

    # -- dynamics ---------------------------------------------------------
    def step(self, t: float = 0.0):
        """One period at scenario time ``t``; returns
        ``(tail_tc, tail_blk, head_tc, head_blk)`` *measured* counts
        (clock-skew distortion applied via ``meas_scale``)."""
        arrivals = int(self.rng.poisson(
            max(0.0, self._arrivals.rate(t))))
        self.offered_total += arrivals
        if self.shedding:
            self.shed_total += arrivals
            arrivals = 0
        eff = max(self.replicas - self.stalled, 0)
        can_serve = self.service.draw(self.rng, t, eff, self.stall_scale)
        # standard discrete-time queue recursion: service drains
        # concurrently with arrivals within the period, so acceptance is
        # bounded by free space PLUS what drains this period (a cap-16
        # queue still flows 100 items/period when the servers keep up —
        # the accept-then-serve ordering would throttle flow to ~cap
        # items/period and alias occupancy 0<->1 against the admission
        # band)
        acc = min(arrivals, self.capacity - self.backlog + can_serve)
        tail_blk = arrivals > acc          # producer hit a full queue
        srv = min(self.backlog + acc, can_serve)
        head_blk = can_serve > srv         # consumer starved this period
        self.backlog += acc - srv
        self.served_total += srv
        # end-of-period occupancy: sustained congestion, not the
        # transient arrival lump — the admission gate's input
        self.occ_high = self.backlog / max(self.capacity, 1)
        # queueing-delay proxy: backlog over the realized drain rate
        self.wait = self.backlog / max(float(srv), 1.0)
        m = self.meas_scale
        return float(acc) * m, tail_blk, float(srv) * m, head_blk

    @property
    def occupancy(self) -> float:
        return self.backlog / max(self.capacity, 1)


class SimActuator:
    """``ControlLoop`` adapter over one simulated tandem (same protocol
    as ``streams.Pipeline``'s adapter, same rejection contract).

    ``fail_verbs`` is the simulated-time twin of
    ``ft.inject.FaultyActuator``: a (shareable) ``{verb: count}`` dict
    of pending injected actuation failures — the scenario harness
    shares ONE dict across all tenants' actuators and the storm driver,
    so one ``"actuation"`` event makes exactly the next matching verb
    raise, whichever tenant the loop actuates first (the loop's
    retry/rollback path must absorb it)."""

    def __init__(self, sim: SimTandem,
                 max_replicas: Optional[int] = None,
                 fail_verbs: Optional[dict] = None):
        self.sim = sim
        self.actions: list[tuple] = []
        self.max_replicas = max_replicas
        self.fail_verbs = fail_verbs if fail_verbs is not None else {}

    def _gate(self, verb: str) -> None:
        if self.fail_verbs.get(verb, 0) > 0:
            self.fail_verbs[verb] -= 1
            self.actions.append((verb + "-injected-fail", -1))
            from repro_torch.ft.inject import InjectedFault
            raise InjectedFault(
                f"injected actuation failure: {verb} (simulated)")

    def replicas(self) -> np.ndarray:
        return np.array([self.sim.replicas], np.int64)

    def capacities(self) -> np.ndarray:
        return np.array([self.sim.capacity], np.int64)

    def occupancy(self) -> np.ndarray:
        return np.array([self.sim.occ_high])

    def scale(self, i: int, n: int) -> str:
        self._gate("scale")
        self.actions.append(("scale", int(n)))
        self.sim.replicas = int(n)
        return "applied"

    def resize(self, i: int, cap: int) -> str:
        self._gate("resize")
        if cap < self.sim.backlog:
            self.actions.append(("resize-rejected", int(cap)))
            return "rejected"
        self.actions.append(("resize", int(cap)))
        self.sim.capacity = int(cap)
        return "applied"

    def admit(self, i: int, shed: bool) -> str:
        self._gate("admit")
        self.actions.append(("shed" if shed else "admit", int(shed)))
        self.sim.shedding = bool(shed)
        return "applied"
