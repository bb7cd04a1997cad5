"""Deterministic fault injection for the streaming control plane.

The paper's motivating environment (§I) is a *hostile* shared cloud:
replicas die, straggle, and the clock the monitor samples by drifts.
``FaultPlan`` turns that into a reproducible experiment — a seedable
schedule of fault events consumed by hooks in ``streams.Pipeline``
workers, ``serve.Engine``'s batch loop, ``streams.FleetMonitorThread``
and the control loop's actuation path.  Every hook site guards with a
single ``plan is not None`` test, so a pipeline built without a plan
pays nothing on the hot path; an armed plan's per-check fast path is
one lock-free float comparison against the next due time.

Fault kinds (``FaultEvent.kind``):

* ``"crash"`` — a hooked worker raises ``InjectedFault`` mid-item (the
  replica dies exactly like a user kernel raising would);
* ``"stall"`` — the worker sleeps ``duration_s`` mid-item (a straggler:
  the replica's converged service rate phase-changes downward);
* ``"actuation"`` — the next matching actuator verb raises (wrap the
  real actuator in ``FaultyActuator``);
* ``"monitor_death"`` — the ``FleetMonitorThread`` tick loop exits
  without announcing (the silent daemon-thread death the control
  loop's watchdog must catch);
* ``"clock_skew"`` — while active, the monitor thread's realized-period
  observation is multiplied by ``factor`` (sampling clock drift: the
  period controller sees a distorted T).

Crash/stall/actuation/monitor-death events fire exactly once each
(first matching hook consumes them); clock skew is a *window* — active
from ``at_s`` for ``duration_s``.  ``fired()`` returns the consumption
audit (absolute fire time + event) for post-run assertions.

Targets match by name OR alias: ``serve.Engine`` workers check with
``aliases=(engine host, QoS class name)``, so one event may target a
single worker (``"engine:blocking#0"``), a whole engine (``"engine"``),
or one QoS bulkhead (``"nonblocking"`` — how the ``qos_spike`` bench
kills a borrowed patient replica mid-burst).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Sequence

import numpy as np

__all__ = ["FaultEvent", "FaultPlan", "FaultyActuator", "InjectedFault"]

KINDS = ("crash", "stall", "actuation", "monitor_death", "clock_skew")


class InjectedFault(RuntimeError):
    """Raised inside a hooked thread when a planned fault fires."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``at_s`` is seconds after ``arm()``;
    ``target`` names a stage/host (pipeline workers match their stage
    name and their ``host`` id), an actuator verb (``actuation``), or
    ``"*"`` for first-comer."""
    at_s: float
    kind: str
    target: str = "*"
    duration_s: float = 0.0      # stall length / clock-skew window
    factor: float = 1.0          # clock-skew multiplier

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"bad fault kind {self.kind!r}")


class FaultPlan:
    """A deterministic, thread-safe schedule of fault events.

    >>> plan = FaultPlan.chaos(seed=0, targets=["work"], n_crashes=3,
    ...                        window_s=(0.5, 1.5), monitor_death_at=1.0)
    >>> pipe = Pipeline(stages, fault_plan=plan)   # hooks the workers
    >>> plan.arm(); results = pipe.run_collect()
    >>> plan.fired()                               # the audit

    An un-armed plan never fires (hooks see nothing due), so the plan
    can be threaded through construction and armed exactly when the
    measured window starts.
    """

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self._events: list[FaultEvent] = sorted(events,
                                                key=lambda e: e.at_s)
        self._fired: list[tuple[float, FaultEvent]] = []
        self._lock = threading.Lock()
        self._t0: Optional[float] = None
        # lock-free fast-path bound: hooks skip the lock entirely until
        # the earliest pending one-shot event is due
        self._next_due = (min((e.at_s for e in self._events
                               if e.kind != "clock_skew"),
                              default=float("inf")))
        self._skews = [e for e in self._events if e.kind == "clock_skew"]

    # -- construction -----------------------------------------------------
    @classmethod
    def chaos(cls, seed: int, *, targets: Sequence[str],
              n_crashes: int = 3,
              window_s: tuple[float, float] = (0.5, 2.0),
              monitor_death_at: Optional[float] = None,
              n_stalls: int = 0, stall_s: float = 0.2,
              n_skews: int = 0, skew_s: float = 0.0,
              skew_factor: float = 1.0,
              monitor_outage_s: float = 0.0,
              n_act_fails: int = 0,
              act_verbs: Sequence[str] = ("scale", "resize", "admit")
              ) -> "FaultPlan":
        """The chaos-scenario generator: ``n_crashes`` replica kills and
        ``n_stalls`` stragglers at seeded-uniform times over ``window_s``
        targeting seeded-choice stages, ``n_skews`` clock-skew windows
        (``skew_s`` long, multiplying the realized sampling period by
        ``skew_factor``), plus an optional monitor-thread death
        (``monitor_outage_s`` rides the event's ``duration_s`` — the
        scenario foundry's simulated-time driver reads it as the sensing
        outage length; the real monitor hook ignores it, a dead thread
        stays dead until a watchdog acts).

        ``n_act_fails`` schedules actuation failures: each picks a
        seeded-choice verb from ``act_verbs`` at a seeded-uniform time
        — the next matching actuator verb raises (``FaultyActuator``
        wall-clock, or the scenario foundry's simulated-time driver,
        which routes them to ``SimActuator.fail_verbs``), and the
        control loop's retry/rollback path must absorb it.

        ``targets`` may be empty only when nothing targets a stage
        (``n_crashes == n_stalls == 0``) — an all-window storm (skew
        only) or an empty plan is a legitimate matrix corner.  Draw
        order is append-only (crashes, stalls, monitor, skews,
        actuation failures), so a given ``(seed, args)`` prefix
        reproduces the same schedule when new storm kinds are added
        after it."""
        rng = np.random.default_rng(seed)
        targets = list(targets)
        if (n_crashes or n_stalls) and not targets:
            raise ValueError("chaos() with crashes/stalls needs targets")
        events = [FaultEvent(at_s=float(rng.uniform(*window_s)),
                             kind="crash",
                             target=str(rng.choice(targets)))
                  for _ in range(n_crashes)]
        events += [FaultEvent(at_s=float(rng.uniform(*window_s)),
                              kind="stall",
                              target=str(rng.choice(targets)),
                              duration_s=stall_s)
                   for _ in range(n_stalls)]
        if monitor_death_at is not None:
            events.append(FaultEvent(at_s=float(monitor_death_at),
                                     kind="monitor_death",
                                     target="monitor",
                                     duration_s=float(monitor_outage_s)))
        events += [FaultEvent(at_s=float(rng.uniform(*window_s)),
                              kind="clock_skew", target="monitor",
                              duration_s=float(skew_s),
                              factor=float(skew_factor))
                   for _ in range(n_skews)]
        events += [FaultEvent(at_s=float(rng.uniform(*window_s)),
                              kind="actuation",
                              target=str(rng.choice(list(act_verbs))))
                   for _ in range(n_act_fails)]
        return cls(events)

    def events(self) -> tuple[FaultEvent, ...]:
        """The pending schedule, chronological — the scenario foundry's
        deterministic simulated-time driver reads (never consumes) it;
        the wall-clock hook API above consumes events instead."""
        with self._lock:
            return tuple(self._events)

    # -- lifecycle --------------------------------------------------------
    def arm(self, t0: Optional[float] = None) -> "FaultPlan":
        """Start the clock; hooks fire relative to this instant."""
        with self._lock:
            self._t0 = time.monotonic() if t0 is None else t0
        return self

    @property
    def armed(self) -> bool:
        return self._t0 is not None

    def pending(self) -> int:
        with self._lock:
            return len(self._events)

    def fired(self) -> list[tuple[float, FaultEvent]]:
        """(absolute monotonic fire time, event) consumption audit."""
        with self._lock:
            return list(self._fired)

    # -- hook API ----------------------------------------------------------
    def _pop_due(self, kinds: tuple[str, ...],
                 target: Optional[str] = None,
                 aliases: Sequence[str] = ()) -> Optional[FaultEvent]:
        t0 = self._t0
        if t0 is None:
            return None
        now = time.monotonic()
        if now - t0 < self._next_due:      # lock-free fast path
            return None
        with self._lock:
            for i, e in enumerate(self._events):
                if e.kind == "clock_skew" or e.kind not in kinds:
                    continue
                if now - t0 < e.at_s:
                    continue
                if (target is not None and e.target != "*"
                        and e.target != target
                        and e.target not in aliases):
                    continue
                del self._events[i]
                self._fired.append((now, e))
                self._next_due = min(
                    (x.at_s for x in self._events
                     if x.kind != "clock_skew"), default=float("inf"))
                return e
            return None

    def worker_fault_due(self, target: str,
                         aliases: Sequence[str] = ()
                         ) -> Optional[FaultEvent]:
        """Crash or stall due for this worker (stage name / host id)?
        Consumed on return; the caller raises or sleeps accordingly."""
        return self._pop_due(("crash", "stall"), target, aliases)

    def maybe_fault(self, target: str,
                    aliases: Sequence[str] = ()) -> None:
        """Worker hook: consume a due crash/stall for this worker —
        sleeps out a stall here, raises ``InjectedFault`` for a crash.
        Duck-typed on purpose: hooked layers call this without
        importing anything from ``repro_torch.ft``."""
        ev = self.worker_fault_due(target, aliases)
        if ev is None:
            return
        if ev.kind == "stall":
            time.sleep(ev.duration_s)
        else:
            raise InjectedFault(
                f"injected crash of {target!r} at t+{ev.at_s:.3f}s")

    def actuation_due(self, verb: str) -> Optional[FaultEvent]:
        """Actuation failure due for this verb (scale/resize/admit)?"""
        return self._pop_due(("actuation",), verb)

    def monitor_death_due(self) -> bool:
        return self._pop_due(("monitor_death",)) is not None

    def skew_factor(self, now: Optional[float] = None) -> float:
        """Product of the clock-skew windows active right now (1.0 when
        none — the monitor thread multiplies its realized-period
        observation by this)."""
        t0 = self._t0
        if t0 is None or not self._skews:
            return 1.0
        rel = (time.monotonic() if now is None else now) - t0
        f = 1.0
        for e in self._skews:
            if e.at_s <= rel < e.at_s + e.duration_s:
                f *= e.factor
        return f


class FaultyActuator:
    """Wrap a real ``ControlLoop`` actuator so planned ``actuation``
    events make the next matching verb raise ``InjectedFault`` —
    actuation-failure injection without touching the actuated layer."""

    def __init__(self, inner, plan: FaultPlan):
        self._inner = inner
        self._plan = plan

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _gate(self, verb: str) -> None:
        ev = self._plan.actuation_due(verb)
        if ev is not None:
            raise InjectedFault(f"injected actuation failure: {verb} "
                                f"at t+{ev.at_s:.3f}s")

    def scale(self, i: int, n: int) -> str:
        self._gate("scale")
        return self._inner.scale(i, n)

    def resize(self, i: int, cap: int) -> str:
        self._gate("resize")
        return self._inner.resize(i, cap)

    def admit(self, i: int, shed: bool) -> str:
        self._gate("admit")
        return self._inner.admit(i, shed)
