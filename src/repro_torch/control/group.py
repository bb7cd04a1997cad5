"""Multi-tenant control plane: ONE loop over many pipelines/engines.
The port of the JAX package's ``repro.control.group``.

The paper's motivating scenario (§I, §IV) is several applications
contending for one machine — exactly where per-application control
loops fall short: each sees only its own queues, so the fleet-median
straggler leg has no fleet and every tenant pays its own monitor +
decision dispatch.  ``ControlGroup`` closes that gap: any number of
``streams.Pipeline``s, ``serve.Engine``s (or anything exposing the
tenant protocol below) attach to ONE ``FleetMonitorService`` + ONE
``ControlLoop`` + ONE shared ``CounterArena``, so

* the collector samples every tenant's counters in one vectorized
  arena gather per tick and the whole group's Algorithm-1 state
  advances in one fused dispatch;
* the decision step evaluates every policy for every tenant's queue in
  one fused ``_step_math`` pass — the fleet median and the admission
  straggler leg finally span tenants;
* per-tenant policy differences ride as *per-queue operand arrays*
  (leg masks + replica-knob overrides), not as separate configs, so
  ragged tenant churn never retraces the decision dispatch
  (``control_decide_trace_count`` stays flat while the fleet stays
  within one ``block_q`` padding multiple: on the card, one CUDA graph).

Tenant protocol (duck-typed, no upward imports): an object with
``control_tenant() -> (queues, actuator)`` — ``streams.Pipeline`` and
``serve.Engine`` implement it (construct them with ``monitor=False``
and the group's ``arena`` so the group owns monitoring) — or a raw
``(queues, actuator)`` pair for simulation harnesses.  Attached
tenants that expose ``_bind_external_monitor`` receive a
``_TenantFleetView`` so their advisory readouts (``Pipeline.rates()``,
``Engine.service_rate()``, ...) keep working against the shared
service, sliced to their own queue range.

Lock ordering: the group lock is the *outermost* rank of the lock
hierarchy (``repro_torch.analysis.lock_order.LOCK_ORDER``).
Attach/detach descend it in declared order — group, then loop, then
the service/arena mutation, then remap — so a tick can never observe
a half-restructured group.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np

from repro_torch.control.log import ControlLog
from repro_torch.control.loop import ControlLoop
from repro_torch.control.policy import Decision, PolicySet
from repro_torch.streams.arena import CounterArena, default_arena
from repro_torch.streams.fleet import FleetMonitorService
from repro_torch.streams.monitor_thread import FleetMonitorThread

__all__ = ["ControlGroup", "CompositeActuator", "TenantHandle"]


@dataclasses.dataclass
class TenantHandle:
    """One attached tenant: its queues, its actuator, and the resolved
    per-queue policy overrides the composite actuator concatenates."""
    name: str
    obj: object                    # the attached object (None for raw pairs)
    queues: list
    actuator: object
    policies: Optional[PolicySet]  # None = inherit the group PolicySet
    # resolved by ControlGroup._resolve before the handle is used —
    # None placeholders, not duplicated policy defaults
    leg_rep: Optional[bool] = None
    leg_buf: Optional[bool] = None
    leg_adm: Optional[bool] = None
    headroom: Optional[float] = None
    max_replicas: Optional[int] = None

    def __len__(self) -> int:
        return len(self.queues)


class CompositeActuator:
    """The ``ControlLoop`` adapter over every attached tenant: sense
    reads concatenate the per-tenant adapters in attach order (the same
    order the service reports queues), actuation verbs route by queue
    offset.  Reads and routes run under the loop's tick lock, and the
    group mutates the tenant list only while holding that same lock, so
    offsets can never shift mid-tick."""

    def __init__(self, group: "ControlGroup"):
        self._group = group

    def _concat(self, method, dtype, empty_dtype=None):
        ts = self._group._tenants
        if not ts:
            return np.zeros(0, empty_dtype or dtype)
        return np.concatenate([np.asarray(getattr(t.actuator, method)(),
                                          dtype) for t in ts])

    def replicas(self) -> np.ndarray:
        return self._concat("replicas", np.int64)

    def capacities(self) -> np.ndarray:
        return self._concat("capacities", np.int64)

    def occupancy(self) -> np.ndarray:
        # occupancy is admission-only in the adapter contract: a tenant
        # whose adapter omits it (no admission leg) reads as empty
        parts = []
        for t in self._group._tenants:
            a = t.actuator
            parts.append(np.asarray(a.occupancy(), float)
                         if hasattr(a, "occupancy")
                         else np.zeros(len(t)))
        return (np.concatenate(parts) if parts else np.zeros(0))

    def scalable(self) -> np.ndarray:
        parts = []
        for t in self._group._tenants:
            a = t.actuator
            parts.append(np.asarray(a.scalable(), bool)
                         if hasattr(a, "scalable")
                         else np.ones(len(t), bool))
        return (np.concatenate(parts) if parts else np.zeros(0, bool))

    def faulty(self) -> np.ndarray:
        """Concatenated degraded-queue masks: a tenant whose adapter has
        no supervision (no ``faulty``) contributes all-healthy."""
        parts = []
        for t in self._group._tenants:
            a = t.actuator
            parts.append(np.asarray(a.faulty(), bool)
                         if hasattr(a, "faulty")
                         else np.zeros(len(t), bool))
        return (np.concatenate(parts) if parts else np.zeros(0, bool))

    def admission_bands(self) -> tuple[np.ndarray, np.ndarray]:
        """Concatenated per-queue admission (hi, lo) occupancy bands: a
        tenant without QoS classes (no ``admission_bands``) contributes
        NaN rows, which inherit the config scalars in the decision."""
        his, los = [], []
        for t in self._group._tenants:
            a = t.actuator
            if hasattr(a, "admission_bands"):
                hi, lo = a.admission_bands()
                his.append(np.asarray(hi, np.float32))
                los.append(np.asarray(lo, np.float32))
            else:
                his.append(np.full(len(t), np.nan, np.float32))
                los.append(np.full(len(t), np.nan, np.float32))
        if not his:
            z = np.zeros(0, np.float32)
            return z, z
        return np.concatenate(his), np.concatenate(los)

    def slo_targets(self) -> np.ndarray:
        """Concatenated per-queue latency SLO targets (NaN = no SLO):
        a tenant attached with its own ``SLOPolicy`` contributes that
        policy's targets, a QoS-aware actuator (``serve.Engine``)
        overlays deadline-derived per-lane targets on top, and
        everything else contributes NaN — the loop's sense step overlays
        the whole thing over the group ``SLOPolicy``'s defaults."""
        parts = []
        for t in self._group._tenants:
            p = t.policies.slo if t.policies is not None else None
            base = (p.targets(len(t)) if p is not None
                    else np.full(len(t), np.nan, np.float32))
            a = t.actuator
            if hasattr(a, "slo_targets"):
                ta = np.asarray(a.slo_targets(), np.float32)
                base = np.where(np.isnan(ta), base, ta)
            parts.append(base)
        return (np.concatenate(parts) if parts
                else np.zeros(0, np.float32))

    def pressure(self) -> np.ndarray:
        """Concatenated sibling-lane pressure: tenants without QoS
        lanes contribute zero (pressure never crosses tenants — one
        tenant's burst must not shed a neighbor's patient traffic)."""
        parts = []
        for t in self._group._tenants:
            a = t.actuator
            parts.append(np.asarray(a.pressure(), float)
                         if hasattr(a, "pressure")
                         else np.zeros(len(t)))
        return (np.concatenate(parts) if parts else np.zeros(0))

    def policy_overrides(self) -> dict:
        """Per-queue tenant masks + replica-knob overrides, merged into
        the one fused decision: every array is (Q,) in group queue
        order, so the dispatch shape (and the trace) is identical to
        the no-override case.  The arrays only change on attach/detach,
        so the group caches them there instead of rebuilding five (Q,)
        concatenations on every tick of the decision path."""
        return self._group._overrides

    def _locate(self, i: int):
        j = i
        for t in self._group._tenants:
            if j < len(t):
                return t, j
            j -= len(t)
        raise IndexError(f"queue {i} not in any attached tenant")

    def scale(self, i: int, n: int) -> str:
        t, j = self._locate(i)
        return t.actuator.scale(j, n)

    def resize(self, i: int, cap: int) -> str:
        t, j = self._locate(i)
        return t.actuator.resize(j, cap)

    def admit(self, i: int, shed: bool) -> str:
        t, j = self._locate(i)
        return t.actuator.admit(j, shed)


class _TenantFleetView:
    """Sliced advisory readouts of the shared service for one tenant —
    what ``Pipeline.rates()`` / ``Engine.service_rate()`` consume when
    the group owns monitoring.  Rate/cv2/blocking readouts slice the
    tenant's queue range; ``epochs()`` re-assembles the tenant's own
    heads-then-tails order.  Each readout holds the group lock across
    the span computation AND the service read — a concurrent
    attach/detach (which mutates the tenant list and restructures the
    service under the same lock) can therefore never shift the offsets
    between the two and hand this tenant a neighbor's rates."""

    def __init__(self, group: "ControlGroup", handle: TenantHandle):
        self._group = group
        self._handle = handle

    def _span_locked(self) -> tuple[int, int]:
        lo = 0
        for t in self._group._tenants:
            if t is self._handle:
                return lo, lo + len(t)
            lo += len(t)
        raise RuntimeError(
            f"tenant {self._handle.name!r} is no longer attached")

    def _sliced(self, method) -> np.ndarray:
        with self._group._lock:
            lo, hi = self._span_locked()
            return getattr(self._group.service, method)()[lo:hi]

    @property
    def period_s(self) -> float:
        return self._group.service.period_s

    def service_rates(self) -> np.ndarray:
        return self._sliced("service_rates")

    def arrival_rates(self) -> np.ndarray:
        return self._sliced("arrival_rates")

    def cv2s(self) -> np.ndarray:
        return self._sliced("cv2s")

    def observed_blocking_fraction(self) -> np.ndarray:
        return self._sliced("observed_blocking_fraction")

    def epochs(self) -> np.ndarray:
        with self._group._lock:
            lo, hi = self._span_locked()
            eps = self._group.service.epochs()
            q = len(self._group.service.queues)
            return np.concatenate([eps[lo:hi], eps[q + lo:q + hi]])


class ControlGroup:
    """One control plane — monitor service, decision loop, audit log —
    spanning every attached tenant.

    >>> group = ControlGroup(PolicySet(replica=..., buffer=...),
    ...                      arena=arena)
    >>> group.attach(pipe_a)            # Pipeline(monitor=False, arena=arena)
    >>> group.attach(pipe_b)
    >>> group.attach(engine, policies=PolicySet(buffer=..., admission=...))
    >>> group.start()                   # or drive manually:
    >>> group.service.sample(); group.tick()

    The group's ``PolicySet`` is the superset configuration (it builds
    the one fused ``ControlConfig`` every decision shares); a tenant
    attached with its own ``PolicySet`` narrows which legs apply to its
    queues and overrides the replica knobs (headroom / max_replicas)
    there — a tenant may not enable a leg the group config lacks.

    The shared service's estimator state and the decision live on
    ``device`` (the card by default; ``device="cpu"`` for the host).
    """

    def __init__(self, policies: PolicySet, *,
                 arena: Optional[CounterArena] = None,
                 monitor_cfg=None, period_s: float = 1e-3,
                 chunk_t: int = 32, scale_to_period: bool = True,
                 block_q: int = 32, log: Optional[ControlLog] = None,
                 impl: str = "auto",
                 loop_period_s: Optional[float] = None,
                 obs=None, device="cuda"):
        self.arena = arena if arena is not None else default_arena()
        self.policies = policies
        # the service is born empty; arena= seeds it so monitoring
        # lands in the group's arena from the first attach
        self.service = FleetMonitorService(
            [], monitor_cfg, period_s=period_s, chunk_t=chunk_t,
            scale_to_period=scale_to_period, ends="both",
            block_q=block_q, arena=self.arena, device=device)
        self.monitor = FleetMonitorThread(self.service)
        self.actuator = CompositeActuator(self)
        self.loop = ControlLoop(self.service, policies, self.actuator,
                                log=log, impl=impl,
                                period_s=loop_period_s)
        self._tenants: list[TenantHandle] = []
        # per-queue override arrays for the fused decision, rebuilt on
        # attach/detach only (they are static between restructures)
        self._overrides: dict = {}
        self._lock = threading.Lock()   # serializes attach/detach/stop
        self._started = False
        self._stopped = False
        # observability knob: None/False = off, True = exporter on an
        # ephemeral port, int = that port, dict = MetricsExporter
        # kwargs; the exporter reads the shared service/loop mirrors
        # and labels each queue with its tenant's name
        from repro_torch.obs import make_exporter   # no cycle: obs is leaf
        self.exporter = make_exporter(
            obs, service=self.service, loop=self.loop,
            log=self.loop.log, names=self._queue_names,
            extra=self._extra_metrics)

    def _queue_names(self) -> list[str]:
        return [t.name for t in self._tenants for _ in range(len(t))]

    def _extra_metrics(self) -> dict:
        """Per-tenant process gauges for the exporter: degraded-queue
        counts (crash-loop breaker states ride the ``faulty`` mask) and
        supervisor breaker-trip counters where a tenant has them."""
        faulty: dict[str, float] = {}
        trips: dict[str, float] = {}
        for t in self._tenants:
            a = t.actuator
            if hasattr(a, "faulty"):
                faulty[t.name] = float(
                    np.sum(np.asarray(a.faulty(), bool)))
            sup = getattr(t.obj, "supervisor", None)
            if sup is not None and hasattr(sup, "breaker_trips"):
                trips[t.name] = float(sup.breaker_trips)
        out: dict = {}
        if faulty:
            out["repro_tenant_faulty_queues"] = faulty
        if trips:
            out["repro_tenant_breaker_trips_total"] = trips
        return out

    def _rebuild_overrides_locked(self) -> None:
        ts = self._tenants
        if not ts:
            self._overrides = {}
            return

        def per_queue(field, dtype):
            return np.concatenate(
                [np.full(len(t), getattr(t, field), dtype) for t in ts])

        self._overrides = {
            "leg_rep": per_queue("leg_rep", bool),
            "leg_buf": per_queue("leg_buf", bool),
            "leg_adm": per_queue("leg_adm", bool),
            "headroom": per_queue("headroom", np.float32),
            "max_replicas": per_queue("max_replicas", np.int32),
        }

    # -- tenant management -------------------------------------------------
    def _adapt(self, tenant):
        if hasattr(tenant, "control_tenant"):
            # a tenant that still owns its own monitoring or control
            # would double-collect the shared arena cells (each
            # copy-and-zero steals the other's counts — both estimators
            # silently read ~half the true rates) or double-actuate:
            # require monitor=False (and therefore control off)
            if (getattr(tenant, "monitor", None) is not None
                    or getattr(tenant, "monitor_thread", None) is not None
                    or getattr(tenant, "control", None) is not None):
                raise ValueError(
                    "tenant monitors/controls itself — build it with "
                    "monitor=False (and the group's arena) so the "
                    "ControlGroup owns monitoring and control")
            queues, actuator = tenant.control_tenant()
            return list(queues), actuator, tenant
        queues, actuator = tenant        # raw (queues, actuator) pair
        return list(queues), actuator, None

    def _resolve(self, handle: TenantHandle) -> None:
        eff = (handle.policies if handle.policies is not None
               else self.policies)
        for leg in ("replica", "buffer", "admission", "slo"):
            if (getattr(eff, leg) is not None
                    and getattr(self.policies, leg) is None):
                raise ValueError(
                    f"tenant {handle.name!r} enables the {leg} leg but "
                    "the group PolicySet does not configure it — build "
                    "the group with the superset PolicySet")
        # gating/probe knobs are part of the ONE shared ControlConfig
        # (the decision's cache key) and cannot vary per tenant: reject a
        # tenant PolicySet that asks for different ones (a knob left at
        # the PolicySet default reads as unspecified and inherits the
        # group's) rather than silently applying the group's
        if handle.policies is not None:
            defaults = {f.name: f.default
                        for f in dataclasses.fields(PolicySet)}
            for knob in ("confirm_ticks", "cooldown_ticks", "block_q",
                         "probe_period_ticks", "probe_window_ticks"):
                tv = getattr(handle.policies, knob)
                if tv != getattr(self.policies, knob) \
                        and tv != defaults[knob]:
                    raise ValueError(
                        f"tenant {handle.name!r} sets {knob}={tv} but "
                        "gating/probe knobs are group-wide (one fused "
                        "ControlConfig) — the group uses "
                        f"{getattr(self.policies, knob)}")
        # buffer/admission knobs have no per-queue operand form — they
        # live in the ONE shared ControlConfig — so a tenant policy
        # carrying different knobs would be silently overridden by the
        # group's: reject it instead (replica knobs ARE overridable)
        for leg in ("buffer", "admission", "slo"):
            tp, gp = getattr(eff, leg), getattr(self.policies, leg)
            if (handle.policies is not None and tp is not None
                    and tp.config_kwargs() != gp.config_kwargs()):
                raise ValueError(
                    f"tenant {handle.name!r} carries {leg} knobs "
                    f"{tp.config_kwargs()} that differ from the "
                    f"group's {gp.config_kwargs()} — only replica "
                    "knobs (headroom/max_replicas) and SLO targets "
                    "are per-tenant")
        handle.leg_rep = eff.replica is not None
        handle.leg_buf = eff.buffer is not None
        handle.leg_adm = eff.admission is not None
        cfg = self.loop.cfg
        handle.headroom = (eff.replica.ctrl.headroom if eff.replica
                           else cfg.headroom)
        handle.max_replicas = (eff.replica.ctrl.max_replicas
                               if eff.replica else cfg.max_replicas)

    def attach(self, tenant, *, policies: Optional[PolicySet] = None,
               name: Optional[str] = None) -> TenantHandle:
        """Attach a tenant (live).  Holds the loop's tick lock across
        the service restructure + loop remap, so attach is atomic with
        respect to control ticks; the monitor's per-stream state for
        already-attached tenants is preserved (see
        ``FleetMonitorService.attach``)."""
        queues, actuator, obj = self._adapt(tenant)
        # a malformed adapter (sense arrays shorter than the queue
        # list) would kill the shared loop for EVERY tenant on its
        # next tick — fail the one bad attach instead
        for sense in ("replicas", "capacities"):
            n = np.asarray(getattr(actuator, sense)()).shape[0]
            if n != len(queues):
                raise ValueError(
                    f"tenant actuator's {sense}() reports {n} queues "
                    f"but the tenant attaches {len(queues)}")
        handle = TenantHandle(
            name=name or getattr(obj, "name", None)
            or f"tenant{len(self._tenants)}",
            obj=obj, queues=queues, actuator=actuator, policies=policies)
        self._resolve(handle)
        # a QoS-aware actuator (serve.Engine) audits its per-class gate
        # flips into the group's shared ring
        if hasattr(actuator, "bind_log"):
            actuator.bind_log(self.loop.log)
        with self._lock:
            with self.loop._lock:
                n_old = len(self.service.queues)
                self.service.attach(queues)
                self.loop._remap_locked(np.concatenate(
                    [np.arange(n_old, dtype=np.int64),
                     np.full(len(queues), -1, np.int64)]))
                self._tenants.append(handle)
                self._rebuild_overrides_locked()
                # compile the decision dispatch for the (possibly) new
                # padded shape BEFORE releasing the tick lock — a
                # running loop thread racing us here would otherwise
                # pay the first-call compile inside its next tick (the
                # service side re-warms inside its restructure the same
                # way; warmup itself takes no locks)
                self.loop.warmup()
            # bind under the group lock: a racing detach() could
            # otherwise unbind first and be overwritten by a stale view
            if hasattr(obj, "_bind_external_monitor"):
                obj._bind_external_monitor(_TenantFleetView(self, handle))
        return handle

    def detach(self, handle_or_obj) -> None:
        """Detach a tenant (live): its queues leave the monitored fleet
        (and are un-pinned, so the tenant may close them), every other
        tenant keeps its estimator and gating state."""
        with self._lock:
            handle = next(
                (t for t in self._tenants
                 if t is handle_or_obj or t.obj is handle_or_obj), None)
            if handle is None:
                raise KeyError("tenant not attached")
            with self.loop._lock:
                drop = {id(q) for q in handle.queues}
                keep = [i for i, q in enumerate(self.service.queues)
                        if id(q) not in drop]
                self.service.detach(handle.queues)
                self.loop._remap_locked(np.asarray(keep, np.int64))
                self._tenants.remove(handle)
                self._rebuild_overrides_locked()
                self.loop.warmup()
            if hasattr(handle.obj, "_bind_external_monitor"):
                handle.obj._bind_external_monitor(None)
            # a supervised tenant's replica hosts must not linger in the
            # heartbeat registry after the tenant leaves the group — a
            # later re-attach would otherwise inherit stale lapses
            sup = getattr(handle.obj, "supervisor", None)
            if sup is not None:
                sup.forget_tenant()

    def tenants(self) -> list[TenantHandle]:
        return list(self._tenants)

    # -- plumbing ----------------------------------------------------------
    @property
    def log(self) -> ControlLog:
        return self.loop.log

    def tick(self) -> Decision:
        """One manual sense->decide->actuate pass over every tenant."""
        return self.loop.tick()

    def start(self) -> "ControlGroup":
        """Start the shared monitor thread + control loop thread."""
        with self._lock:
            if self._stopped:
                raise RuntimeError(
                    "ControlGroup is stopped — the service is quiesced "
                    "and cannot be restarted; build a new group")
            if not self._started:
                self._started = True
                self.monitor.start()
                self.loop.start()
                if self.exporter is not None:
                    self.exporter.start()
        return self

    def stop(self) -> None:
        """Stop the loop, then the monitor (join + flush), then quiesce
        the service (un-pins every tenant's ends).  Idempotent, and
        holds the group lock so a concurrent attach/detach cannot
        register a tenant against the quiescing service.  Safe: neither
        thread being joined ever takes the group lock (the loop reads
        tenants lock-free under its own tick lock; only tenant VIEWS
        take the group lock, and they run on tenant threads)."""
        with self._lock:
            self._stopped = True
            if self.exporter is not None:
                self.exporter.stop()
            self.loop.stop()
            self.monitor.stop()
            self.service.stop()
