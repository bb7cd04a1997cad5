"""Serving engine: batched prefill + decode behind per-QoS-class
request lanes with bulkhead replica isolation.

The port of the JAX package's ``repro.serve.engine``, the same to the
token: a round right-pads its prompts to the round's longest and takes
the first token from the last position's logits, and decodes every row
for the round's largest ``max_new`` with the cache write clamped at its
end, as the JAX package does.  The model runs on ``device`` (the card by
default: the prefill's attention through the flash-attention kernel);
the lanes' monitor is the port's ``FleetMonitorService`` on the same
device (the ``monitor_fleet`` kernel), and ``control=True`` closes the
loop over it with a ``control.ControlLoop`` (its decision, on the card,
one CUDA-graph replay per tick).

The request lanes are paper-instrumented streams: each QoS class (see
``serve.qos``) gets its OWN ``InstrumentedQueue`` whose ends live on a
*contiguous* ``CounterArena`` slot range (``CounterArena.reserve_span``),
so the monitor's converged non-blocking service rate is estimated **per
class** by the very same one-gather fleet collector — per-class λ/μ at
zero new collector cost.  Monitoring rides the fleet path
(``FleetMonitorService`` + ``FleetMonitorThread``): all lane ends are
collected into one staging tile and Algorithm 1 advances in one fused
dispatch per chunk, the same hot path ``streams.Pipeline`` uses.

**Bulkheads.**  Serve workers are partitioned per class
(``ServeConfig.bulkheads``), so a patient-class backlog can never
consume the blocking class's replicas — the head-of-line collapse a
shared worker pool suffers under a burst.  Borrowing is *bounded and
one-way*: a patient-lane worker may serve a non-patient (blocking) lane
while that lane runs hotter than its home lane (at most
``borrow_streak`` borrowed rounds before it pays one home round),
never the reverse — blocking replicas are reserved capacity.

**Admission.**  Every class has its own ``AdmissionGate`` (mode from
the class, inheriting the ``AdmissionPolicy``).  ``control=True``
closes the loop per class: the ``ControlLoop`` senses per-lane
estimates plus this engine's ``admission_bands()`` (per-class
occupancy targets) and ``pressure()`` (patient lanes feel the blocking
lanes' occupancy) operands, and the ONE fused decision sheds patient
traffic first while blocking callers defer with a deadline
(``Request.deadline_s`` bounds gate wait + enqueue; expired queued
requests are dropped at pop).  A shut gate **sheds** (``submit``
returns False immediately) or **defers** (blocks until reopen /
deadline); ``Engine.stop()`` closes every gate so deferred waiters are
released immediately instead of stranding until their full timeout.

Lock ordering: every engine lock (gate condition, lane ``_resize_lock``,
``_scale_lock``, ``_acct_lock``, ``_crash_lock``) is mutually disjoint
by protocol rather than totally ordered (the *sync* tier of the JAX
package's ``LOCK_ORDER``). The protocol: ``submit`` takes gate condition
then lane lock sequentially (never nested with another lane); workers
take ``_scale_lock`` only in ``workers()``/scale paths, never while
holding a lane lock; ``_acct_lock`` is taken after serving, never under
``_scale_lock`` or any lane lock; the control loop's actuator reads lane
lengths lock-free and flips gates under the gate condition only — no
path holds two lane locks at once.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.control.log import ControlLog, ControlRecord
from repro_torch.control.loop import ControlLoop
from repro_torch.control.policy import (AdmissionPolicy, BufferPolicy,
                                        PolicySet)
from repro_torch.core.controller import BufferAutotuner
from repro_torch.core.monitor import MonitorConfig, resolve_device
from repro_torch.models.api import Model
from repro_torch.obs import make_exporter
from repro_torch.serve.qos import BLOCKING, QoSClass, qos_class
from repro_torch.streams import (CounterArena, FleetMonitorService,
                                 FleetMonitorThread, InstrumentedQueue)
from repro_torch.streams.arena import default_arena, hist_quantiles

__all__ = ["Request", "ServeConfig", "Engine", "AdmissionGate"]


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray           # prompt token ids
    max_new: int = 16
    qos: str = BLOCKING          # QoS class tag (see serve.qos)
    deadline_s: Optional[float] = None   # admission-to-enqueue budget;
    #                              expired queued requests drop at pop
    out: Optional[np.ndarray] = None
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    t_submit: float = 0.0        # stamped by Engine.submit
    t_done: float = 0.0          # stamped when the round finishes it


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_size: int = 8
    max_seq: int = 256
    queue_capacity: int = 64     # per lane
    # QoS lanes, in lane order (lane 0 is the primary/compat lane the
    # ``queue``/``gate`` aliases point at)
    qos_classes: tuple = (BLOCKING, "nonblocking")
    # serve workers per class (bulkhead partitions); None = 1 each
    bulkheads: Optional[tuple] = None
    borrow: bool = True          # patient workers may serve hot
    #                              non-patient lanes (never the reverse)
    borrow_streak: int = 4       # borrowed rounds per forced home round


class AdmissionGate:
    """The actuated admission state: open admits, shut sheds or defers.

    The gate itself is dumb on purpose — *when* it moves is the
    ``AdmissionPolicy``'s call (made inside the control loop's fused
    decision step); the gate only enforces the verdict on ``submit``.
    Deferred waiters park on a condition, so ``close()`` (engine
    shutdown) releases every one of them immediately — a caller can
    never be stranded on a gate whose engine is gone.  Counters
    distinguish every rejection path: ``shed_count`` (rejected while
    shut, or arriving at a closed gate), ``defer_count`` (waited on a
    shut gate), ``defer_timeout_count`` (the wait lapsed),
    ``stop_released`` (released by ``close()``).
    """

    def __init__(self, mode: str = "shed", name: str = ""):
        if mode not in ("shed", "defer"):
            raise ValueError(f"bad admission mode {mode!r}")
        self.mode = mode
        self.name = name
        self._cond = threading.Condition()
        self._is_open = True
        self._closed = False
        self.shed_count = 0           # submits rejected while shut
        self.defer_count = 0          # submits that waited on a shut gate
        self.defer_timeout_count = 0  # deferred waits that lapsed
        self.stop_released = 0        # waiters released by close()

    @property
    def shedding(self) -> bool:
        return not self._is_open

    def set_shed(self, shed: bool) -> None:
        with self._cond:
            reopening = not self._is_open and not shed
            self._is_open = not shed
            if reopening:
                self._cond.notify_all()

    def close(self) -> None:
        """Terminal shutdown: release every deferred waiter now (each
        returns False) and reject all future submits."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def allow(self, timeout: float) -> bool:
        """Gate one submit.  ``shed`` rejects immediately while shut;
        ``defer`` blocks until the gate reopens, the timeout lapses, or
        the gate is closed by engine shutdown."""
        with self._cond:
            if self._closed:
                self.shed_count += 1
                return False
            if self._is_open:
                return True
            if self.mode == "shed":
                self.shed_count += 1
                return False
            self.defer_count += 1
            deadline = time.monotonic() + max(timeout, 0.0)
            while not self._is_open and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self.defer_timeout_count += 1
                    return False
                self._cond.wait(remaining)
            if self._closed:
                self.stop_released += 1
                return False
            return True


@dataclasses.dataclass
class _LaneStats:
    """Per-class submit/serve accounting (``_acct_lock`` guards it)."""
    submitted: int = 0
    admitted: int = 0
    served: int = 0
    queue_timeouts: int = 0      # admitted but the lane stayed full
    deadline_dropped: int = 0    # expired in-queue, dropped at pop


class _ServeWorker(threading.Thread):
    """One bulkhead replica: a serve thread homed to a QoS class."""

    def __init__(self, eng: "Engine", qos_name: str, seq: int):
        host = f"{eng.host}:{qos_name}#{seq}"
        super().__init__(target=eng._worker_loop, args=(self,),
                         daemon=True, name=f"repro-serve-{host}")
        self.qos = qos_name          # home class / bulkhead partition
        self.host = host             # heartbeat + fault-plan identity
        self.retire = threading.Event()
        self.crashed: Optional[BaseException] = None
        self.handled = False         # supervisor's seen-this-death flag
        self.items = 0               # requests served (supervisor rate leg)
        self.borrowed = 0            # rounds served from a borrowed lane
        self.streak = 0              # consecutive borrowed rounds


class _EngineActuator:
    """``ControlLoop`` adapter for one engine (one queue per QoS lane).

    Beyond the base verbs it senses the class-aware admission operands:
    ``admission_bands()`` (per-lane occupancy_hi/lo, NaN = inherit the
    policy scalars) and ``pressure()`` (patient lanes carry the hottest
    non-patient lane's occupancy, so patient admission arms first when
    blocking traffic runs hot).  With a bound ``ControlLog``
    (``bind_log``) every gate flip appends a qos-tagged record carrying
    the class's cumulative rejection count — per-class shed/defer
    accounting lands in the same audit ring as the loop's decisions.
    """

    def __init__(self, eng: "Engine"):
        self.eng = eng
        self._log: Optional[ControlLog] = None

    def bind_log(self, log: ControlLog) -> None:
        self._log = log

    def _lanes(self) -> list[InstrumentedQueue]:
        eng = self.eng
        return [eng.lanes[n] for n in eng.class_names]

    def replicas(self) -> np.ndarray:
        sizes = self.eng.bulkhead_sizes()
        return np.array([sizes[n] for n in self.eng.class_names],
                        np.int64)

    def capacities(self) -> np.ndarray:
        return np.array([q.capacity for q in self._lanes()], np.int64)

    def occupancy(self) -> np.ndarray:
        return np.array([q.occupancy() for q in self._lanes()])

    def faulty(self) -> np.ndarray:
        eng = self.eng
        return np.array([n in eng._degraded for n in eng.class_names],
                        bool)

    def admission_bands(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-lane (occupancy_hi, occupancy_lo); NaN inherits the
        ``ControlConfig`` scalars inside ``control_decide``."""
        cs = self.eng.qos
        hi = np.array([np.nan if c.occupancy_hi is None
                       else c.occupancy_hi for c in cs], np.float32)
        lo = np.array([np.nan if c.occupancy_lo is None
                       else c.occupancy_lo for c in cs], np.float32)
        return hi, lo

    def slo_targets(self) -> np.ndarray:
        """Per-lane latency SLO targets for the burn-rate leg: a QoS
        class's deadline IS its latency target (NaN = deadline-less
        class, no SLO) — serve and control share one latency truth."""
        return np.array([np.nan if c.deadline_s is None else c.deadline_s
                         for c in self.eng.qos], np.float32)

    def pressure(self) -> np.ndarray:
        """Patient lanes feel the hottest non-patient lane's occupancy
        — the shed-patient-traffic-first leg's operand.  Non-patient
        lanes (and everything when no blocking lane exists) read 0."""
        eng = self.eng
        occ = {n: eng.lanes[n].occupancy() for n in eng.class_names}
        hot = max((occ[n] for n, c in zip(eng.class_names, eng.qos)
                   if not c.patient), default=0.0)
        return np.array([hot if c.patient else 0.0 for c in eng.qos])

    def scale(self, i: int, n: int) -> str:
        return "noop"              # engine replicas live above this layer

    def resize(self, i: int, cap: int) -> str:
        lane = self._lanes()[i]
        return "applied" if lane.resize(int(cap)) else "rejected"

    def admit(self, i: int, shed: bool) -> str:
        eng = self.eng
        name = eng.class_names[i]
        gate = eng.gates[name]
        gate.set_shed(shed)
        log = self._log
        if log is not None:
            # per-class companion record: the class's cumulative
            # rejections ride ``value`` so a shed is distinguishable
            # from a queue timeout in the audit stream
            log.append(ControlRecord(
                tick=0, t=time.monotonic(), queue=int(i), policy="qos",
                observed_lam=0.0, observed_mu=0.0,
                action="shed" if shed else "admit",
                value=gate.shed_count + gate.defer_timeout_count,
                outcome="applied", qos=name))
        return "applied"


class Engine:
    """Continuous-batching engine (static batch per generation round)
    with per-QoS-class lanes and bulkhead worker partitions."""

    def __init__(self, model: Optional[Model], params, scfg: ServeConfig,
                 monitor_cfg: Optional[MonitorConfig] = None,
                 arena: Optional[CounterArena] = None,
                 control: bool = False,
                 admission: Optional[AdmissionPolicy] = None,
                 control_log: Optional[ControlLog] = None,
                 monitor: bool = True,
                 fault_plan=None,
                 obs=None,
                 device="cuda"):
        self.device = resolve_device(device)
        # the decision log a control=True engine's loop writes to
        self.control_log = control_log
        self.model = model
        self.params = params
        self.scfg = scfg
        # optional ft.inject.FaultPlan (duck-typed, no ft import): lets
        # the chaos harness crash/stall serve workers deterministically.
        # Workers pass aliases=(engine host, class name), so a plan
        # event may target one worker, the whole engine, or a bulkhead.
        self.fault_plan = fault_plan
        self.host = "engine"           # heartbeat identity for supervision
        self.heartbeats = None         # bound by a ReplicaSupervisor
        self._crashes: list[dict] = []
        self._crash_lock = threading.Lock()
        # -- QoS lanes -------------------------------------------------------
        self.qos: list[QoSClass] = [qos_class(n) for n in scfg.qos_classes]
        if not self.qos:
            raise ValueError("ServeConfig.qos_classes must name >= 1 class")
        self.class_names = [c.name for c in self.qos]
        if len(set(self.class_names)) != len(self.class_names):
            raise ValueError(
                f"duplicate QoS classes: {self.class_names}")
        self._cls = dict(zip(self.class_names, self.qos))
        # lanes a patient worker may borrow into (non-patient = reserved
        # capacity it may top up, never drain from)
        self._borrowable = [c.name for c in self.qos if not c.patient]
        # contiguous per-class slot ranges: reserve one ascending run of
        # 2 slots per class so every lane's (head, tail) pair — and the
        # whole engine's block — stays a slice for the fleet collector
        arena_obj = arena if arena is not None else default_arena()
        arena_obj.reserve_span(2 * len(self.qos))
        self.lanes: dict[str, InstrumentedQueue] = {
            c.name: InstrumentedQueue(
                scfg.queue_capacity, item_bytes=1,
                name=f"requests:{c.name}", arena=arena_obj)
            for c in self.qos}
        # compat aliases: the primary (lane-0) queue and gate
        self.queue = self.lanes[self.class_names[0]]
        if not monitor and control:
            raise ValueError(
                "monitor=False hands monitoring AND control to a "
                "ControlGroup — control must stay off")
        # ``monitor=False`` builds the engine externally monitored:
        # attach it to a ``ControlGroup`` (sharing the
        # group's arena), which owns one monitor + loop for every
        # tenant and binds a sliced fleet view back here
        if monitor:
            self.fleet = FleetMonitorService(
                [self.lanes[n] for n in self.class_names],
                monitor_cfg or MonitorConfig(window=16, min_q_samples=16),
                period_s=10e-3, chunk_t=16, ends="both",
                device=self.device)
            self.monitor_thread = FleetMonitorThread(self.fleet,
                                                     fault_plan=fault_plan)
        else:
            self.fleet = None          # bound by ControlGroup.attach
            self.monitor_thread = None
        # capacity advice and (under control=True) capacity actuation
        # share this policy object — they cannot disagree
        self.buffer_policy = BufferPolicy(
            BufferAutotuner(current=scfg.queue_capacity))
        self.admission_policy = admission or AdmissionPolicy()
        self.gates: dict[str, AdmissionGate] = {
            c.name: AdmissionGate(c.mode or self.admission_policy.mode,
                                  name=c.name)
            for c in self.qos}
        self.gate = self.gates[self.class_names[0]]
        self.control = None
        self._actuator = _EngineActuator(self)
        if control:
            self.control = ControlLoop(
                self.fleet,
                PolicySet(buffer=self.buffer_policy,
                          admission=self.admission_policy),
                self._actuator, log=control_log)
            self._actuator.bind_log(self.control.log)
            # the loop's watchdog restarts a dead monitor thread (the
            # service — which holds every estimator's state — survives)
            self.control.watch_monitor(lambda: self.monitor_thread,
                                       self._restart_monitor)
        # -- accounting ------------------------------------------------------
        self._acct_lock = threading.Lock()
        self._lane_stats = {n: _LaneStats() for n in self.class_names}
        self.served = 0
        # -- bulkhead workers ------------------------------------------------
        self._stop = threading.Event()
        self._started = False
        self._scale_lock = threading.Lock()   # bulkhead membership
        self._degraded: set[str] = set()      # breaker-tripped classes
        self._spawn_seq = {n: 0 for n in self.class_names}
        self._bulkheads: dict[str, list[_ServeWorker]] = {
            n: [] for n in self.class_names}
        sizes = (scfg.bulkheads if scfg.bulkheads is not None
                 else tuple(1 for _ in self.qos))
        if len(sizes) != len(self.qos):
            raise ValueError(
                f"bulkheads {sizes} must match qos_classes "
                f"{tuple(self.class_names)}")
        with self._scale_lock:
            for name, n in zip(self.class_names, sizes):
                for _ in range(int(n)):
                    self._spawn_worker_locked(name)
        if model is not None:
            self._prefill = model.prefill
            self._decode = model.decode_step
        else:                           # model-free subclass / harness
            self._prefill = self._decode = None
        # observability knob (None/False/True/port/dict — see
        # obs.make_exporter): exposes this engine's fleet mirrors on
        # /metrics, labelled by QoS class.  An externally monitored
        # engine (monitor=False) is scraped through its ControlGroup's
        # exporter instead.
        if obs and self.fleet is None:
            raise ValueError(
                "obs= on a monitor=False engine has no mirrors to "
                "export — pass obs= to the owning ControlGroup")
        self.exporter = make_exporter(
            obs, service=self.fleet, loop=self.control,
            names=self.class_names,
            extra=lambda: {"repro_engine_breaker_open": {
                n: float(n in self._degraded) for n in self.class_names}})

    # ---------------- client API --------------------------------------------
    def submit(self, req: Request, timeout: float = 10.0) -> bool:
        """Enqueue one request on its class's lane.  Returns False when
        the lane is full past the timeout — or, with the control loop
        shedding the class, immediately (mode 'shed') / after waiting
        out a shut admission gate (mode 'defer').  One deadline covers
        both waits, and ``req.deadline_s`` (or the class default)
        tightens it: a deferring blocking caller waits at most its
        deadline, never the full timeout."""
        cls = self._cls.get(req.qos)
        if cls is None:
            raise KeyError(
                f"unknown QoS class {req.qos!r} — this engine serves "
                f"{self.class_names}")
        if req.deadline_s is None:
            req.deadline_s = cls.deadline_s
        budget = (timeout if req.deadline_s is None
                  else min(timeout, req.deadline_s))
        deadline = time.monotonic() + budget
        req.t_submit = time.monotonic()
        st = self._lane_stats[req.qos]
        lane = self.lanes[req.qos]
        with self._acct_lock:
            st.submitted += 1
        if not self.gates[req.qos].allow(budget):
            lane.head.record_error()   # shed / defer-timeout: SLO error
            return False
        ok = lane.push(
            req, timeout=max(deadline - time.monotonic(), 0.0))
        with self._acct_lock:
            if ok:
                st.admitted += 1
            else:
                st.queue_timeouts += 1
        if not ok:
            lane.head.record_error()
        return ok

    def start(self):
        if self.monitor_thread is not None:  # externally monitored else
            self.monitor_thread.start()
        if self.control is not None:
            self.control.start()
        if self.exporter is not None:
            self.exporter.start()
        with self._scale_lock:
            self._started = True
            for n in self.class_names:
                for w in self._bulkheads[n]:
                    if w.ident is None:
                        w.start()
        return self

    def stop(self):
        self._stop.set()
        # release every deferred admission waiter NOW — a shutdown
        # during defer-mode overload must not strand submit() callers
        # until their full timeout
        for g in self.gates.values():
            g.close()
        for w in self.workers():
            if w.ident is not None:
                w.join(timeout=30)
        if self.exporter is not None:
            self.exporter.stop()
        if self.control is not None:
            self.control.stop()
        if self.monitor_thread is not None:
            self.monitor_thread.stop()

    def _restart_monitor(self) -> FleetMonitorThread:
        """Watchdog restart path (mirrors ``Pipeline._restart_monitor``):
        fold any partially staged chunk, then hand the same service —
        and the same adaptive-period controller — to a fresh timer."""
        old = self.monitor_thread
        self.fleet.flush()
        m = FleetMonitorThread(self.fleet, period=old.period,
                               adapt_period=old.adapt_period,
                               min_sleep_s=old.min_sleep_s,
                               fault_plan=old.fault_plan)
        self.monitor_thread = m
        m.start()
        return m

    # ---------------- multi-tenant protocol ----------------------------------
    def control_tenant(self) -> tuple[list, "_EngineActuator"]:
        """The ``ControlGroup`` tenant protocol: the per-class lanes (in
        lane order) and this engine's actuator (resize + per-class
        admission gates + the class-aware sense operands)."""
        return [self.lanes[n] for n in self.class_names], self._actuator

    def _bind_external_monitor(self, view) -> None:
        if self.monitor_thread is None:
            self.fleet = view

    def bind_heartbeats(self, registry, host: Optional[str] = None) -> None:
        """A ``ReplicaSupervisor`` wires its ``HeartbeatRegistry`` here:
        each serve worker beats once per served batch, so a lapse means
        that worker died or wedged inside a generation round."""
        if host is not None:
            self.host = host
        self.heartbeats = registry
        registry.beat(self.host)
        for w in self.workers():
            registry.beat(w.host)

    def _require_fleet(self):
        if self.fleet is None:
            raise RuntimeError(
                "engine is externally monitored (monitor=False): "
                "attach it to a ControlGroup before reading rates")
        return self.fleet

    # ---------------- bulkhead management ------------------------------------
    def workers(self) -> list[_ServeWorker]:
        """Live worker threads across every bulkhead (the supervisor's
        poll surface — dead ones stay listed until respawned)."""
        with self._scale_lock:
            return [w for n in self.class_names
                    for w in self._bulkheads[n]]

    def worker_hosts(self) -> list[str]:
        return [w.host for w in self.workers()]

    def bulkhead_sizes(self) -> dict[str, int]:
        """Live (non-retired) worker count per class."""
        with self._scale_lock:
            return {n: sum(1 for w in self._bulkheads[n]
                           if not w.retire.is_set())
                    for n in self.class_names}

    def _spawn_worker_locked(self, qos_name: str) -> _ServeWorker:
        seq = self._spawn_seq[qos_name]
        self._spawn_seq[qos_name] = seq + 1
        w = _ServeWorker(self, qos_name, seq)
        self._bulkheads[qos_name].append(w)
        if self._started and not self._stop.is_set():
            w.start()
        hb = self.heartbeats
        if hb is not None:
            hb.beat(w.host)
        return w

    def scale_bulkhead(self, qos_name: str, n: int) -> bool:
        """Resize one class's worker partition (spawn or retire down to
        ``n`` live workers).  Retired workers finish their round and
        exit; they never migrate to another bulkhead."""
        if qos_name not in self._bulkheads:
            return False
        n = max(int(n), 0)
        with self._scale_lock:
            if self._stop.is_set():
                return False
            live = [w for w in self._bulkheads[qos_name]
                    if not w.retire.is_set() and w.crashed is None]
            for w in live[n:]:
                w.retire.set()
            for _ in range(n - len(live)):
                self._spawn_worker_locked(qos_name)
        return True

    def _retire_dead_worker(self, worker: _ServeWorker) -> bool:
        """Drop a dead worker from its partition WITHOUT a replacement
        (the supervisor's breaker verb — the slot is owed back when the
        class recovers)."""
        with self._scale_lock:
            ws = self._bulkheads.get(worker.qos)
            if ws is None or worker not in ws:
                return False
            worker.retire.set()
            ws.remove(worker)
        return True

    def _respawn_worker(self, worker: Optional[_ServeWorker] = None) -> bool:
        """Replace a dead serve worker inside its own bulkhead partition
        (the supervisor's respawn verb).  The no-arg legacy form scans
        every partition.  No-op for retired workers, degraded classes,
        workers that never started, or a stopping engine."""
        if worker is None:
            out = False
            for w in self.workers():
                if w.ident is not None and not w.is_alive():
                    out = self._respawn_worker(w) or out
            return out
        with self._scale_lock:
            if (self._stop.is_set() or worker.retire.is_set()
                    or worker.ident is None or worker.is_alive()):
                return False
            ws = self._bulkheads.get(worker.qos)
            if ws is None or worker not in ws:
                return False
            ws.remove(worker)
            if worker.qos in self._degraded:
                return False           # breaker holds the partition
            self._spawn_worker_locked(worker.qos)
        return True

    # ---------------- engine loop --------------------------------------------
    def _expired(self, r: Request) -> bool:
        """Drop a queued request whose deadline lapsed before a worker
        reached it — serving it would burn a blocking-lane round on an
        answer the caller already abandoned."""
        if r.deadline_s is None or r.t_submit <= 0.0:
            return False
        if time.monotonic() - r.t_submit <= r.deadline_s:
            return False
        r.done.set()                   # out stays None: caller sees it
        self.lanes[r.qos].head.record_error()   # deadline miss
        with self._acct_lock:
            self._lane_stats[r.qos].deadline_dropped += 1
        return True

    def _pick_lane(self, w: _ServeWorker) -> str:
        """One-way bounded borrowing.  A non-patient worker always
        serves home — its capacity is reserved.  A patient worker
        serves the hottest non-patient lane with backlog when that lane
        is hotter than home (or home is idle / already shedding), for
        at most ``borrow_streak`` consecutive rounds before paying one
        home round."""
        cls = self._cls[w.qos]
        if (not cls.patient or not self.scfg.borrow
                or not self._borrowable):
            return w.qos
        best, best_occ = None, -1.0
        for name in self._borrowable:
            if name == w.qos:
                continue
            q = self.lanes[name]
            occ = q.occupancy()
            if len(q) > 0 and occ > best_occ:
                best, best_occ = name, occ
        if best is None:
            w.streak = 0
            return w.qos
        home = self.lanes[w.qos]
        eligible = (best_occ > home.occupancy() or len(home) == 0
                    or self.gates[w.qos].shedding)
        if not eligible:
            w.streak = 0
            return w.qos
        if len(home) > 0 and w.streak >= self.scfg.borrow_streak:
            w.streak = 0               # bounded: pay one home round
            return w.qos
        w.streak += 1
        return best

    def _take_batch(self, lane: InstrumentedQueue,
                    w: Optional[_ServeWorker] = None) -> list[Request]:
        batch: list[Request] = []
        deadline = time.monotonic() + 20e-3
        while (len(batch) < self.scfg.batch_size
               and time.monotonic() < deadline):
            if self._stop.is_set() or (w is not None
                                       and w.retire.is_set()):
                break
            r = lane.try_pop()
            if r is None:
                if batch:
                    break
                time.sleep(1e-3)
                continue
            if self._expired(r):
                continue
            batch.append(r)
        return batch

    def _worker_loop(self, w: _ServeWorker):
        """Serve-worker run loop with crash containment: a generation
        round that raises (model bug, device OOM, injected fault) is
        recorded (``stats()['crashes']``), its requests are released
        with ``out=None`` so no client blocks forever, and the thread
        exits — a ``ReplicaSupervisor`` sees the dead worker and
        respawns it into the same bulkhead via ``_respawn_worker``.
        Inference mode is thread-local, so the loop enters it here."""
        with torch.inference_mode():
            self._serve_loop(w)

    def _serve_loop(self, w: _ServeWorker):
        while not (self._stop.is_set() or w.retire.is_set()):
            plan = self.fault_plan
            if plan is not None:
                try:
                    # injected crash raises; injected stall sleeps here.
                    # Aliases let one plan event target this worker, the
                    # whole engine, or its QoS bulkhead by class name.
                    plan.maybe_fault(w.host, aliases=(self.host, w.qos))
                except Exception as exc:
                    self._record_crash(exc, w)
                    return
            lane_name = self._pick_lane(w)
            batch = self._take_batch(self.lanes[lane_name], w)
            if not batch:
                continue
            reqs = list(batch)         # _serve_batch pads in place
            try:
                self._serve_batch(batch)
            except Exception as exc:
                self._record_crash(exc, w)
                self.lanes[lane_name].head.record_error(len(reqs))
                for r in reqs:
                    r.done.set()       # r.out stays None: caller sees it
                return
            self._finish_batch(lane_name, w, reqs)
            hb = self.heartbeats
            if hb is not None:
                hb.beat(w.host)
                hb.beat(self.host)

    def _finish_batch(self, lane_name: str, w: _ServeWorker,
                      reqs: list[Request]) -> None:
        now = time.monotonic()
        lats = []
        for r in reqs:
            if r.t_done == 0.0:
                r.t_done = now
            if r.t_submit > 0.0:
                lats.append(r.t_done - r.t_submit)
        w.items += len(reqs)
        if lane_name != w.qos:
            w.borrowed += 1
        with self._acct_lock:
            self._lane_stats[lane_name].served += len(reqs)
        if lats:
            # one batched fold into the lane's arena histogram row — the
            # single latency truth latency_stats(), the fleet collector
            # and the control loop's burn-rate leg all read
            self.lanes[lane_name].head.record_latency(np.asarray(lats))

    def _record_crash(self, exc: BaseException,
                      w: Optional[_ServeWorker] = None) -> None:
        if w is not None:
            w.crashed = exc
        with self._crash_lock:
            self._crashes.append({
                "stage": "engine",
                "worker": w.host if w is not None else self.host,
                "qos": w.qos if w is not None else None,
                "exc": repr(exc), "t": time.monotonic()})

    def _serve_batch(self, batch: list[Request]) -> None:
        B, S = self.scfg.batch_size, self.scfg.max_seq
        dev = self.device
        # right-pad the round to B with copies (masked out on return)
        live = len(batch)
        while len(batch) < B:
            batch.append(batch[-1])
        plens = np.array([min(len(r.tokens), S - r.max_new)
                          for r in batch], np.int32)
        L = int(plens.max())
        toks = np.zeros((B, L), np.int32)
        for i, r in enumerate(batch):
            toks[i, :plens[i]] = r.tokens[:plens[i]]
        logits, cache = self._prefill(
            self.params, {"tokens": torch.as_tensor(toks, device=dev)})

        # pad cache seq dim to S for decoding
        def pad_seq(v):
            if v.dim() >= 3 and v.shape[2] == L:
                out = v.new_zeros(v.shape[:2] + (S,) + v.shape[3:])
                out[:, :, :L] = v
                return out
            return v
        cache = {n: pad_seq(v) for n, v in cache.items()}
        # the first token from the last position of the padded round
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        pos = torch.as_tensor(plens, device=dev)
        outs = [[] for _ in range(B)]
        max_new = max(r.max_new for r in batch[:live])
        for _ in range(max_new):
            host = next_tok.cpu().numpy()
            for i in range(live):
                outs[i].append(int(host[i]))
            next_tok, cache = self._decode(self.params, cache, next_tok,
                                           pos)
            pos = pos + 1
        for i in range(live):
            r = batch[i]
            r.out = np.array(outs[i][:r.max_new], np.int32)
            r.done.set()
            self.served += 1

    # ---------------- monitor-driven tuning ---------------------------------
    def recommended_queue_capacity(self) -> int:
        """Analytic capacity advice for the primary lane, delegated to
        the same ``BufferPolicy`` a ``control=True`` engine's loop
        actuates — advice and actuation share one implementation.
        Unobservable rates (pre-convergence gate) keep the current
        capacity.  ``recommended_queue_capacities()`` is the per-class
        form."""
        return self.recommended_queue_capacities()[self.class_names[0]]

    def recommended_queue_capacities(self) -> dict[str, int]:
        fleet = self._require_fleet()
        lam = fleet.arrival_rates()
        mu = fleet.service_rates()
        current = [self.lanes[n].capacity for n in self.class_names]
        targets = self.buffer_policy.targets(lam, mu, current=current)
        return {n: int(t) for n, t in zip(self.class_names, targets)}

    def class_rates(self) -> dict[str, dict[str, float]]:
        """Per-class gated λ/μ — the same one-gather fleet estimate,
        read out per lane."""
        fleet = self._require_fleet()
        lam = fleet.arrival_rates()
        mu = fleet.service_rates()
        return {n: {"lam": float(lam[i]), "mu": float(mu[i])}
                for i, n in enumerate(self.class_names)}

    def lane_slots(self) -> dict[str, tuple[int, int]]:
        """Per-class (head, tail) arena slots — contiguous per lane and
        across the engine's block by construction (``reserve_span``)."""
        return {n: (self.lanes[n].head.slot, self.lanes[n].tail.slot)
                for n in self.class_names}

    def latency_stats(self) -> dict[str, dict[str, float]]:
        """Per-class submit-to-done latency percentiles (empty classes
        read 0).  Reads the lane head-slot histogram rows in the shared
        counter arena — the same columns the fleet collector harvests
        and the control loop's burn-rate leg consumes — so serve and
        control report one latency truth.  Percentiles interpolate
        within log-spaced buckets (cumulative since engine start)."""
        out = {}
        for n in self.class_names:
            hist = self.lanes[n].head.latency_histogram()
            tot = int(hist.sum())
            if tot:
                q = hist_quantiles(hist[None, :].astype(np.int64),
                                   (0.5, 0.99))[0]
                out[n] = {"n": tot, "p50": float(q[0]),
                          "p99": float(q[1])}
            else:
                out[n] = {"n": 0, "p50": 0.0, "p99": 0.0}
        return out

    def admission_state(self) -> dict:
        """Gate readout: engine-level shedding flag + total counters
        (compat), plus the per-class breakdown that makes a shed
        distinguishable from a defer timeout or a queue timeout."""
        classes = {}
        for n in self.class_names:
            g = self.gates[n]
            st = self._lane_stats[n]
            classes[n] = {
                "shedding": g.shedding, "mode": g.mode,
                "shed": g.shed_count, "deferred": g.defer_count,
                "defer_timeouts": g.defer_timeout_count,
                "stop_released": g.stop_released,
                "queue_timeouts": st.queue_timeouts,
                "deadline_dropped": st.deadline_dropped,
                "submitted": st.submitted, "admitted": st.admitted,
                "served": st.served}
        gates = [self.gates[n] for n in self.class_names]
        return {"shedding": any(g.shedding for g in gates),
                "mode": self.gate.mode,
                "shed_count": sum(g.shed_count for g in gates),
                "defer_count": sum(g.defer_count for g in gates),
                "classes": classes}

    def stats(self) -> dict:
        """Health readout: served count, contained serve-loop crashes
        (stage/worker/qos/exc/timestamp), per-bulkhead liveness, and
        the per-class admission breakdown."""
        with self._crash_lock:
            crashes = list(self._crashes)
        workers = self.workers()
        return {"served": self.served,
                "crashes": crashes,
                "crash_count": len(crashes),
                "worker_alive": any(w.is_alive() for w in workers),
                "bulkheads": self.bulkhead_sizes(),
                "degraded": sorted(self._degraded),
                "admission": self.admission_state()}

    def service_rate(self) -> float:
        """Aggregate requests/s across every lane from the fleet state,
        readiness-gated: 0 until the estimates have either converged or
        accumulated ``min_q_samples`` q-folds — never a raw
        partial-window sample."""
        return float(np.sum(self._require_fleet().service_rates()))
