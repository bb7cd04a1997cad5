"""Streaming pipeline graph: RaftLib-style kernels connected by
InstrumentedQueues, each kernel on its own thread, and the run-time
controllers closing the loop.

Monitoring is the fleet path: every link's head and tail ride one
``FleetMonitorService`` — a single timer thread collects all counters
into one staging tile and the whole pipeline's Algorithm-1 state
advances in **one** fused dispatch per ``chunk_t`` ticks.  The control
plane is vectorized to match: buffer autotuning and replica
recommendations consume the (Q,) fleet estimate arrays directly instead
of one scalar callback per queue.

With ``control=True`` the loop is *closed*: a ``control``
``ControlLoop`` evaluates the replica/buffer policies against the gated
fleet estimates once per fused dispatch and actuates them live —
``scale_stage`` spawns or retires stage workers while items flow
(retiring workers finish their in-flight item and exit; queued items
stay for the surviving siblings, so nothing is lost), and queue
capacities are re-sized through the same hysteresis the advisory path
reports.  ``recommended_replicas()`` delegates to the *same* policy
object the loop actuates, so advice and actuation cannot disagree.

The port of the JAX package's ``repro.streams.pipeline``.  The fleet
service's estimator state and the loop's decision live on ``device``
(the card by default; ``device="cpu"`` for the host).  ``fault_plan``
and ``supervisor`` stay duck-typed hooks.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np

from repro_torch.core.controller import (BufferAutotuner,
                                         ParallelismController)
from repro_torch.core.monitor import MonitorConfig
from repro_torch.streams.arena import CounterArena, default_arena
from repro_torch.streams.fleet import FleetMonitorService
from repro_torch.streams.monitor_thread import FleetMonitorThread
from repro_torch.streams.queue import InstrumentedQueue, _EMPTY

__all__ = ["Stage", "Pipeline", "STOP"]

STOP = object()   # sentinel flowing through the pipe at end-of-stream


class Stage:
    """A compute kernel: ``fn(item) -> item | None`` (None = filtered).
    Source stages take ``fn=None`` and an ``source`` iterable."""

    def __init__(self, name: str, fn: Optional[Callable] = None,
                 source: Optional[Iterable] = None, replicas: int = 1):
        assert (fn is None) != (source is None)
        self.name = name
        self.fn = fn
        self.source = source
        self.replicas = replicas
        self.processed = 0
        self._stop_left = replicas
        self._stop_seen = False
        self._stop_lock = threading.Lock()
        self._spawn_seq = 0          # host-id counter for replica spawns


class _Worker(threading.Thread):
    """One replica of a stage.  ``retire.set()`` asks the worker to exit
    between items: the in-flight item always completes and queued items
    stay for the surviving siblings — scale-down never drops work.

    The run loop is crash-contained: a raise (a user kernel bug, or an
    injected ``FaultPlan`` crash) records the crash on the pipeline —
    stage, worker host id, exception, timestamp — surrenders the STOP
    count coherently and, when a ``ReplicaSupervisor`` is attached,
    kicks it for immediate respawn.  A daemon thread must never die
    with the replica count silently wrong and μ frozen at a stale value
    the policy then trusts forever."""

    def __init__(self, stage: Stage, in_q, out_q, *, host: str = "",
                 beat: Optional[Callable] = None, fault=None,
                 on_crash: Optional[Callable] = None):
        super().__init__(daemon=True, name=f"repro-{stage.name}")
        self.stage, self.in_q, self.out_q = stage, in_q, out_q
        self.retire = threading.Event()
        self.host = host or stage.name
        self.beat = beat             # heartbeat hook (supervisor-owned)
        self.fault = fault           # FaultPlan (duck-typed), or None
        self.on_crash = on_crash
        self.items = 0               # items drained by THIS replica
        self.crashed: Optional[BaseException] = None
        self.handled = False         # supervisor consumed the crash
        self._done = False           # exited (any path)

    def _exit_retired(self) -> None:
        """Leave the stage's STOP countdown coherent: a retired worker
        will never pop the STOP it was counted for.  If STOP was already
        in flight and we are the last worker out, forward it downstream
        — the re-pushed token in our in-queue has no consumer left."""
        st = self.stage
        with st._stop_lock:
            st._stop_left -= 1
            last = st._stop_left == 0 and st._stop_seen
        if last and self.out_q is not None:
            self.out_q.push(STOP)

    def _exit_crashed(self, exc: BaseException) -> None:
        """Crash containment: record, then leave coherently.  A dead
        source ends the stream (STOP flows); a dead consumer surrenders
        its STOP count exactly like a retire — the countdown must not
        wait forever on a thread that no longer exists."""
        self.crashed = exc
        self._done = True
        if self.stage.source is not None:
            if self.out_q is not None:
                self.out_q.push(STOP)
        else:
            self._exit_retired()
        cb = self.on_crash
        if cb is not None:
            cb(self, exc)

    def run(self):
        try:
            self._run()
        except Exception as exc:   # noqa: BLE001 — crash containment
            self._exit_crashed(exc)
        finally:
            self._done = True

    def _run(self):
        st = self.stage
        plan = self.fault
        beat = self.beat
        if st.source is not None:
            for item in st.source:
                if plan is not None:
                    plan.maybe_fault(self.host, (st.name,))
                if beat is not None:
                    beat()
                self.out_q.push(item)
            self.out_q.push(STOP)
            return
        backoff = 1e-6
        while True:
            if self.retire.is_set():
                self._exit_retired()
                return
            # non-blocking pop + backoff (instead of a blocking pop) so
            # a retire request is honored within ~1 ms even when idle
            item = self.in_q.try_pop(_EMPTY)
            if item is _EMPTY:
                if beat is not None:
                    beat()         # an idle replica is alive, not dead
                time.sleep(backoff)
                backoff = min(backoff * 2, 1e-3)
                continue
            backoff = 1e-6
            if item is STOP:
                # countdown: only the LAST replica forwards STOP downstream
                with st._stop_lock:
                    st._stop_seen = True
                    st._stop_left -= 1
                    last = st._stop_left == 0
                if not last:
                    self.in_q.push(STOP)   # wake sibling replicas
                elif self.out_q is not None:
                    self.out_q.push(STOP)
                return
            if plan is not None:
                plan.maybe_fault(self.host, (st.name,))
            out = st.fn(item)
            st.processed += 1
            self.items += 1
            if beat is not None:
                beat()             # one beat per drained item
            if out is not None and self.out_q is not None:
                self.out_q.push(out)


class _PipelineActuator:
    """The ``ControlLoop`` adapter: queue index -> consumer stage.  All
    methods return an outcome string the loop records in its
    ``ControlLog`` (``'applied'`` | ``'rejected'`` | ``'noop'``)."""

    def __init__(self, pipe: "Pipeline"):
        self.pipe = pipe

    def replicas(self) -> np.ndarray:
        return self.pipe._live_replica_array()

    def scalable(self) -> np.ndarray:
        p = self.pipe
        return np.array([i + 1 < len(p.stages) for i in
                         range(len(p.queues))], bool)

    def capacities(self) -> np.ndarray:
        return np.array([q.capacity for q in self.pipe.queues], np.int64)

    def occupancy(self) -> np.ndarray:
        return np.array([len(q) / max(q.capacity, 1)
                         for q in self.pipe.queues])

    def faulty(self) -> np.ndarray:
        """(Q,) degraded-consumer mask (crash-loop breaker tripped):
        the fused decision forces a faulty queue's admission gate shut
        and holds its replica/buffer legs — partial failure degrades
        gracefully instead of the formula spiraling on garbage
        estimates."""
        p = self.pipe
        if not p._degraded:
            return np.zeros(len(p.queues), bool)
        return np.array(
            [(p.stages[i + 1].name in p._degraded)
             if i + 1 < len(p.stages) else False
             for i in range(len(p.queues))], bool)

    def scale(self, i: int, n: int) -> str:
        if i + 1 >= len(self.pipe.stages):
            return "noop"          # the sink drainer is not a stage
        return self.pipe.scale_stage(i + 1, n)

    def resize(self, i: int, cap: int) -> str:
        p = self.pipe
        ok = p.queues[i].resize(int(cap))
        p._capacities[i] = p.queues[i].capacity
        return "applied" if ok else "rejected"

    def admit(self, i: int, shed: bool) -> str:
        return "noop"              # pipelines shed at the source, not here


class Pipeline:
    """Linear pipeline with fleet monitoring + optional closed-loop
    elastic actuation.

    >>> pipe = Pipeline([Stage("src", source=range(1000)),
    ...                  Stage("work", fn=lambda x: x * 2)],
    ...                 capacity=64)
    >>> results = pipe.run_collect()

    ``autotune=True`` keeps the advisory-callback resizing;
    ``control=True`` runs the full ``control`` loop (replica +
    buffer policies, hysteresis/cooldown, decision audit in
    ``pipe.control.log``) and supersedes ``autotune`` — exactly one
    party may own actuation.

    ``monitor=False`` builds the pipeline *externally monitored*: no
    per-pipeline service or monitor thread is created — attach the
    pipeline (built on the shared ``arena``) to a
    ``control.ControlGroup``, which owns one monitor + control
    loop for every tenant and binds a sliced fleet view back here so
    ``rates()`` / ``recommended_replicas()`` keep working.
    """

    def __init__(self, stages: list[Stage], capacity: int = 64,
                 item_bytes: int = 8,
                 monitor_cfg: Optional[MonitorConfig] = None,
                 base_period_s: float = 1e-3,
                 autotune: bool = False, chunk_t: int = 32,
                 arena: Optional[CounterArena] = None,
                 control: bool = False,
                 policies: Optional[PolicySet] = None,
                 control_log: Optional[ControlLog] = None,
                 monitor: bool = True,
                 fault_plan=None,
                 obs=None, device="cuda"):
        self.stages = stages
        self.queues: list[InstrumentedQueue] = []
        self.sink: list[Any] = []
        self._sink_lock = threading.Lock()
        # self-healing state: crash records (satellite: daemon workers
        # must never vanish silently), the degraded-stage set the
        # actuator reports as `faulty`, and the optional supervisor /
        # fault plan hooks (both pay nothing when absent)
        self.fault_plan = fault_plan
        self.supervisor = None         # set by ReplicaSupervisor(pipe)
        self._crashes: list[dict] = []
        self._crash_lock = threading.Lock()
        self._degraded: set[str] = set()
        # every link's counters back into one arena, so the collector
        # samples the whole pipeline in one vectorized gather
        self.arena = arena if arena is not None else default_arena()

        for i in range(len(stages)):
            q = InstrumentedQueue(capacity, item_bytes,
                                  name=f"{stages[i].name}->"
                                       f"{stages[i+1].name if i+1 < len(stages) else 'sink'}",
                                  arena=self.arena)
            self.queues.append(q)

        if not monitor and (control or policies is not None or autotune):
            raise ValueError(
                "monitor=False hands monitoring AND control to a "
                "ControlGroup — control/policies/autotune must stay off")
        # one fleet service monitors every link's head AND tail: one
        # collector pass and one fused dispatch per tick for the whole
        # pipeline, convergence delivered as (indices, rates) batches.
        # Externally-monitored pipelines (monitor=False) get these from
        # the ControlGroup they attach to.
        if monitor:
            self.fleet = FleetMonitorService(
                self.queues, monitor_cfg, period_s=base_period_s,
                chunk_t=chunk_t, ends="both", on_fleet=self._on_fleet,
                device=device)
            self.monitor = FleetMonitorThread(self.fleet,
                                              fault_plan=fault_plan)
        else:
            self.fleet = None          # bound by ControlGroup.attach
            self.monitor = None
        self.tuner = BufferAutotuner(current=capacity)
        self._capacities = np.full(len(self.queues), capacity, np.int64)
        self.parallelism = ParallelismController()
        # control-plane wiring is the one sanctioned layering inversion
        # (control.group imports streams.fleet, so a module-level import
        # here would be a cycle): the pipeline *constructs* its own loop
        # but the streams layer never depends on control at import time
        # layer-ok: wiring inversion, constructor-only; keeps module DAG acyclic
        from repro_torch.control import (BufferPolicy, ControlLoop,
                                         PolicySet, ReplicaPolicy)
        # the advisory readouts and the control loop share these policy
        # objects — recommended_replicas() can never disagree with what
        # scale_stage is asked to apply
        self.replica_policy = ReplicaPolicy(self.parallelism)
        self.buffer_policy = BufferPolicy(self.tuner)
        self._workers: list[list[_Worker]] = []
        self._started = False
        self._scale_lock = threading.Lock()
        self.control: Optional[ControlLoop] = None
        if (control or policies is not None) and monitor:
            self.policies = policies if policies is not None else PolicySet(
                replica=self.replica_policy, buffer=self.buffer_policy)
            self.control = ControlLoop(self.fleet, self.policies,
                                       _PipelineActuator(self),
                                       log=control_log)
            # the loop's watchdog restarts a dead monitor thread; the
            # service (which holds all estimator state) survives it
            self.control.watch_monitor(lambda: self.monitor,
                                       self._restart_monitor)
            autotune = False       # the loop owns actuation
        self.autotune = autotune
        # observability knob (None/False/True/port/dict — see
        # obs.make_exporter): /metrics over this pipeline's fleet
        # mirrors (and loop, when control=True), one queue label per
        # link.  Externally monitored pipelines are scraped through
        # their ControlGroup's exporter.
        # layer-ok: obs is a dependency-free leaf; imported lazily so a
        # broken exporter can never take the data plane down with it
        from repro_torch.obs import make_exporter
        if obs and self.fleet is None:
            raise ValueError(
                "obs= on a monitor=False pipeline has no mirrors to "
                "export — pass obs= to the owning ControlGroup")
        self.exporter = make_exporter(
            obs, service=self.fleet, loop=self.control,
            names=[q.name for q in self.queues])

    def _on_fleet(self, idx: np.ndarray, rates: np.ndarray) -> None:
        """Batched convergence callback (legacy advisory autotuning):
        one vectorized control-plane evaluation re-sizes every queue
        whose converged rates moved the recommendation outside the
        hysteresis band — now through the tuner's actuator form, which
        applies ``resize()`` itself and honors rejected shrinks."""
        if not self.autotune:
            return
        lam = self.fleet.arrival_rates()
        mu = self.fleet.service_rates()
        self._capacities, _, _ = self.tuner.actuate_fleet(
            self.queues, lam, mu, self._capacities,
            cv2=self.fleet.cv2s())

    # multi-tenant protocol --------------------------------------------------
    def control_tenant(self) -> tuple[list, "_PipelineActuator"]:
        """The ``ControlGroup`` tenant protocol: this pipeline's
        monitored queues (in public order) and its actuator adapter."""
        return self.queues, _PipelineActuator(self)

    def _bind_external_monitor(self, view) -> None:
        """Called by ``ControlGroup`` attach/detach: a sliced fleet
        view serving this pipeline's advisory readouts (None on
        detach).  Only meaningful for ``monitor=False`` pipelines."""
        if self.monitor is None:
            self.fleet = view

    def _require_fleet(self):
        if self.fleet is None:
            raise RuntimeError(
                "pipeline is externally monitored (monitor=False): "
                "attach it to a ControlGroup before reading rates")
        return self.fleet

    # elastic actuation ------------------------------------------------------
    def _live_replica_array(self) -> np.ndarray:
        """(Q,) live replicas of each queue's consumer (the sink drain
        counts as 1) — the one expression both the actuator's sense
        input and the advisory readout normalize by."""
        return np.array(
            [self.live_replicas(i + 1) if i + 1 < len(self.stages) else 1
             for i in range(len(self.queues))], np.int64)

    def live_replicas(self, stage: int | str) -> int:
        """Current live (non-retiring, non-crashed) worker count of one
        stage.  A crashed worker is NOT live: before this fix a dead
        daemon thread kept counting, so the control loop normalized μ
        by a replica count that no longer existed."""
        idx = self._stage_index(stage)
        with self._scale_lock:
            if not self._started:
                return self.stages[idx].replicas
            return len([w for w in self._workers[idx]
                        if not w.retire.is_set() and w.crashed is None])

    def _stage_index(self, stage: int | str) -> int:
        if isinstance(stage, int):
            return stage
        for i, st in enumerate(self.stages):
            if st.name == stage:
                return i
        raise KeyError(stage)

    def scale_stage(self, stage: int | str, n: int) -> str:
        """Live replica actuation: spawn or retire workers of one stage
        while items flow.  Returns ``'applied'``, ``'noop'`` (already at
        n) or ``'rejected'`` (source stages, n < 1, or the stage already
        saw STOP — a late spawn would hang on a drained queue).

        Retired workers finish their in-flight item and exit between
        items; queued items remain for the surviving replicas, so
        scale-down never loses work.  Before ``run_collect`` starts the
        workers this just re-sets the stage's initial replica count."""
        idx = self._stage_index(stage)
        st = self.stages[idx]
        n = int(n)
        if st.source is not None or idx == 0 or n < 1:
            return "rejected"
        with self._scale_lock:
            if not self._started:
                if n == st.replicas:
                    return "noop"
                st.replicas = n
                st._stop_left = n
                return "applied"
            ws = self._workers[idx]
            live = [w for w in ws
                    if not w.retire.is_set() and w.crashed is None]
            cur = len(live)
            if n == cur:
                return "noop"
            if n > cur:
                # the STOP countdown and the spawn must agree on the
                # live-worker count, so both move under the stop lock
                with st._stop_lock:
                    if st._stop_seen:
                        return "rejected"
                    st._stop_left += n - cur
                    st.replicas = n
                new = [self._make_worker(st, self.queues[idx - 1],
                                         self.queues[idx])
                       for _ in range(n - cur)]
                ws.extend(new)
                for w in new:
                    w.start()
            else:
                for w in live[n:]:
                    w.retire.set()
                ws[:] = [w for w in ws if not w.retire.is_set()]
                with st._stop_lock:
                    st.replicas = n
            return "applied"

    def _make_worker(self, st: Stage, in_q, out_q) -> _Worker:
        """Build one worker with its self-healing hooks: a host id, the
        supervisor's heartbeat callable (None when unsupervised), the
        fault plan (None when not injecting), and the crash recorder.
        Callers hold ``_scale_lock`` (the spawn-seq counter rides it)."""
        st._spawn_seq += 1
        host = f"{st.name}#{st._spawn_seq}"
        sup = self.supervisor
        beat = sup.register(host) if sup is not None else None
        return _Worker(st, in_q, out_q, host=host, beat=beat,
                       fault=self.fault_plan, on_crash=self._record_crash)

    def _record_crash(self, worker: _Worker, exc: BaseException) -> None:
        """Crash containment sink (called from the dying worker): the
        crash is recorded — stage, worker host, exception, timestamp —
        and surfaced via ``stats()`` instead of silently vanishing; an
        attached supervisor is kicked for immediate respawn."""
        rec = {"stage": worker.stage.name, "worker": worker.host,
               "exc": repr(exc), "t": time.monotonic()}
        with self._crash_lock:
            self._crashes.append(rec)
        sup = self.supervisor
        if sup is not None:
            sup.kick()

    def _retire_worker(self, idx: int, worker: _Worker) -> None:
        """Retire one (dead or wedged) worker without a replacement:
        the zombie slot leaves the live set, so the replica array the
        control loop senses reflects reality."""
        worker.retire.set()
        with self._scale_lock:
            ws = self._workers[idx]
            if worker in ws:
                ws.remove(worker)

    def _respawn_worker(self, idx: int,
                        dead: Optional[_Worker] = None
                        ) -> Optional[_Worker]:
        """Replace one crashed/wedged worker (the supervisor's respawn
        path).  A crashed worker already surrendered its STOP count in
        its crash path (a wedged one surrenders when it unsticks); the
        replacement takes a fresh count — refused once STOP is in
        flight, exactly like a late scale-up."""
        st = self.stages[idx]
        with self._scale_lock:
            if not self._started or st.source is not None or idx == 0:
                return None
            ws = self._workers[idx]
            if dead is not None:
                dead.retire.set()
                if dead in ws:
                    ws.remove(dead)
            with st._stop_lock:
                if st._stop_seen:
                    return None
                st._stop_left += 1
            w = self._make_worker(st, self.queues[idx - 1],
                                  self.queues[idx])
            ws.append(w)
            w.start()
            return w

    def _restart_monitor(self) -> FleetMonitorThread:
        """Watchdog restart path (invoked by ``ControlLoop`` when the
        monitor thread died unannounced).  The service — which holds
        ALL estimator state — survives the dead timer thread: fold any
        partially staged chunk, then hand the same service (and the
        same adaptive-period controller) to a fresh timer."""
        old = self.monitor
        self.fleet.flush()
        m = FleetMonitorThread(self.fleet, period=old.period,
                               adapt_period=old.adapt_period,
                               min_sleep_s=old.min_sleep_s,
                               fault_plan=old.fault_plan)
        self.monitor = m
        m.start()
        return m

    def run_collect(self, timeout_s: float = 300.0) -> list:
        with self._scale_lock:
            self._workers = []
            for i, st in enumerate(self.stages):
                in_q = self.queues[i - 1] if i > 0 else None
                out_q = self.queues[i]
                st._stop_left = st.replicas
                st._stop_seen = False
                self._workers.append(
                    [self._make_worker(st, in_q, out_q)
                     for _ in range(st.replicas)])
            self._started = True

        def drain():
            q = self.queues[-1]
            while True:
                item = q.pop()
                if item is STOP:
                    return
                with self._sink_lock:
                    self.sink.append(item)

        drainer = threading.Thread(target=drain, daemon=True)
        if self.monitor is not None:   # externally monitored otherwise
            self.monitor.start()
        if self.control is not None:
            self.control.start()
        if self.exporter is not None:
            self.exporter.start()
        with self._scale_lock:
            workers = [w for ws in self._workers for w in ws]
        for w in workers:
            w.start()
        drainer.start()
        drainer.join(timeout_s)
        if self.exporter is not None:
            self.exporter.stop()
        if self.control is not None:
            self.control.stop()
        if self.monitor is not None:
            self.monitor.stop()        # joins, then flushes the chunk
        return self.sink

    # observability ----------------------------------------------------------
    def stats(self) -> dict:
        """Health snapshot: every recorded worker crash (stage, worker
        host, exception, timestamp), per-stage processed counts and
        live replicas, and the degraded-stage set.  The crash list is
        the satellite fix for silently-vanishing daemon workers — a
        pipeline whose replica died now *says so* here."""
        with self._crash_lock:
            crashes = list(self._crashes)
        return {
            "crashes": crashes,
            "crash_count": len(crashes),
            "degraded_stages": sorted(self._degraded),
            "processed": {st.name: st.processed for st in self.stages},
            "live_replicas": {st.name: self.live_replicas(i)
                              for i, st in enumerate(self.stages)},
        }

    def rates(self) -> dict:
        """Per-link readout from the fleet state.  Rates carry the
        Welford-count readiness gate: a link that has not converged and
        has not accumulated ``min_q_samples`` q-folds reports 0 rather
        than a raw partial-window sample."""
        fleet = self._require_fleet()
        mu = fleet.service_rates()
        lam = fleet.arrival_rates()
        eps = fleet.epochs()[:len(self.queues)]
        blk = fleet.observed_blocking_fraction()
        out = {}
        for i, q in enumerate(self.queues):
            out[q.name] = {
                "service_rate": float(mu[i]),
                "arrival_rate": float(lam[i]),
                "epochs": int(eps[i]),
                "T": fleet.period_s,
                "blocking_frac": float(blk[i]),
                "capacity": q.capacity,
            }
        return out

    def recommended_replicas(self) -> dict:
        """Vectorized duplication decision (Gordon et al., Li et al.):
        ceil(headroom * offered load / stage service rate) for every
        consumer stage in one fleet evaluation.  Delegates to the same
        ``ReplicaPolicy`` the control loop actuates — the advice here
        IS the target a ``control=True`` pipeline converges to."""
        fleet = self._require_fleet()
        lam = fleet.arrival_rates()
        mu = fleet.service_rates()
        reps = self.replica_policy.targets(
            lam, mu, replicas=self._live_replica_array())
        return {self.stages[i + 1].name: int(reps[i])
                for i in range(len(self.stages) - 1)}
