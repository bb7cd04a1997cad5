"""Replica supervision: heartbeats, dead/stalled detection, respawn.

This wires the (previously standalone) ``ft.HeartbeatRegistry`` and
``HostRateTracker`` into the streams stack.  Every pipeline stage
replica is a *host* in the paper's sense — its item stream is a queue
the monitor can instrument — so the two failure signatures from
``ft.failures`` apply directly:

* **dead** — the replica's heartbeat lapsed (it beats once per drained
  item and once per idle backoff sleep, so a lapse means the thread is
  gone or wedged inside a kernel), or the worker's run loop crashed
  (recorded by the pipeline's crash containment and kicked over here);
* **stalled** — the replica's converged item rate phase-changed
  downward (``ft/failures.py``: "a host whose converged service rate
  drops is a straggler") while its input queue still holds work.

A dead or stalled replica's zombie slot is retired through the
pipeline's normal scale machinery (the STOP countdown and the live
replica array the control loop senses stay coherent) and a replacement
is spawned under **capped exponential backoff**; a stage that crash-
loops past ``breaker_threshold`` consecutive deaths trips the breaker
and is marked *degraded* — the supervisor stops feeding it replicas,
the pipeline's actuator reports the stage's queue ``faulty`` to the
control loop, and the fused decision forces its admission gate shut
and holds its replica/buffer legs (see ``control.policy``).

Everything the supervisor does lands in a ``ControlLog`` (share the
control loop's ring to interleave with actuation records): detection
(``crash``/``dead``/``stall``), respawn with its backoff, breaker
trips (``degraded``) and recovery — the full audit the chaos benchmark
asserts on.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

from repro_torch.control.log import ControlLog, ControlRecord
from repro_torch.ft.failures import HeartbeatRegistry, HostRateTracker

__all__ = ["ReplicaSupervisor"]


@dataclasses.dataclass
class _StageHealth:
    """Per-stage crash-loop state."""
    consecutive: int = 0         # deaths without an intervening healthy window
    backoff_s: float = 0.0       # next respawn delay (0 = immediate)
    next_ok_t: float = 0.0       # monotonic time respawn is allowed again
    last_death_t: float = 0.0
    pending: int = 0             # respawns owed once the backoff expires
    degraded: bool = False


@dataclasses.dataclass
class _BulkheadHealth:
    """Per-(engine, QoS class) crash-loop state — one engine bulkhead
    is the engine-side analog of one pipeline stage."""
    consecutive: int = 0
    last_death_t: float = 0.0
    degraded: bool = False
    lost: int = 0                # workers retired while the breaker held


class ReplicaSupervisor(threading.Thread):
    """Supervise one pipeline's stage replicas (and, optionally, engine
    worker loops).

    >>> pipe = Pipeline(stages, ...)
    >>> sup = ReplicaSupervisor(pipe).start()   # before run_collect
    >>> ...
    >>> sup.stop()

    Construct *before* ``run_collect`` so workers are spawned with
    their heartbeat hooks.  ``stop()`` forgets every host it registered
    (retired replicas must not linger in ``dead_hosts()`` forever).
    """

    def __init__(self, pipe=None, *, engines=(),
                 log: Optional[ControlLog] = None,
                 registry: Optional[HeartbeatRegistry] = None,
                 heartbeat_timeout_s: float = 0.25,
                 poll_s: float = 0.02,
                 backoff_base_s: float = 0.02,
                 backoff_cap_s: float = 1.0,
                 breaker_threshold: int = 5,
                 healthy_after_s: float = 1.0):
        super().__init__(daemon=True, name="repro-supervisor")
        self.pipe = pipe
        self.engines = list(engines)
        self.heartbeats = registry or HeartbeatRegistry(heartbeat_timeout_s)
        self.rates = HostRateTracker()
        # share the control loop's ring when the pipeline has one, so
        # supervision interleaves with actuation in one audit stream
        self.log = log if log is not None else (
            pipe.control.log if pipe is not None
            and getattr(pipe, "control", None) is not None
            else ControlLog())
        self.poll_s = poll_s
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.breaker_threshold = breaker_threshold
        self.healthy_after_s = healthy_after_s
        self.respawns = 0
        self.breaker_trips = 0
        self._health: dict[int, _StageHealth] = {}
        # per-(engine index, QoS class) bulkhead crash-loop state
        self._eng_health: dict[tuple[int, str], _BulkheadHealth] = {}
        self._hosts: set[str] = set()       # every host ever registered
        self._items_seen: dict[str, int] = {}
        self._last_poll_t = time.monotonic()
        self._kick_evt = threading.Event()  # crash fast-path wakeup
        self._stop_evt = threading.Event()
        if pipe is not None:
            pipe.supervisor = self          # workers pick up beat hooks
        for eng in self.engines:
            if hasattr(eng, "bind_heartbeats"):
                eng.bind_heartbeats(self.heartbeats)
                self._hosts.add(eng.host)
                if hasattr(eng, "worker_hosts"):
                    self._hosts.update(eng.worker_hosts())

    # -- hooks the pipeline's workers call ---------------------------------
    def register(self, host: str):
        """Called at worker spawn: returns the worker's beat callable."""
        self._hosts.add(host)
        hb = self.heartbeats
        hb.beat(host)
        return lambda: hb.beat(host)

    def kick(self) -> None:
        """Crash notification fast path (from the pipeline's crash
        recorder): wake the poll loop now instead of next period."""
        self._kick_evt.set()

    # -- audit -------------------------------------------------------------
    def _record(self, stage_idx: int, action: str, value: int,
                outcome: str, error: str = "", qos: str = "") -> None:
        self.log.append(ControlRecord(
            tick=0, t=time.monotonic(), queue=int(stage_idx),
            policy="supervisor", observed_lam=0.0, observed_mu=0.0,
            action=action, value=int(value), outcome=outcome,
            error=error, qos=qos))

    def degraded(self) -> list[str]:
        """Names of breaker-tripped stages."""
        if self.pipe is None:
            return []
        return sorted(self.pipe.stages[i].name
                      for i, h in self._health.items() if h.degraded)

    def forget_tenant(self) -> None:
        """Forget every host this supervisor registered (tenant
        detach / shutdown): they must not pollute ``dead_hosts()``."""
        for host in list(self._hosts):
            self.heartbeats.forget(host)

    # -- detection + respawn ----------------------------------------------
    def _respawn(self, idx: int, worker, now: float, why: str,
                 error: str) -> None:
        pipe = self.pipe
        st = pipe.stages[idx]
        h = self._health.setdefault(idx, _StageHealth())
        self.heartbeats.forget(worker.host)
        self._items_seen.pop(worker.host, None)
        self._record(idx, why, pipe.live_replicas(idx), "observed", error)
        h.consecutive += 1
        h.last_death_t = now
        if h.consecutive >= self.breaker_threshold:
            if not h.degraded:
                h.degraded = True
                h.pending = 0
                self.breaker_trips += 1
                pipe._degraded.add(st.name)
                self._record(idx, "degraded", h.consecutive, "applied",
                             "E_CRASH_LOOP")
            # zombie slot still retired, but no replacement is fed in
            pipe._retire_worker(idx, worker)
            return
        if now < h.next_ok_t:
            # still backing off: retire the zombie now, owe the respawn
            # — the poll loop pays the debt once the window expires
            pipe._retire_worker(idx, worker)
            h.pending += 1
            self._record(idx, "backoff", int(h.backoff_s * 1e3),
                         "noop", "E_BACKOFF")
            return
        new = pipe._respawn_worker(idx, worker)
        h.backoff_s = (self.backoff_base_s if h.backoff_s == 0
                       else min(h.backoff_s * 2, self.backoff_cap_s))
        h.next_ok_t = now + h.backoff_s
        if new is not None:
            self.respawns += 1
            self._record(idx, "respawn", pipe.live_replicas(idx),
                         "applied")
        else:
            self._record(idx, "respawn", 0, "rejected", "E_STOP_SEEN")

    def _poll_pipeline(self, now: float) -> None:
        pipe = self.pipe
        if pipe is None or not pipe._started:
            return
        dt = max(now - self._last_poll_t, 1e-9)
        dead = set(self.heartbeats.dead_hosts(now))
        with pipe._scale_lock:
            stages = [(i, list(ws)) for i, ws in enumerate(pipe._workers)]
        for idx, ws in stages:
            st = pipe.stages[idx]
            h = self._health.setdefault(idx, _StageHealth())
            for w in ws:
                if w.retire.is_set():
                    self.heartbeats.forget(w.host)
                    continue
                # straggler leg: fold each replica's drained-item rate
                # into the Algorithm-1 host tracker (phase-change
                # detection rides the same detector FT uses at pod
                # scale)
                seen = self._items_seen.get(w.host, 0)
                self.rates.record_steps(w.host, w.items - seen, dt)
                self._items_seen[w.host] = w.items
                if w.crashed is not None and not w.handled:
                    w.handled = True
                    self._respawn(idx, w, now, "crash", "E_REPLICA_DEAD")
                elif (w.host in dead and w.is_alive()
                      and idx > 0 and len(pipe.queues[idx - 1]) > 0):
                    # wedged zombie: alive but silent while work waits
                    w.handled = True
                    self._respawn(idx, w, now, "stall", "E_REPLICA_STALL")
            # pay the respawn debt owed from backoff-window deaths
            if h.pending > 0 and not h.degraded and now >= h.next_ok_t:
                new = pipe._respawn_worker(idx)
                if new is not None:
                    h.pending -= 1
                    self.respawns += 1
                    h.backoff_s = (self.backoff_base_s if h.backoff_s == 0
                                   else min(h.backoff_s * 2,
                                            self.backoff_cap_s))
                    h.next_ok_t = now + h.backoff_s
                    self._record(idx, "respawn", pipe.live_replicas(idx),
                                 "applied")
                else:
                    h.pending = 0        # STOP in flight: debt is void
                    self._record(idx, "respawn", 0, "rejected",
                                 "E_STOP_SEEN")
            # healthy window closes the loop: backoff and the breaker
            # reset once the stage runs clean long enough
            if (h.consecutive > 0 and not any(
                    w.crashed is not None and not w.handled for w in ws)
                    and now - h.last_death_t >= self.healthy_after_s):
                was_degraded = h.degraded
                h.consecutive = 0
                h.backoff_s = 0.0
                h.next_ok_t = 0.0
                if was_degraded:
                    h.degraded = False
                    pipe._degraded.discard(st.name)
                self._record(idx, "recovered", pipe.live_replicas(idx),
                             "applied")

    def _poll_engines(self, now: float) -> None:
        for k, eng in enumerate(self.engines):
            if hasattr(eng, "workers"):
                self._poll_engine_bulkheads(k, eng, now)
                continue
            # legacy single-worker engine protocol
            w = getattr(eng, "_worker", None)
            if (w is not None and w.ident is not None
                    and not w.is_alive() and not eng._stop.is_set()):
                self._record(k, "crash", 0, "observed", "E_ENGINE_DEAD")
                if eng._respawn_worker():
                    self.respawns += 1
                    self._record(k, "respawn", 1, "applied")

    def _poll_engine_bulkheads(self, k, eng, now: float) -> None:
        """Supervise one engine's per-class worker partitions: a dead
        worker is respawned *into its own bulkhead* (borrowed capacity
        never migrates), each (engine, class) pair carries its own
        crash-loop breaker, and a tripped breaker marks the class
        degraded — the engine actuator's ``faulty()`` lane mask then
        holds that lane's legs and shuts its gate in the fused decision
        (same semantics as a degraded pipeline stage)."""
        if eng._stop.is_set():
            return
        for w in eng.workers():
            if (w.ident is None or w.is_alive() or w.retire.is_set()
                    or w.handled):
                continue
            w.handled = True
            self.heartbeats.forget(w.host)
            h = self._eng_health.setdefault((k, w.qos), _BulkheadHealth())
            h.consecutive += 1
            h.last_death_t = now
            self._record(k, "crash", h.consecutive, "observed",
                         "E_ENGINE_DEAD", qos=w.qos)
            if h.consecutive >= self.breaker_threshold:
                if not h.degraded:
                    h.degraded = True
                    self.breaker_trips += 1
                    eng._degraded.add(w.qos)
                    self._record(k, "degraded", h.consecutive, "applied",
                                 "E_CRASH_LOOP", qos=w.qos)
                # zombie slot retired, no replacement fed in — the
                # partition is owed its replica back on recovery
                if eng._retire_dead_worker(w):
                    h.lost += 1
                continue
            if eng._respawn_worker(w):
                self.respawns += 1
                self._record(k, "respawn",
                             eng.bulkhead_sizes().get(w.qos, 0),
                             "applied", qos=w.qos)
                if hasattr(eng, "worker_hosts"):
                    self._hosts.update(eng.worker_hosts())
        # healthy window closes the loop per bulkhead: long enough
        # clean, the breaker resets and the class recovers
        for (ek, qos), h in self._eng_health.items():
            if ek != k or h.consecutive == 0:
                continue
            if now - h.last_death_t >= self.healthy_after_s:
                was = h.degraded
                h.consecutive = 0
                if was:
                    h.degraded = False
                    eng._degraded.discard(qos)
                    # feed the recovered partition its replicas back
                    # (the breaker retired every death while tripped)
                    if h.lost:
                        live = eng.bulkhead_sizes().get(qos, 0)
                        if eng.scale_bulkhead(qos, live + h.lost):
                            self.respawns += h.lost
                        h.lost = 0
                    self._record(k, "recovered",
                                 eng.bulkhead_sizes().get(qos, 0),
                                 "applied", qos=qos)

    def poll(self) -> None:
        """One detection pass (the thread calls this every ``poll_s``;
        tests may call it directly)."""
        now = time.monotonic()
        self._poll_pipeline(now)
        self._poll_engines(now)
        self._last_poll_t = now

    # -- thread plumbing ---------------------------------------------------
    def start(self) -> "ReplicaSupervisor":
        super().start()
        return self

    def run(self) -> None:
        while not self._stop_evt.is_set():
            self.poll()
            if self._kick_evt.wait(self.poll_s):
                self._kick_evt.clear()

    def stop(self) -> None:
        self._stop_evt.set()
        self._kick_evt.set()
        if self.is_alive() and threading.current_thread() is not self:
            self.join(timeout=10)
        self.forget_tenant()
