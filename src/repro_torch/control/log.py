"""Decision audit ring: every actuation the control loop takes (or has
refused by an actuator) is recorded for post-hoc analysis.

Re-tuning a live system from noisy online estimates is exactly the kind
of loop that needs a flight recorder: when throughput moves, the first
question is *which policy acted, on what evidence, and did the actuator
accept it*.  ``ControlLog`` is a fixed-capacity ring (old records fall
off), append is O(1) under a lock and happens only when a decision
fires — never on the per-tick fast path, which is a single fused
dispatch regardless of fleet size.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Iterator, Optional

__all__ = ["ControlRecord", "ControlLog"]


@dataclasses.dataclass(frozen=True)
class ControlRecord:
    """One decision: what was observed, what was done, what came of it.

    ``outcome`` is ``"applied"`` when the actuator took the action,
    ``"rejected"`` when it refused (e.g. a shrink below the queued item
    count — retried once the queue drains), ``"noop"`` when the decision
    matched the live configuration already, ``"error"`` when the
    actuation failed (raised or timed out past its retries — the loop
    rolled back what it could and carries on), and ``"observed"`` for
    pure detection records (sense quarantine, supervisor fault
    detection) that actuated nothing.

    ``error`` is the failure-handling error code (empty on the happy
    path): ``E_ACT_RAISE`` / ``E_ACT_SLOW`` (actuation raise/timeout),
    ``E_SENSE_NAN`` (quarantined non-finite estimate), ``E_JIT_DISPATCH``
    (decision dispatch degraded to the numpy host path), ``E_TICK``
    (contained tick failure), ``E_MONITOR_DEAD`` (watchdog restarted
    the monitor thread), ``E_REPLICA_DEAD`` / ``E_REPLICA_STALL`` /
    ``E_BACKOFF`` / ``E_CRASH_LOOP`` / ``E_STOP_SEEN`` (supervisor),
    ``E_ENGINE_DEAD`` (engine worker-loop death).
    """
    tick: int                  # control-loop tick counter
    t: float                   # time.monotonic() at decision time
    queue: int                 # public stream/queue index
    policy: str                # 'replicas' | 'capacity' | 'admission'
                               # | 'sense' | 'loop' | 'watchdog'
                               # | 'supervisor' | 'qos'
    observed_lam: float
    observed_mu: float
    action: str                # e.g. 'scale', 'resize', 'shed', 'admit'
    value: int                 # target replicas / capacity / gate state
    outcome: str               # 'applied' | 'rejected' | 'noop'
                               # | 'error' | 'observed'
    error: str = ""            # error code, '' on the happy path
    qos: str = ""              # QoS class the record concerns ('' =
                               # class-less): engine per-class gate
                               # flips (policy 'qos') and supervisor
                               # bulkhead crash/respawn records tag it
    # wall-clock twin of ``t``: ``t`` (monotonic) orders records within
    # one process and is what replay alignment uses; ``t_wall`` anchors
    # a drained trace to records from OTHER processes/hosts (monotonic
    # clocks share no epoch across processes)
    t_wall: float = dataclasses.field(default_factory=time.time)


class ControlLog:
    """Thread-safe fixed-size decision ring."""

    def __init__(self, capacity: int = 1024):
        self.capacity = max(int(capacity), 1)
        self._buf: list[Optional[ControlRecord]] = [None] * self.capacity
        self._n = 0                     # total appended, ever
        self._drained = 0               # records drained to JSONL, ever
        self._dropped = 0               # drain-acknowledged ring drops
        self._lock = threading.Lock()

    @property
    def dropped_total(self) -> int:
        """Records that fell (or have already fallen) off the ring
        undrained, ever — monotone: drain-acknowledged drops plus the
        live overhang the next drain would acknowledge.  Exported as
        ``control_log_dropped_total`` and surfaced in
        ``ControlLoop.health()``: a climbing value means the ring is
        undersized (or the drain cadence too slow) for the decision
        rate, and the audit trail has holes."""
        with self._lock:
            live = max(0, self._n - self.capacity - self._drained)
            return self._dropped + live

    def append(self, rec: ControlRecord) -> None:
        with self._lock:
            self._buf[self._n % self.capacity] = rec
            self._n += 1

    def __len__(self) -> int:
        with self._lock:
            return min(self._n, self.capacity)

    @property
    def total(self) -> int:
        """Records ever appended (>= len once the ring has wrapped)."""
        with self._lock:
            return self._n

    def records(self) -> list[ControlRecord]:
        """Chronological snapshot of the retained window."""
        with self._lock:
            n, cap = self._n, self.capacity
            if n <= cap:
                return [r for r in self._buf[:n]]
            start = n % cap
            return self._buf[start:] + self._buf[:start]   # type: ignore

    def tail(self, k: int = 16) -> list[ControlRecord]:
        recs = self.records()
        return recs[-k:]

    def __iter__(self) -> Iterator[ControlRecord]:
        return iter(self.records())

    def by_policy(self, policy: str) -> list[ControlRecord]:
        return [r for r in self.records() if r.policy == policy]

    def counts(self) -> dict[str, int]:
        """{policy/outcome: count} summary over the retained window."""
        out: dict[str, int] = {}
        for r in self.records():
            key = f"{r.policy}/{r.outcome}"
            out[key] = out.get(key, 0) + 1
        return out

    def drain_jsonl(self, path) -> int:
        """Append every record since the last drain to ``path`` as JSON
        lines; returns how many were written.  Incremental and
        restart-safe for periodic draining (the soak harness drains on
        a cadence so a minutes-long run is not limited by the ring).
        Records that fell off the ring between drains are acknowledged
        with one ``{"dropped": n}`` line rather than silently lost."""
        dropped, recs = self._take_undrained()
        # serialize outside the lock: records are frozen, and appends
        # racing us will be picked up by the next drain
        with open(path, "a") as f:
            if dropped:
                f.write(json.dumps({"dropped": dropped}) + "\n")
            for r in recs:
                f.write(json.dumps(dataclasses.asdict(r)) + "\n")
        return len(recs)

    def drain_lines(self) -> list[str]:
        """The JSONL drain as in-memory lines (same cursor and drop
        acknowledgement as ``drain_jsonl``) — backs the exporter's
        ``/control_log`` endpoint, where the scraper, not this process,
        owns the file."""
        dropped, recs = self._take_undrained()
        lines = []
        if dropped:
            lines.append(json.dumps({"dropped": dropped}))
        lines.extend(json.dumps(dataclasses.asdict(r)) for r in recs)
        return lines

    def _take_undrained(self) -> tuple[int, list[ControlRecord]]:
        with self._lock:
            n, cap = self._n, self.capacity
            start = max(self._drained, n - cap)
            dropped = start - self._drained
            recs = [self._buf[i % cap] for i in range(start, n)]
            self._drained = n
            self._dropped += dropped
        return dropped, recs
