"""Trace record/replay: re-execute a recorded run against a different
``PolicySet``.

The control loop is a deterministic function of what it *senses*: the
per-period counter stream its monitor service folds, and the actuator
observations (replicas / capacities / occupancy) it reads each tick.
A :class:`Trace` captures exactly that — plus the monitor/loop wiring
(window, chunk, period, impl) needed to rebuild the identical sensing
path — so :func:`replay` can re-drive a fresh
``FleetMonitorService`` + ``ControlLoop`` from the recording:

* with the *same* ``PolicySet``: the decision sequence reproduces
  bit-for-bit (the determinism regression test);
* with a *different* ``PolicySet``: a counterfactual — what would the
  candidate policy have decided against the production-shaped run —
  without re-running the workload (the replay is open-loop: decisions
  are recorded, not actuated, since the recorded counters already
  embed the original run's actuations).

Traces serialize to one ``.npz`` (arrays + a JSON meta blob), so a
production-shaped run can be checked in as a fixture.  The file format
is the JAX package's (``repro.workloads.trace``): either package reads a
trace the other wrote.  ``replay`` takes a trailing keyword-only
``device`` for its monitor service and decision (the card by default).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Optional

import numpy as np

from repro_torch.control.loop import ControlLoop
from repro_torch.core.device import resolve_device
from repro_torch.core.monitor import MonitorConfig
from repro_torch.streams import (CounterArena, FleetMonitorService,
                                 InstrumentedQueue)

__all__ = ["DECISION_FIELDS", "Trace", "TraceRecorder", "ReplayActuator",
           "replay"]

DECISION_FIELDS = ("target_replicas", "scale_mask", "target_caps",
                   "resize_mask", "shed", "straggler", "probing")


@dataclasses.dataclass
class Trace:
    """One recorded run: the sensed world, tick-aligned."""
    meta: dict                     # scenario/policy/fault/seed + wiring
    counters: np.ndarray           # (T, Q, 4) measured per-period counts
    sampled: np.ndarray            # (T,) bool — False during monitor outage
    tick_at: np.ndarray            # (K,) period index of each control tick
    replicas: np.ndarray           # (K, Q) actuator observation at tick
    caps: np.ndarray               # (K, Q)
    occupancy: np.ndarray          # (K, Q)
    decisions: dict                # field -> (K, Q) recorded Decision

    @property
    def n_queues(self) -> int:
        return int(self.counters.shape[1])

    def save(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        payload = {"meta": np.frombuffer(
            json.dumps(self.meta).encode(), dtype=np.uint8),
            "counters": self.counters, "sampled": self.sampled,
            "tick_at": self.tick_at, "replicas": self.replicas,
            "caps": self.caps, "occupancy": self.occupancy}
        for k, v in self.decisions.items():
            payload[f"dec_{k}"] = v
        with open(path, "wb") as f:
            np.savez_compressed(f, **payload)
        return path

    @classmethod
    def load(cls, path) -> "Trace":
        with np.load(pathlib.Path(path)) as z:
            meta = json.loads(bytes(z["meta"].tobytes()).decode())
            dec = {k[4:]: z[k] for k in z.files if k.startswith("dec_")}
            return cls(meta=meta, counters=z["counters"],
                       sampled=z["sampled"], tick_at=z["tick_at"],
                       replicas=z["replicas"], caps=z["caps"],
                       occupancy=z["occupancy"], decisions=dec)


class TraceRecorder:
    """Accumulates per-period counters and per-tick observations +
    decisions while a harness drives a run; ``finish(meta)`` freezes
    the arrays into a :class:`Trace`."""

    def __init__(self, n_queues: int):
        self.q = int(n_queues)
        self._counters: list = []
        self._sampled: list = []
        self._tick_at: list = []
        self._obs: list = []           # (replicas, caps, occ) rows
        self._dec: list = []

    def period(self, rows, sampled: bool) -> None:
        """``rows`` is (Q, 4): the measured counter tuples written to
        the instrumented ends this period."""
        self._counters.append(np.asarray(rows, np.float64))
        self._sampled.append(bool(sampled))

    def tick(self, t: int, replicas, caps, occupancy, decision) -> None:
        self._tick_at.append(int(t))
        self._obs.append((np.asarray(replicas, np.int64),
                          np.asarray(caps, np.int64),
                          np.asarray(occupancy, np.float64)))
        self._dec.append(tuple(np.asarray(getattr(decision, f))
                               for f in DECISION_FIELDS))

    def finish(self, meta: dict) -> Trace:
        K = len(self._tick_at)
        dec = {f: (np.stack([d[i] for d in self._dec])
                   if K else np.zeros((0, self.q)))
               for i, f in enumerate(DECISION_FIELDS)}
        return Trace(
            meta=dict(meta),
            counters=(np.stack(self._counters) if self._counters
                      else np.zeros((0, self.q, 4))),
            sampled=np.asarray(self._sampled, bool),
            tick_at=np.asarray(self._tick_at, np.int64),
            replicas=(np.stack([o[0] for o in self._obs]) if K
                      else np.zeros((0, self.q), np.int64)),
            caps=(np.stack([o[1] for o in self._obs]) if K
                  else np.zeros((0, self.q), np.int64)),
            occupancy=(np.stack([o[2] for o in self._obs]) if K
                       else np.zeros((0, self.q))),
            decisions=dec)


class ReplayActuator:
    """Feeds the recorded actuator observations back to a replaying
    loop: the driver sets ``k`` to the tick index before each
    ``loop.tick()``; actuation verbs are recorded, never applied (the
    recorded counter stream already embeds the original actuations)."""

    def __init__(self, trace: Trace):
        self.trace = trace
        self.k = 0
        self.actions: list[tuple] = []

    def replicas(self) -> np.ndarray:
        return np.asarray(self.trace.replicas[self.k], np.int64)

    def capacities(self) -> np.ndarray:
        return np.asarray(self.trace.caps[self.k], np.int64)

    def occupancy(self) -> np.ndarray:
        return np.asarray(self.trace.occupancy[self.k], float)

    def scale(self, i: int, n: int) -> str:
        self.actions.append((self.k, "scale", int(i), int(n)))
        return "applied"

    def resize(self, i: int, cap: int) -> str:
        self.actions.append((self.k, "resize", int(i), int(cap)))
        return "applied"

    def admit(self, i: int, shed: bool) -> str:
        self.actions.append((self.k, "admit", int(i), bool(shed)))
        return "applied"


def replay(trace: Trace, policies, *,
           impl: Optional[str] = None, device="cuda") -> dict:
    """Re-drive the recorded sensing stream through a fresh monitor
    service + control loop under ``policies`` on ``device``; returns the
    replayed decision sequence as ``{field: (K, Q) array}`` plus the
    actuation verbs the loop *would* have issued (``"actions"``)."""
    dev = resolve_device(device)
    meta = trace.meta
    Q = trace.n_queues
    impl = impl if impl is not None else meta.get("impl", "numpy")
    arena = CounterArena(max(8, 4 * Q))
    queues = [InstrumentedQueue(8, arena=arena) for _ in range(Q)]
    svc = FleetMonitorService(
        queues,
        MonitorConfig(window=int(meta["window"]),
                      min_q_samples=int(meta["min_q_samples"])),
        period_s=float(meta["period_s"]),
        chunk_t=int(meta["decide_every"]),
        scale_to_period=False, ends="both", device=dev)
    act = ReplayActuator(trace)
    loop = ControlLoop(svc, policies, act, impl=impl)
    loop.warmup()
    decide_every = int(meta["decide_every"])
    out: dict = {f: [] for f in DECISION_FIELDS}
    k = 0
    try:
        for t in range(trace.counters.shape[0]):
            for qi, q in enumerate(queues):
                tt, tb, ht, hb = trace.counters[t, qi]
                q.tail.tc, q.tail.blocked = float(tt), bool(tb)
                q.head.tc, q.head.blocked = float(ht), bool(hb)
            if trace.sampled[t]:
                svc.sample()
            if t % decide_every == decide_every - 1 and k < len(
                    trace.tick_at):
                act.k = k
                dec = loop.tick()
                for f in DECISION_FIELDS:
                    out[f].append(np.asarray(getattr(dec, f)))
                k += 1
        svc.flush()
    finally:
        svc.stop()
    return {**{f: (np.stack(v) if v else np.zeros((0, Q)))
               for f, v in out.items()},
            "actions": act.actions, "ticks": k}
