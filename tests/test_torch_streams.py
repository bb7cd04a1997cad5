"""The port's streams layer (``repro_torch.streams``) on the CPU: the
fleet monitor service over instrumented queues, against configured rates
and against the JAX package's service fed the same counts.

``device="cpu"`` runs the kernel's plain PyTorch version; the JAX
service runs ``impl="scan"``.  Every JAX-side object lives in its own
arena, so the two packages never share counters.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro.core.monitor import MonitorConfig as JCfg
from repro.core.monitor import run_monitor_fleet as j_run_monitor_fleet
from repro.streams import CounterArena as JArena
from repro.streams import FleetMonitorService as JService
from repro.streams import InstrumentedQueue as JQueue
from repro_torch.core.monitor import MonitorConfig, run_monitor_fleet
from repro_torch.streams import (CounterArena, FleetMonitorService,
                                 FleetMonitorThread, InstrumentedQueue,
                                 MonitorThread, QueueMonitor)

# the test workers share the machine: keep PyTorch's CPU ops on one
# thread so these files do not starve the timing-sensitive suites
torch.set_num_threads(1)


def _drive(svc, queues, tc, blocked, ends="head"):
    """Write one period's counts straight into the arena cells and tick
    the collector, exactly as a pipeline tick would produce them."""
    for t in range(tc.shape[1]):
        for qi, q in enumerate(queues):
            q.head.tc = float(tc[qi, t])
            q.head.blocked = bool(blocked[qi, t])
            if ends == "both":
                q.tail.tc = float(tc[qi, t])
                q.tail.blocked = bool(blocked[qi, t])
        svc.sample()
    svc.flush()


def test_service_recovers_configured_rates():
    """One sampling loop over real push/pop traffic: every queue end
    converges and reports its configured rate within 5%."""
    arena = CounterArena(16)
    queues = [InstrumentedQueue(capacity=8, arena=arena) for _ in range(3)]
    rates = [120, 240, 360]
    emitted, batches = [], []
    svc = FleetMonitorService(queues, MonitorConfig(), period_s=1e-3,
                              chunk_t=32, scale_to_period=False,
                              ends="both", device="cpu",
                              on_converged=lambda qi, r:
                              emitted.append((qi, r)),
                              on_fleet=lambda idx, r: batches.append(idx))
    svc.warmup()
    for _ in range(150):
        for queue, rate in zip(queues, rates):
            for _ in range(rate):
                queue.push(object())
                queue.pop()
        svc.sample()
    svc.flush()
    assert len(svc) == 3 and svc.dispatches >= 4
    assert (svc.epochs() >= 1).all()
    assert emitted and {qi for qi, _ in emitted} <= set(range(6))
    assert batches and all(len(b) >= 1 for b in batches)
    np.testing.assert_allclose(svc.service_rates() * 1e-3, rates, rtol=0.05)
    np.testing.assert_allclose(svc.arrival_rates() * 1e-3, rates, rtol=0.05)
    np.testing.assert_allclose(svc.gated_rates() * 1e-3, rates * 2,
                               rtol=0.05)
    np.testing.assert_allclose(svc.recent_rates("head") * 1e-3, rates,
                               rtol=0.05)
    nb, nt = svc.blocked_counts()
    assert (nt == 150).all() and (nb == 0).all()
    snap = svc.obs_snapshot()
    assert snap["q"] == 3 and snap["dispatches"] == svc.dispatches
    svc.stop()


@pytest.mark.parametrize("ends", ["head", "both"])
def test_service_matches_jax_service(ends):
    """The same counts fed to both packages' services give identical
    epochs, and estimates within 1e-4; both agree with the port's
    one-shot fleet run."""
    rng = np.random.default_rng(7)
    Q, T = 5, 480
    tc = rng.poisson(rng.uniform(100, 400, (Q, 1)), (Q, T)).astype(float)
    blocked = rng.random((Q, T)) < 0.05
    blocked[2, 100:220] = True          # mid-stream blocked burst
    arena = CounterArena(16)
    t_queues = [InstrumentedQueue(8, arena=arena) for _ in range(Q)]
    j_arena = JArena(16)
    j_queues = [JQueue(8, arena=j_arena) for _ in range(Q)]
    t_svc = FleetMonitorService(t_queues, MonitorConfig(), period_s=1e-3,
                                chunk_t=32, scale_to_period=False,
                                ends=ends, device="cpu")
    j_svc = JService(j_queues, JCfg(), period_s=1e-3, chunk_t=32,
                     scale_to_period=False, ends=ends, impl="scan")
    _drive(t_svc, t_queues, tc, blocked, ends)
    _drive(j_svc, j_queues, tc, blocked, ends)
    np.testing.assert_array_equal(t_svc.epochs(), j_svc.epochs())
    assert t_svc.epochs().min() >= 1
    np.testing.assert_allclose(t_svc.service_rates(), j_svc.service_rates(),
                               rtol=1e-4)
    np.testing.assert_allclose(t_svc.observed_blocking_fraction(),
                               j_svc.observed_blocking_fraction())
    st, _ = run_monitor_fleet(MonitorConfig(), tc, blocked, mode="state",
                              chunk_t=128, block_q=8, device="cpu")
    js, _ = j_run_monitor_fleet(JCfg(), tc, blocked, impl="scan",
                                mode="state", chunk_t=128, block_q=8)
    np.testing.assert_array_equal(t_svc.epochs()[:Q], st.epoch.numpy())
    np.testing.assert_array_equal(st.epoch.numpy(), np.asarray(js.epoch))
    t_svc.stop()
    j_svc.stop()


def test_attach_and_detach_keep_estimator_state():
    """Attaching queues keeps the retained streams' state; detaching
    un-pins the dropped queues so they can close."""
    arena = CounterArena(32)
    queues = [InstrumentedQueue(8, arena=arena) for _ in range(3)]
    svc = FleetMonitorService(queues, MonitorConfig(), period_s=1e-3,
                              chunk_t=32, scale_to_period=False,
                              device="cpu")
    rng = np.random.default_rng(1)
    tc = rng.poisson(200, (3, 192)).astype(float)
    _drive(svc, queues, tc, np.zeros_like(tc, bool))
    before = svc.epochs().copy()
    assert (before >= 1).all()
    extra = InstrumentedQueue(8, arena=arena)
    svc.attach([extra])
    assert len(svc) == 4
    np.testing.assert_array_equal(svc.epochs()[:3], before)
    assert svc.epochs()[3] == 0
    with pytest.raises(ValueError):
        svc.attach([extra])             # already monitored
    with pytest.raises(ValueError):
        queues[0].close()               # still pinned by the service
    svc.detach([queues[0]])
    assert len(svc) == 3
    np.testing.assert_array_equal(svc.epochs()[:2], before[1:])
    queues[0].close()                   # un-pinned now
    svc.stop()
    with pytest.raises(RuntimeError):
        svc.attach([InstrumentedQueue(8, arena=arena)])


def test_fleet_monitor_thread_starts_and_stops():
    """The timer thread warms up, ticks the collector, and joins on
    stop (the conftest hygiene gate checks for leaked threads)."""
    arena = CounterArena(8)
    queues = [InstrumentedQueue(8, arena=arena) for _ in range(2)]
    svc = FleetMonitorService(queues, MonitorConfig(), period_s=1e-3,
                              chunk_t=4, device="cpu")
    thread = FleetMonitorThread(svc, adapt_period=False)
    thread.start()
    deadline = time.monotonic() + 20.0
    while svc.dispatches < 2 and time.monotonic() < deadline:
        queues[0].push(1)
        queues[0].pop()
        time.sleep(1e-3)
    thread.stop()
    assert not thread.is_alive()
    assert svc.dispatches >= 2
    assert thread.daemon and thread.name == "repro-fleet-monitor"
    alive = [t for t in threading.enumerate() if t is thread]
    assert not alive


def test_per_queue_monitor_thread():
    """The paper's per-queue monitor form still runs on the port."""
    q = InstrumentedQueue(8, arena=CounterArena(4))
    qm = QueueMonitor(q, MonitorConfig(), base_period_s=1e-3)
    fired = []
    mt = MonitorThread([qm], on_converged=fired.append)
    mt.start()
    t_end = time.monotonic() + 0.3
    while time.monotonic() < t_end:
        q.push(1)
        q.pop()
    mt.stop()
    assert not mt.is_alive()
    assert qm.head.n_total > 0
