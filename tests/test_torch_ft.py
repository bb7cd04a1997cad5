"""The port's fault tolerance (``repro_torch.ft``) against the JAX
package's (``repro.ft``), on the CPU.

Seeded fault plans must schedule, consume and audit the same events;
heartbeats, elastic re-mesh plans and ``FaultToleranceManager.assess``
must answer the same; ``FleetRateTracker`` on the port (its fleet state
on the CPU, in the rounds form, the sequential scan and the kernel's
plain version) must give the reference's rates (rtol 1e-6) and
stragglers on the phase-change streams of the reference's fleet test.
``ReplicaSupervisor`` is held to the reference's self-healing tests on
the port's own ``Pipeline`` and ``Engine``: a crashed replica respawned,
a crash loop tripping the breaker, an engine bulkhead respawned into its
own partition, degraded and recovered.  Every supervisor thread is
stopped and joined before its test ends.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import repro.ft as j_ft
import repro_torch.ft as t_ft
from repro.core.monitor import MonitorConfig as JCfg
from repro_torch.analysis.witness import armed
from repro_torch.control import (ControlConfig, control_decide,
                                 control_init)
from repro_torch.core import device as t_device
from repro_torch.core.monitor import MonitorConfig
from repro_torch.serve import (BLOCKING, NONBLOCKING, Engine, Request,
                               ServeConfig)
from repro_torch.streams import CounterArena, Pipeline, Stage

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _lock_witness():
    """The module runs under the port's runtime lock witness, armed
    before its shared fixtures are built: a lock-hierarchy hazard it
    records (``LOCK_ORDER``) fails the module's last test."""
    with armed(lambda msg: pytest.fail(msg, pytrace=False)):
        yield

CFG = MonitorConfig(window=16, min_q_samples=16)


def _key(events):
    return [(e.at_s, e.kind, e.target, e.duration_s, e.factor)
            for e in events]


# -- fault plans -------------------------------------------------------------

CHAOS = [
    dict(seed=7, targets=["work"], n_crashes=3, monitor_death_at=1.0),
    dict(seed=0, targets=["work"], n_crashes=3, window_s=(0.5, 2.0),
         monitor_death_at=1.2),
    dict(seed=11, targets=["a", "b"], n_crashes=2, n_stalls=1, n_skews=3,
         skew_s=0.5, skew_factor=2.0, monitor_death_at=1.0),
    dict(seed=5, targets=["a"], n_crashes=2, n_stalls=1, n_act_fails=3),
    dict(seed=0, targets=["nonblocking"], n_crashes=2,
         window_s=(1.36, 2.16), n_stalls=1, stall_s=0.15,
         monitor_death_at=2.32),
    dict(seed=3, targets=[], n_crashes=0, n_skews=2, skew_s=1.0,
         skew_factor=2.0, monitor_outage_s=4.0, monitor_death_at=3.0),
]


@pytest.mark.parametrize("kw", CHAOS, ids=[f"chaos{i}"
                                           for i in range(len(CHAOS))])
def test_chaos_plan_equals_the_reference(kw):
    got = t_ft.FaultPlan.chaos(**kw)
    want = j_ft.FaultPlan.chaos(**kw)
    assert _key(got.events()) == _key(want.events())
    assert _key(got._events) == _key(want._events)
    assert got.pending() == want.pending()
    assert got._next_due == want._next_due
    assert not got.armed and got.worker_fault_due("work") is None


def test_chaos_validation_matches():
    with pytest.raises(ValueError):
        t_ft.FaultPlan.chaos(seed=0, targets=[], n_crashes=1)
    with pytest.raises(ValueError):
        t_ft.FaultEvent(0.0, "meltdown")


def _consume(ft):
    """One plan armed in the past, consumed through every hook."""
    E = ft.FaultEvent
    plan = ft.FaultPlan([
        E(0.0, "crash", "work"), E(0.0, "stall", "work", duration_s=0.01),
        E(0.0, "crash", "other"), E(0.0, "actuation", "scale"),
        E(0.0, "monitor_death"), E(100.0, "crash", "work"),
        E(0.0, "clock_skew", duration_s=50.0, factor=2.0),
        E(0.0, "clock_skew", duration_s=50.0, factor=1.5)])
    t0 = time.monotonic() - 1.0
    plan.arm(t0)
    trail = []
    try:
        plan.maybe_fault("work#3", aliases=("work",))
    except ft.InjectedFault:
        trail.append("crash")
    plan.maybe_fault("work")                          # the stall, slept out
    trail.append(plan.worker_fault_due("work"))       # the far one: not due
    trail.append(plan.worker_fault_due("x", aliases=("other",)).kind)
    trail.append(plan.actuation_due("resize"))
    trail.append(plan.actuation_due("scale").kind)
    trail.append(plan.monitor_death_due())
    trail.append(plan.monitor_death_due())
    trail.append(plan.skew_factor(now=t0 + 10.0))
    trail.append(plan.skew_factor(now=t0 + 60.0))
    act = ft.FaultyActuator(_Inner(), ft.FaultPlan(
        [E(0.0, "actuation", "admit")]).arm())
    for verb, args in (("scale", (0, 2)), ("admit", (0, True)),
                       ("admit", (0, True)), ("resize", (0, 8))):
        try:
            trail.append(getattr(act, verb)(*args))
        except ft.InjectedFault:
            trail.append("raised")
    trail.append(act.replicas())           # attribute pass-through
    return trail, plan.pending(), [e.kind for _, e in plan.fired()]


class _Inner:
    def scale(self, i, n):
        return "applied"

    def resize(self, i, cap):
        return "applied"

    def admit(self, i, shed):
        return "applied"

    def replicas(self):
        return [1]


def test_fault_plan_consumption_and_audit_match():
    got = _consume(t_ft)
    assert got == _consume(j_ft)
    assert got[1] == 3                     # the far crash + two skews
    assert got[2] == ["crash", "stall", "crash", "actuation",
                      "monitor_death"]


# -- heartbeats, elastic plans, the manager ----------------------------------

def test_heartbeat_registry_matches():
    def drive(ft):
        reg = ft.HeartbeatRegistry(timeout_s=0.5)
        for h, t in (("a", 0.0), ("b", 0.3), ("c", 1.0), ("a", 0.9)):
            reg.beat(h, t)
        out = [(reg.dead_hosts(now), reg.alive(now))
               for now in (1.0, 1.35, 1.6)]
        reg.forget("c")
        reg.forget("zzz")
        out.append((reg.dead_hosts(10.0), reg.alive(1.0)))
        return out

    assert drive(t_ft) == drive(j_ft)


@pytest.mark.parametrize("total,failed,per_host,step", [
    (256, 16, 4, None), (256, 0, 4, 7), (64, 20, 4, 123), (32, 20, 8, 1),
    (20, 9, 4, None), (16384, 128, 8, 500)])
def test_elastic_plan_equals_the_reference(total, failed, per_host, step):
    got = t_ft.plan_elastic_mesh(total, failed, per_host, restart_step=step)
    want = j_ft.plan_elastic_mesh(total, failed, per_host,
                                  restart_step=step)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_elastic_plan_refuses_an_empty_mesh():
    with pytest.raises(RuntimeError):
        t_ft.plan_elastic_mesh(16, 16)


def test_ft_manager_assess_equals_the_reference():
    """The reference's straggler scenario through both managers: host7
    at half rate, host2's heartbeat lapsed."""
    plans = []
    for ft in (t_ft, j_ft):
        ftm = ft.FaultToleranceManager(n_hosts=8, chips_per_host=4,
                                       heartbeat_timeout_s=100.0)
        assert ftm.assess(latest_ckpt_step=1) is None
        now = time.monotonic()
        for h in range(8):
            ftm.heartbeats.beat(f"host{h}", now - (500.0 if h == 2 else 0))
        rng = np.random.default_rng(0)
        for _ in range(600):
            for h in range(8):
                ftm.rates.record_steps(f"host{h}",
                                       rng.poisson(5.0 if h == 7 else 10.0),
                                       1.0)
        plans.append(ftm.assess(latest_ckpt_step=123))
    assert dataclasses.asdict(plans[0]) == dataclasses.asdict(plans[1])
    assert plans[0].dropped_hosts == ["host2", "host7"]


# -- the fleet rate tracker --------------------------------------------------

def _phase_change():
    """The step streams of ``tests/test_streams_fleet.py``'s ft injection
    test, drawn as it draws them (Q = 5), and a 5% blocked mask."""
    rng = np.random.default_rng(3)
    Q, T = 5, 600
    rng.poisson(200, (Q, 400))             # that test's service counters
    steps = np.full((Q, T), 100.0) + rng.normal(0, 1.0, (Q, T))
    steps[3, 200:] *= 0.3                  # straggler phase change
    blocked = np.random.default_rng(4).random((Q, T)) < 0.05
    return steps, blocked


@pytest.mark.parametrize("impl", ["rounds", "scan", "cuda"])
@pytest.mark.parametrize("with_blocked", [False, True],
                         ids=["unblocked", "blocked"])
def test_fleet_rate_tracker_equals_the_reference(impl, with_blocked):
    steps, blocked = _phase_change()
    blk = blocked if with_blocked else None
    hosts = [f"h{i}" for i in range(steps.shape[0])]
    got = t_ft.FleetRateTracker(hosts, CFG, period_s=1.0, chunk_t=16,
                                impl=impl, device="cpu")
    want = j_ft.FleetRateTracker(hosts, JCfg(window=16, min_q_samples=16),
                                 period_s=1.0, chunk_t=16, impl="rounds")
    for t0 in range(0, 600, 100):
        sl = slice(t0, t0 + 100)
        r_got = got.record_tile(steps[:, sl],
                                None if blk is None else blk[:, sl])
        r_want = want.record_tile(steps[:, sl],
                                  None if blk is None else blk[:, sl])
        assert isinstance(r_got, np.ndarray)
        np.testing.assert_allclose(r_got, r_want, rtol=1e-6)
    assert got.stragglers() == want.stragglers() == ["h3"]
    np.testing.assert_allclose(got.rates(), want.rates(), rtol=1e-6)
    assert got._state.epoch.device.type == "cpu"
    np.testing.assert_array_equal(got._state.epoch.numpy(),
                                  np.asarray(want._state.epoch))


def test_fleet_rate_tracker_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(t_device.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_ft.FleetRateTracker(["h0", "h1"])


def test_host_rate_tracker_equals_the_reference():
    rng = np.random.default_rng(4)
    draws = rng.poisson(10.0, (600, 5))
    draws[200:, 1] = rng.poisson(4.0, 400)  # w1 phase-changes down
    out = []
    for ft in (t_ft, j_ft):
        tr = ft.HostRateTracker()
        for row in draws:
            for h, s in enumerate(row):
                tr.record_steps(f"w{h}", float(s), 0.5, blocked=s == 0)
        out.append((tr.stragglers(),
                    {h: m.rate_items_per_s()
                     for h, m in sorted(tr.monitors.items())}))
    assert out[0][0] == out[1][0] == ["w1"]
    for h, r in out[1][1].items():
        assert out[0][1][h] == pytest.approx(r, rel=1e-9)


# -- the replica supervisor on the port's runtimes ---------------------------

def _paced_source(n, dt=2e-4):
    for i in range(n):
        time.sleep(dt)
        yield i


def _wait(pred, timeout=15.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def test_supervisor_respawns_crashed_replica():
    plan = t_ft.FaultPlan([t_ft.FaultEvent(0.02, "crash", "work")])
    pipe = Pipeline([Stage("src", source=_paced_source(1500)),
                     Stage("work", fn=lambda x: x, replicas=2)],
                    capacity=32, arena=CounterArena(8), fault_plan=plan,
                    device="cpu")
    sup = t_ft.ReplicaSupervisor(pipe, poll_s=0.005, backoff_base_s=0.005)
    assert pipe.supervisor is sup
    sup.start()
    plan.arm()
    try:
        out = pipe.run_collect(timeout_s=120)
    finally:
        sup.stop()
    assert not sup.is_alive()
    assert pipe.stats()["crash_count"] == 1
    assert sup.respawns >= 1
    assert len(out) >= 1500 - 1            # only the in-flight item is lost
    assert pipe.live_replicas("work") == 2
    acts = [r.action for r in sup.log.records() if r.policy == "supervisor"]
    assert "crash" in acts and "respawn" in acts
    errs = [r.error for r in sup.log.records() if r.action == "crash"]
    assert "E_REPLICA_DEAD" in errs
    assert sup.heartbeats._last == {}      # stop() forgets every host


def test_crash_loop_breaker_degrades_stage():
    def always(x):
        raise RuntimeError("crash loop")

    pipe = Pipeline([Stage("src", source=range(50)),
                     Stage("work", fn=always)],
                    capacity=8, arena=CounterArena(8), device="cpu")
    sup = t_ft.ReplicaSupervisor(pipe, poll_s=0.002, backoff_base_s=0.001,
                                 breaker_threshold=3, healthy_after_s=60.0)
    sup.start()
    # the degraded stage never drains: run_collect returns at its timeout
    t = threading.Thread(target=pipe.run_collect,
                         kwargs={"timeout_s": 3}, daemon=True)
    t.start()
    try:
        assert _wait(lambda: "work" in pipe._degraded)
        assert sup.breaker_trips == 1
        assert sup.degraded() == ["work"]
        _, act = pipe.control_tenant()
        assert act.faulty().tolist() == [True, False]   # work's queue, sink
        assert any(r.error == "E_CRASH_LOOP" for r in sup.log.records())
        assert pipe.stats()["crash_count"] >= 3
        assert pipe.live_replicas("work") == 0
    finally:
        sup.stop()
        t.join(timeout=30)
    assert not sup.is_alive() and not t.is_alive()


class _SleepEngine(Engine):
    """Model-free engine whose serve round just burns a little time."""

    def _serve_batch(self, batch):
        time.sleep(2e-3)
        for r in batch:
            r.out = np.zeros(1, np.int32)
            r.done.set()
            self.served += 1


def _breq(i):
    return Request(rid=i, tokens=np.arange(4), max_new=1, qos=BLOCKING)


def test_supervisor_respawns_borrowed_replica_into_own_bulkhead():
    plan = t_ft.FaultPlan([t_ft.FaultEvent(0.05, "crash", NONBLOCKING)])
    eng = _SleepEngine(None, None,
                       ServeConfig(batch_size=2, queue_capacity=64,
                                   bulkheads=(1, 1)),
                       arena=CounterArena(4), fault_plan=plan, device="cpu")
    sup = t_ft.ReplicaSupervisor(engines=[eng], poll_s=0.01)
    eng.start()
    sup.start()
    plan.arm()
    try:
        reqs = [_breq(i) for i in range(60)]     # the blocking spike
        for r in reqs:
            assert eng.submit(r, timeout=10)
        assert _wait(lambda: len(plan.fired()) == 1)
        assert _wait(lambda: sup.respawns >= 1)
        assert eng.bulkhead_sizes() == {BLOCKING: 1, NONBLOCKING: 1}
        live_nb = [w for w in eng.workers() if w.qos == NONBLOCKING
                   and w.is_alive()]
        assert live_nb and f":{NONBLOCKING}#" in live_nb[0].host
        for r in reqs:
            assert r.done.wait(timeout=30)
        crash = [r for r in sup.log.records() if r.action == "crash"]
        assert crash and crash[0].qos == NONBLOCKING
        assert crash[0].error == "E_ENGINE_DEAD"
        resp = [r for r in sup.log.records() if r.action == "respawn"]
        assert resp and resp[0].qos == NONBLOCKING
    finally:
        sup.stop()
        eng.stop()
    assert not sup.is_alive()


def test_engine_bulkhead_breaker_degrades_class_and_recovers():
    plan = t_ft.FaultPlan([t_ft.FaultEvent(0.0, "crash", NONBLOCKING),
                           t_ft.FaultEvent(0.0, "crash", NONBLOCKING)])
    eng = _SleepEngine(None, None,
                       ServeConfig(batch_size=2, queue_capacity=16,
                                   bulkheads=(1, 1)),
                       arena=CounterArena(4), fault_plan=plan, device="cpu")
    sup = t_ft.ReplicaSupervisor(engines=[eng], poll_s=0.01,
                                 breaker_threshold=2, healthy_after_s=0.3)
    eng.start()
    sup.start()
    plan.arm()
    try:
        assert _wait(lambda: NONBLOCKING in eng._degraded)
        assert sup.breaker_trips == 1
        assert eng.bulkhead_sizes()[NONBLOCKING] == 0
        assert eng.bulkhead_sizes()[BLOCKING] == 1
        mask = eng._actuator.faulty()
        assert mask.tolist() == [False, True]
        cfg = ControlConfig(confirm_ticks=1, cooldown_ticks=0, min_ready=1)
        st = control_init(cfg, 2, device="cpu")
        dec = None
        for _ in range(2):
            st, dec = control_decide(
                cfg, st, lam=np.full(2, 100.0), mu=np.full(2, 100.0),
                ready=np.ones(2, bool), replicas=np.ones(2),
                caps=np.full(2, 64), faulty=mask, impl="numpy")
        assert np.asarray(dec.shed).tolist() == [False, True]
        assert not np.asarray(dec.scale_mask)[1]
        assert any(r.error == "E_CRASH_LOOP" and r.qos == NONBLOCKING
                   for r in sup.log.records())
        assert _wait(lambda: NONBLOCKING not in eng._degraded, timeout=20)
        assert _wait(lambda: eng.bulkhead_sizes()[NONBLOCKING] == 1,
                     timeout=20)
        assert eng._actuator.faulty().tolist() == [False, False]
        # the supervisor refills the partition, then audits the recovery
        assert _wait(lambda: any(r.action == "recovered"
                                 and r.qos == NONBLOCKING
                                 for r in sup.log.records()))
    finally:
        sup.stop()
        eng.stop()
    assert not sup.is_alive()


def test_ft_manager_elastic_plan_from_supervised_pipeline():
    """FaultToleranceManager.assess over the supervisor's live registry
    and rate tracker (the reference's test on the port's pipeline)."""
    pipe = Pipeline([Stage("src", source=_paced_source(800)),
                     Stage("work", fn=lambda x: x, replicas=2)],
                    capacity=32, arena=CounterArena(8), device="cpu")
    sup = t_ft.ReplicaSupervisor(pipe, poll_s=0.005,
                                 heartbeat_timeout_s=0.15)
    sup.start()
    try:
        pipe.run_collect(timeout_s=120)
        assert any(h.startswith("work#") for h in sup.rates.monitors)
        ftm = t_ft.FaultToleranceManager(n_hosts=8, chips_per_host=4,
                                         heartbeat_timeout_s=0.15)
        ftm.heartbeats = sup.heartbeats
        ftm.rates = sup.rates
        victim = sorted(h for h in sup.heartbeats._last
                        if h.startswith("work#"))[0]
        time.sleep(0.2)
        for h in list(sup.heartbeats._last):
            if h != victim:
                sup.heartbeats.beat(h)
        plan = ftm.assess(latest_ckpt_step=123)
        assert plan is not None and victim in plan.dropped_hosts
        assert plan.restart_step == 123 and plan.n_chips < 8 * 4
    finally:
        sup.stop()
    assert sup.heartbeats._last == {}
