"""The port's control plane against the JAX package's, on the CPU.

``control_decide`` runs in four forms on the same inputs: the port's
``"numpy"`` host form and its ``"jit"`` form (torch ops; eagerly on the
CPU, one CUDA graph on the card), and the JAX package's ``"numpy"`` and
``"jit"`` forms.  Decisions must be array-equal and the carried state
must agree to rtol 1e-6, the reference's own tolerance.  A trace the JAX
package records through its scenario harness is replayed through the
port's ``FleetMonitorService(impl="rounds")`` and ``ControlLoop``: the
integer and boolean decisions must come out bit for bit.  The loop's
hardening (sense quarantine, actuator retry and rollback, jit -> numpy
degradation, the monitor watchdog, contained tick failures) is held to
its error codes.  The ``"jit"`` form on the card is held to the numpy
form in ``tests/test_torch_cuda_kernels.py``, which imports no JAX.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import repro.control as j_ctl
import repro.streams as j_streams
import repro_torch.control as t_ctl
import repro_torch.streams as t_streams
from repro.workloads.harness import make_policies, run_cell
from repro.workloads.trace import DECISION_FIELDS
from repro_torch.control import loop as t_loop
from repro_torch.core import controller as t_controller
from repro_torch.core.monitor import MonitorConfig
from repro_torch.streams import (CounterArena, FleetMonitorService,
                                 InstrumentedQueue, Pipeline, Stage)

torch.set_num_threads(1)

CFG = MonitorConfig(window=16, min_q_samples=16)


# -- the four forms of control_decide ----------------------------------------

def _random_drive(rng, q):
    """The random 40-tick drive of the reference's numpy/jit parity test,
    with the SLO operands added for the SLO config."""
    for _ in range(40):
        yield dict(lam=rng.uniform(0, 300, q), mu=rng.uniform(0, 300, q),
                   ready=rng.random(q) > 0.2,
                   replicas=rng.integers(1, 8, q),
                   caps=rng.integers(4, 256, q),
                   cv2=rng.uniform(0.1, 2, q), occupancy=rng.random(q),
                   saturated=rng.random(q) > 0.8,
                   stale=rng.random(q) > 0.8,
                   leg_rep=rng.random(q) > 0.2,
                   leg_buf=rng.random(q) > 0.2,
                   leg_adm=rng.random(q) > 0.2,
                   headroom=rng.uniform(1.0, 2.0, q),
                   max_replicas=rng.integers(2, 16, q),
                   slo_target=np.where(rng.random(q) > 0.3, 4e-3, np.nan),
                   over_frac=np.where(rng.random(q) > 0.1, rng.random(q),
                                      np.nan))


def _qos_drive(rng, q):
    """The QoS legs' parity case (per-queue bands and sibling pressure)."""
    for _ in range(3):
        yield dict(lam=np.array([100.0, 80.0, 60.0]),
                   mu=np.array([100.0, 90.0, 70.0]),
                   ready=np.ones(q, bool), replicas=np.ones(q),
                   caps=np.full(q, 64),
                   occupancy=np.array([0.9, 0.2, 0.1]),
                   occ_hi=np.array([np.nan, 0.6, 0.5], np.float32),
                   occ_lo=np.array([np.nan, 0.3, 0.2], np.float32),
                   pressure=np.array([0.0, 0.9, 0.4]))


def _slo_drive(rng, q):
    """The SLO leg: balanced rates, a sustained over-target window, then
    the window empties (NaN) and the burn decays."""
    for t in range(24):
        yield dict(lam=[100.0], mu=[150.0], ready=[True], replicas=[2],
                   caps=[64], slo_target=[4e-3],
                   over_frac=[1.0 if t < 8 else np.nan])


DRIVES = {
    "random": (dict(confirm_ticks=2, cooldown_ticks=3, block_q=16,
                    min_ready=4), 13, _random_drive),
    "random_slo": (dict(confirm_ticks=1, cooldown_ticks=1, block_q=16,
                        min_ready=4, slo_enabled=True, slo_fast_ticks=2,
                        slo_slow_ticks=4, max_replicas=16,
                        saturation_growth=1.5), 13, _random_drive),
    "qos": (dict(confirm_ticks=1, cooldown_ticks=0, min_ready=1,
                 block_q=8), 3, _qos_drive),
    "slo": (dict(confirm_ticks=1, cooldown_ticks=1, block_q=8,
                 slo_enabled=True, slo_fast_ticks=2, slo_slow_ticks=4,
                 max_replicas=16), 1, _slo_drive),
}


@pytest.mark.parametrize("drive", sorted(DRIVES))
def test_control_decide_four_forms_agree(drive):
    kw, q, gen = DRIVES[drive]
    j_cfg, t_cfg = j_ctl.ControlConfig(**kw), t_ctl.ControlConfig(**kw)
    states = {"j_numpy": j_ctl.control_init(j_cfg, q),
              "j_jit": j_ctl.control_init(j_cfg, q),
              "t_numpy": t_ctl.control_init(t_cfg, q, device="cpu"),
              "t_jit": t_ctl.control_init(t_cfg, q, device="cpu")}
    fired = 0
    for t, ops in enumerate(gen(np.random.default_rng(3), q)):
        decs = {}
        for form, st in states.items():
            pkg, impl = form.split("_")
            cfg, mod = (j_cfg, j_ctl) if pkg == "j" else (t_cfg, t_ctl)
            states[form], decs[form] = mod.control_decide(
                cfg, st, impl=impl, donate=(form != "j_jit"), **ops)
        want = decs["j_numpy"]
        fired += int(np.asarray(want.scale_mask).sum()
                     + np.asarray(want.resize_mask).sum()
                     + np.asarray(want.shed).sum())
        for form in ("j_jit", "t_numpy", "t_jit"):
            for name, a, b in zip(want._fields, want, decs[form]):
                np.testing.assert_array_equal(
                    np.asarray(b), np.asarray(a),
                    err_msg=f"{form} tick {t} {name}")
            for name, a, b in zip(states["j_numpy"]._fields,
                                  states["j_numpy"], states[form]):
                np.testing.assert_allclose(
                    np.asarray(b), np.asarray(a), rtol=1e-6,
                    err_msg=f"{form} tick {t} state {name}")
    assert fired, "the drive must make the legs act"


def test_port_decision_state_types():
    """The numpy form carries numpy state, the jit form torch tensors on
    the state's device; ``auto`` picks numpy for CPU state."""
    cfg = t_ctl.ControlConfig(block_q=8)
    kw = dict(lam=[100.0], mu=[50.0], ready=[True], replicas=[1],
              caps=[64])
    st0 = t_ctl.control_init(cfg, 1, device="cpu")
    assert all(isinstance(a, torch.Tensor) for a in st0)
    st_n, dec = t_ctl.control_decide(cfg, st0, impl="auto", **kw)
    assert all(isinstance(a, np.ndarray) for a in st_n)
    assert all(isinstance(a, np.ndarray) for a in dec)
    st_j, dec_j = t_ctl.control_decide(cfg, st0, impl="jit", **kw)
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu"
               for a in st_j)
    assert all(isinstance(a, np.ndarray) for a in dec_j)
    with pytest.raises(ValueError, match="bad impl"):
        t_ctl.control_decide(cfg, st0, impl="xla", **kw)


def test_donated_state_survives_a_second_caller():
    """Two callers of one cached step (same config and padded Q): the
    first caller's donated state is kept, as the reference's donation
    keeps each caller's own buffers."""
    cfg = t_ctl.ControlConfig(confirm_ticks=3, block_q=8,
                              cooldown_ticks=9)      # fresh cache key
    kw = dict(mu=[50.0, 50.0], ready=[True, True], replicas=[1, 1],
              caps=[64, 64], impl="jit")
    a = t_ctl.control_init(cfg, 2, device="cpu")
    b = t_ctl.control_init(cfg, 2, device="cpu")
    a, _ = t_ctl.control_decide(cfg, a, lam=[100.0, 100.0], **kw)
    a_agree = a.rep_agree.clone()
    b, _ = t_ctl.control_decide(cfg, b, lam=[10.0, 10.0], **kw)
    np.testing.assert_array_equal(a.rep_agree.numpy(), a_agree.numpy())
    a, _ = t_ctl.control_decide(cfg, a, lam=[100.0, 100.0], **kw)
    np.testing.assert_array_equal(a.rep_agree.numpy(), [2, 2])


def test_ragged_fleets_share_one_decision_step():
    """The jit form pads the queue axis to block_q, so ragged fleet sizes
    share one cached step: the build count rises once."""
    cfg = t_ctl.ControlConfig(confirm_ticks=1, block_q=16,
                              cooldown_ticks=7)      # fresh cache key

    def run(q):
        t_ctl.control_decide(cfg, t_ctl.control_init(cfg, q, device="cpu"),
                             lam=np.full(q, 100.0), mu=np.full(q, 50.0),
                             ready=np.ones(q, bool), replicas=np.ones(q),
                             caps=np.full(q, 64), impl="jit", donate=True)

    base = t_ctl.control_decide_trace_count()
    run(3)
    warm = t_ctl.control_decide_trace_count()
    assert warm == base + 1
    for q in (5, 9, 16, 2, 11):
        run(q)
    assert t_ctl.control_decide_trace_count() == warm
    run(17)                              # the next padded size: one build
    assert t_ctl.control_decide_trace_count() == warm + 1


def test_public_names_match_the_reference():
    assert t_ctl.__all__ == j_ctl.__all__
    assert t_streams.__all__ == j_streams.__all__
    for name in t_ctl.__all__:
        assert hasattr(t_ctl, name), name


# -- the trace replay ----------------------------------------------------------

class _ReplayActuator:
    """The reference's ``ReplayActuator``: recorded observations back to
    the loop, actuation verbs recorded and never applied."""

    def __init__(self, trace):
        self.trace = trace
        self.k = 0
        self.actions = []

    def replicas(self):
        return np.asarray(self.trace.replicas[self.k], np.int64)

    def capacities(self):
        return np.asarray(self.trace.caps[self.k], np.int64)

    def occupancy(self):
        return np.asarray(self.trace.occupancy[self.k], float)

    def scale(self, i, n):
        self.actions.append((self.k, "scale", int(i), int(n)))
        return "applied"

    def resize(self, i, cap):
        self.actions.append((self.k, "resize", int(i), int(cap)))
        return "applied"

    def admit(self, i, shed):
        self.actions.append((self.k, "admit", int(i), bool(shed)))
        return "applied"


def _port_policies(jps):
    """The reference PolicySet rebuilt from the port's policy objects."""
    rep = buf = adm = None
    if jps.replica is not None:
        c = jps.replica.ctrl
        rep = t_ctl.ReplicaPolicy(t_controller.ParallelismController(
            headroom=c.headroom, max_replicas=c.max_replicas))
    if jps.buffer is not None:
        tu = jps.buffer.tuner
        buf = t_ctl.BufferPolicy(t_controller.BufferAutotuner(
            target_frac=tu.target_frac, resize_factor=tu.resize_factor,
            min_capacity=tu.min_capacity, max_capacity=tu.max_capacity))
    if jps.admission is not None:
        a = jps.admission
        adm = t_ctl.AdmissionPolicy(
            t_controller.StragglerDetector(threshold=a.detector.threshold,
                                           min_hosts=a.detector.min_hosts),
            mode=a.mode, collapse_frac=a.collapse_frac,
            recover_frac=a.recover_frac, occupancy_hi=a.occupancy_hi,
            occupancy_lo=a.occupancy_lo)
    ps = t_ctl.PolicySet(replica=rep, buffer=buf, admission=adm, **{
        f: getattr(jps, f) for f in ("confirm_ticks", "cooldown_ticks",
                                     "block_q", "probe_period_ticks",
                                     "probe_window_ticks")})
    assert (dataclasses.asdict(ps.control_config())
            == dataclasses.asdict(jps.control_config()))
    return ps


def _replay_on_port(trace, policies, impl):
    """``repro.workloads.trace.replay`` on the port: a fresh
    ``FleetMonitorService(impl="rounds")`` + ``ControlLoop`` re-driven
    from the recorded sensing stream."""
    meta = trace.meta
    nq = trace.n_queues
    arena = CounterArena(max(8, 4 * nq))
    queues = [InstrumentedQueue(8, arena=arena) for _ in range(nq)]
    svc = FleetMonitorService(
        queues, MonitorConfig(window=int(meta["window"]),
                              min_q_samples=int(meta["min_q_samples"])),
        period_s=float(meta["period_s"]), chunk_t=int(meta["decide_every"]),
        scale_to_period=False, ends="both", impl="rounds", device="cpu")
    act = _ReplayActuator(trace)
    loop = t_ctl.ControlLoop(svc, policies, act, impl=impl)
    loop.warmup()
    every = int(meta["decide_every"])
    out = {f: [] for f in DECISION_FIELDS}
    k = 0
    try:
        for t in range(trace.counters.shape[0]):
            for qi, q in enumerate(queues):
                tt, tb, ht, hb = trace.counters[t, qi]
                q.tail.tc, q.tail.blocked = float(tt), bool(tb)
                q.head.tc, q.head.blocked = float(ht), bool(hb)
            if trace.sampled[t]:
                svc.sample()
            if t % every == every - 1 and k < len(trace.tick_at):
                act.k = k
                dec = loop.tick()
                for f in DECISION_FIELDS:
                    out[f].append(np.asarray(getattr(dec, f)))
                k += 1
        svc.flush()
    finally:
        svc.stop()
    assert loop.health()["impl_degraded"] is False
    return {f: np.stack(v) for f, v in out.items()}


@pytest.fixture(scope="module")
def recorded():
    cell = run_cell("step", "full", "storm", seed=5, quick=True, record=True)
    assert cell.trace is not None
    return cell.trace


@pytest.mark.parametrize("impl", ["numpy", "jit"])
def test_trace_replay_reproduces_decisions_bit_for_bit(recorded, impl):
    tr = recorded
    ps = _port_policies(make_policies("full",
                                      decide_every=tr.meta["decide_every"]))
    out = _replay_on_port(tr, ps, impl)
    acted = 0
    for f, want in tr.decisions.items():
        assert out[f].dtype.kind in "biu"
        assert np.array_equal(out[f], want), f"replay diverged on {f}"
        if f.endswith("_mask"):
            acted += int(want.sum())
    assert acted, "the recorded run must actuate"


# -- the loop's hardening -------------------------------------------------------

def _service(nq, chunk_t=16):
    arena = CounterArena(2 * nq)
    queues = [InstrumentedQueue(8, arena=arena) for _ in range(nq)]
    svc = FleetMonitorService(queues, CFG, period_s=1e-3, chunk_t=chunk_t,
                              scale_to_period=False, ends="both",
                              impl="rounds", device="cpu")
    return svc, queues


def _feed(svc, queues, head_tc, tail_tc, n):
    for _ in range(n):
        for q in queues:
            q.head.tc = float(head_tc)
            q.tail.tc = float(tail_tc)
        svc.sample()
    svc.flush()


class _Actuator:
    """Records actuations; ``scale`` raises while ``raising`` is set."""

    def __init__(self, nq, raising=False):
        self.nq = nq
        self.raising = raising
        self.attempts = 0
        self.calls = []

    def replicas(self):
        return np.ones(self.nq, np.int64)

    def capacities(self):
        return np.full(self.nq, 64, np.int64)

    def occupancy(self):
        return np.zeros(self.nq)

    def scale(self, i, n):
        self.attempts += 1
        if self.raising:
            raise RuntimeError("actuator wedged")
        self.calls.append(("scale", i, n))
        return "applied"

    def resize(self, i, cap):
        return "applied"

    def admit(self, i, shed):
        return "applied"


@pytest.mark.parametrize("impl", ["numpy", "jit"])
def test_loop_scales_after_confirmation(impl):
    """A converged 2x overload scales after confirm_ticks agreeing
    decisions to ceil(1.2 * 100 / 50) = 3, audited."""
    svc, queues = _service(2)
    act = _Actuator(2)
    loop = t_ctl.ControlLoop(svc, t_ctl.PolicySet(
        replica=t_ctl.ReplicaPolicy()), act, impl=impl)
    _feed(svc, queues, head_tc=50.0, tail_tc=100.0, n=200)
    assert (svc.gated_rates() > 0).all()
    for _ in range(loop.cfg.confirm_ticks + 1):
        loop.tick()
    assert act.calls and all(c[2] == 3 for c in act.calls)
    recs = loop.log.by_policy("replicas")
    assert recs and recs[0].outcome == "applied" and recs[0].value == 3
    svc.stop()


def test_loop_sense_quarantine():
    svc, queues = _service(2)
    loop = t_ctl.ControlLoop(svc, t_ctl.PolicySet(
        replica=t_ctl.ReplicaPolicy()), _Actuator(2))
    _feed(svc, queues, head_tc=50.0, tail_tc=100.0, n=200)
    loop.tick()                        # establishes last-good estimates
    good_mu = loop._last_good_mu.copy()
    assert (good_mu > 0).all()
    orig = svc.gated_rates
    svc.gated_rates = lambda: np.full(4, np.nan)
    try:
        loop.tick()                    # must not poison the decision
    finally:
        svc.gated_rates = orig
    assert loop.quarantined == 4
    assert np.allclose(loop._last_good_mu, good_mu)
    recs = [r for r in loop.log.records() if r.error == "E_SENSE_NAN"]
    assert recs and recs[0].outcome == "observed"
    loop.tick()
    assert loop.quarantined == 4
    svc.stop()


def test_loop_actuator_raise_is_retried_and_audited():
    svc, queues = _service(2)
    act = _Actuator(2, raising=True)
    loop = t_ctl.ControlLoop(svc, t_ctl.PolicySet(
        replica=t_ctl.ReplicaPolicy()), act, actuation_retries=2,
        actuation_backoff_s=1e-4)
    _feed(svc, queues, head_tc=50.0, tail_tc=100.0, n=200)
    for _ in range(loop.cfg.confirm_ticks + 2):
        loop.tick()                    # must not raise
    assert act.attempts >= 3           # 1 try + 2 retries on first fire
    errs = [r for r in loop.log.records() if r.outcome == "error"]
    assert errs and all(r.error == "E_ACT_RAISE" for r in errs)
    assert loop.health()["actuation_errors"] >= 1
    svc.stop()


def test_loop_admission_failure_rolls_back():
    svc, _ = _service(1)

    class BadAdmit(_Actuator):
        def __init__(self, nq):
            super().__init__(nq)
            self.reverts = []

        def admit(self, i, shed):
            if not shed:               # the rollback revert is allowed
                self.reverts.append(i)
                return "applied"
            raise RuntimeError("gate wedged")

    act = BadAdmit(1)
    loop = t_ctl.ControlLoop(svc, t_ctl.PolicySet(
        admission=t_ctl.AdmissionPolicy()), act, actuation_retries=0)
    z, zb = np.zeros(1, np.int32), np.zeros(1, bool)
    dec = t_ctl.Decision(target_replicas=z, scale_mask=zb, target_caps=z,
                         resize_mask=zb, shed=np.ones(1, bool),
                         straggler=zb, probing=zb, slo_hot=zb)
    loop._actuate(dec, np.zeros(1), np.zeros(1), np.ones(1, np.int64),
                  np.full(1, 64, np.int64))
    assert not loop._shed.any()
    assert act.reverts == [0]
    errs = [r for r in loop.log.records() if r.outcome == "error"]
    assert errs and errs[0].error == "E_ACT_RAISE"
    svc.stop()


def test_loop_jit_failure_degrades_to_numpy(monkeypatch):
    """Repeated failures of the jit form degrade the loop to the numpy
    form of the same math: audited, never silent, and the decisions go
    on (the scale still fires)."""
    svc, queues = _service(2)
    act = _Actuator(2)
    loop = t_ctl.ControlLoop(svc, t_ctl.PolicySet(
        replica=t_ctl.ReplicaPolicy()), act, impl="jit", jit_fail_limit=2)
    _feed(svc, queues, head_tc=50.0, tail_tc=100.0, n=200)
    real = t_loop.control_decide

    def failing(*a, impl="auto", **kw):
        if impl == "jit":
            raise RuntimeError("device lost")
        return real(*a, impl=impl, **kw)

    monkeypatch.setattr(t_loop, "control_decide", failing)
    loop.tick()
    assert not loop.impl_degraded
    assert all(isinstance(a, np.ndarray) for a in loop.state)
    loop.tick()
    assert loop.impl_degraded
    h = loop.health()
    assert h["jit_failures"] == 2 and h["impl_degraded"] is True
    recs = [r for r in loop.log.records() if r.error == "E_JIT_DISPATCH"]
    assert len(recs) == 1 and recs[0].action == "impl-degrade"
    assert act.calls and all(c[2] == 3 for c in act.calls)
    monkeypatch.setattr(t_loop, "control_decide", real)
    loop.tick()                        # degraded: the numpy form only
    assert loop._jit_fail == 2
    svc.stop()


class _MonitorDeath:
    """A duck-typed fault plan: the monitor thread's tick loop exits
    silently on its first tick."""

    def __init__(self):
        self.armed = True

    def monitor_death_due(self):
        due, self.armed = self.armed, False
        return due

    def skew_factor(self, now):
        return 1.0

    def maybe_fault(self, host, aliases=()):
        return None


def test_watchdog_restarts_dead_monitor_preserving_state():
    pipe = Pipeline([Stage("src", source=range(10)),
                     Stage("work", fn=lambda x: x)],
                    capacity=8, arena=CounterArena(8), control=True,
                    monitor_cfg=CFG, fault_plan=_MonitorDeath(),
                    device="cpu")
    old, svc = pipe.monitor, pipe.fleet
    old.start()
    old.join(timeout=10)               # injected silent death
    assert not old.is_alive() and not old._stop_evt.is_set()
    assert pipe.control.check_monitor()
    try:
        assert pipe.monitor is not old and pipe.monitor.is_alive()
        assert pipe.fleet is svc       # estimator state survived
        assert pipe.control.health()["monitor_restarts"] == 1
        recs = [r for r in pipe.control.log.records()
                if r.policy == "watchdog"]
        assert recs and recs[0].error == "E_MONITOR_DEAD"
        assert not pipe.control.check_monitor()
    finally:
        pipe.monitor.stop()


def test_loop_thread_contains_tick_errors():
    svc, _ = _service(1)
    loop = t_ctl.ControlLoop(svc, t_ctl.PolicySet(
        replica=t_ctl.ReplicaPolicy()), _Actuator(1), period_s=1e-3)
    svc.gated_rates = lambda: (_ for _ in ()).throw(RuntimeError("boom"))
    loop.start()
    deadline = time.monotonic() + 10
    while loop.tick_errors == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    loop.stop()
    assert not loop.is_alive()
    assert loop.health()["tick_errors"] >= 1
    assert any(r.error == "E_TICK" for r in loop.log.records())
    svc.stop()


def test_stop_flush_safe_during_actuation():
    svc, queues = _service(2)

    class Slow(_Actuator):
        def resize(self, i, cap):
            time.sleep(2e-3)
            return "applied"

    loop = t_ctl.ControlLoop(svc, t_ctl.PolicySet(
        buffer=t_ctl.BufferPolicy(), confirm_ticks=1, cooldown_ticks=0),
        Slow(2))
    _feed(svc, queues, head_tc=100.0, tail_tc=50.0, n=200)
    errs = []

    def hammer():
        try:
            for _ in range(30):
                svc.flush()
                time.sleep(5e-4)
            svc.stop()
        except Exception as e:          # noqa: BLE001
            errs.append(e)

    t = threading.Thread(target=hammer, daemon=True)
    t.start()
    for _ in range(20):
        loop.tick()
    t.join(timeout=30)
    assert not t.is_alive() and not errs
    assert svc.sample() is False
