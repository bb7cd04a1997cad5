"""The port's ``streams.Pipeline``, ``serve.Engine(control=True)`` and
``control.ControlGroup`` on the CPU: twins of the JAX package's tests of
the closed loop (``tests/test_control.py``), run with ``device="cpu"``.

Items must come out exactly (scale-up and retire while items flow lose
nothing), the advisory readouts must delegate to the policy objects the
loop actuates, the engine's admission gate must shed and readmit under
its loop, and one group must span two pipelines and an engine.  Every
threaded run has a join timeout.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.control import (AdmissionPolicy, BufferPolicy,
                                 ControlGroup, ControlLoop, PolicySet,
                                 ReplicaPolicy,
                                 control_decide_trace_count)
from repro_torch.core.monitor import MonitorConfig
from repro_torch.models import build_model
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.streams import (STOP, CounterArena, InstrumentedQueue,
                                 Pipeline, Stage)

torch.set_num_threads(1)

CFG = MonitorConfig(window=16, min_q_samples=16)


def test_closed_loop_pipeline_runs_end_to_end():
    """A control=True pipeline runs sense -> decide -> actuate live (loop
    thread + fused decision + actuator) and still produces exact
    results."""
    pipe = Pipeline([Stage("src", source=range(3000)),
                     Stage("x3", fn=lambda x: x * 3)], capacity=64,
                    base_period_s=1e-3, control=True, monitor_cfg=CFG,
                    device="cpu")
    assert pipe.autotune is False       # the loop owns actuation
    assert isinstance(pipe.control, ControlLoop)
    out = pipe.run_collect(timeout_s=120)
    assert sorted(out) == [3 * i for i in range(3000)]
    assert not pipe.control.is_alive() and not pipe.monitor.is_alive()
    assert all(r.outcome in ("applied", "rejected", "noop")
               for r in pipe.control.log)
    assert pipe.stats()["crash_count"] == 0


def test_closed_loop_pipeline_scales_a_slow_stage():
    """The reference's closed-loop demo at test size: a stage that takes
    a little time per item is scaled up by its loop, and nothing is
    lost.  The source runs until the loop has applied a scale-up (then
    400 items more, so the new replicas serve some), or for 60 s: how
    many items the loop needs to converge and act depends on how fast
    the host runs, so a fixed count would race the loop's first ticks."""
    def heavy(x):
        time.sleep(4e-4)
        return x + 1

    def scaled_up():
        return any(r.outcome == "applied" and r.value > 1
                   for r in pipe.control.log.by_policy("replicas"))

    produced = [0]

    def source():
        deadline = time.monotonic() + 60.0
        tail = None                      # items left after the scale-up
        while tail != 0 and time.monotonic() < deadline:
            if tail is None and produced[0] % 64 == 0 and scaled_up():
                tail = 400
            yield produced[0]
            produced[0] += 1
            if tail is not None:
                tail -= 1

    pipe = Pipeline([Stage("src", source=source()),
                     Stage("heavy", fn=heavy)], capacity=64,
                    base_period_s=1e-3, control=True, monitor_cfg=CFG,
                    device="cpu")
    pipe.fleet.warmup()
    pipe.control.warmup()
    out = pipe.run_collect(timeout_s=120)
    n = produced[0]
    assert sorted(out) == [i + 1 for i in range(n)]
    h = pipe.control.health()
    assert h["ticks"] >= 1 and h["tick_errors"] == 0
    assert not h["impl_degraded"]
    scaled = [r.value for r in pipe.control.log.by_policy("replicas")
              if r.outcome == "applied"]
    assert scaled and max(scaled) > 1, "the loop must scale the stage up"
    assert pipe.stats()["crash_count"] == 0


def test_live_scale_up_and_retire_drain_without_loss():
    """Spawn extra workers mid-run, then retire most of them mid-run;
    every item is processed exactly once."""
    n = 6000
    pipe = Pipeline([Stage("src", source=range(n)),
                     Stage("work", fn=lambda x: x * 2, replicas=3)],
                    capacity=32, arena=CounterArena(16), device="cpu")
    got = {"ok": False}

    def scaler():
        time.sleep(0.05)
        assert pipe.scale_stage("work", 5) == "applied"
        time.sleep(0.05)
        assert pipe.scale_stage(1, 1) == "applied"
        got["ok"] = True

    t = threading.Thread(target=scaler, daemon=True)
    t.start()
    out = pipe.run_collect(timeout_s=120)
    t.join(timeout=10)
    assert got["ok"]
    assert sorted(out) == [2 * i for i in range(n)]
    assert pipe.live_replicas("work") == 1


def test_scale_stage_guards():
    pipe = Pipeline([Stage("src", source=range(4)),
                     Stage("id", fn=lambda x: x)], capacity=8,
                    arena=CounterArena(8), device="cpu")
    assert pipe.scale_stage("src", 2) == "rejected"   # source stage
    assert pipe.scale_stage("id", 0) == "rejected"    # n < 1
    assert pipe.scale_stage("id", 1) == "noop"        # already there
    assert pipe.scale_stage("id", 4) == "applied"     # pre-start intent
    assert pipe.live_replicas("id") == 4
    out = pipe.run_collect(timeout_s=60)
    assert sorted(out) == list(range(4))
    assert STOP not in out


def test_pipeline_advisory_delegates_to_policy():
    pipe = Pipeline([Stage("src", source=range(10)),
                     Stage("id", fn=lambda x: x)], capacity=8,
                    arena=CounterArena(8), device="cpu")
    lam = pipe.fleet.arrival_rates()
    mu = pipe.fleet.service_rates()
    want = pipe.replica_policy.targets(lam, mu)
    assert pipe.recommended_replicas() == {"id": int(want[0])}
    assert set(pipe.rates()) == {"src->id", "id->sink"}
    pipe.fleet.stop()


def test_pipeline_rejects_control_without_monitor():
    with pytest.raises(ValueError, match="monitor=False"):
        Pipeline([Stage("src", source=range(2)),
                  Stage("id", fn=lambda x: x)], control=True,
                 monitor=False, arena=CounterArena(8), device="cpu")


# -- serve.Engine with its control loop ----------------------------------------

@pytest.fixture(scope="module")
def smoke_model():
    cfg = get_smoke_config("internlm2-1.8b")
    model = build_model(cfg, torch.float32)
    params = model.init_params(torch.Generator().manual_seed(0),
                               torch.float32, device="cpu")
    return model, params


def test_engine_control_loop_sheds_submits(smoke_model):
    """serve.Engine + control=True on a smoke-size dense model: the loop
    ticks over the lanes, a shut gate makes submit() reject at once,
    reopening admits again, and requests are answered."""
    model, params = smoke_model
    eng = Engine(model, params,
                 ServeConfig(batch_size=2, max_seq=32, queue_capacity=8),
                 control=True, device="cpu")
    assert isinstance(eng.control, ControlLoop)
    assert eng.admission_state()["shedding"] is False
    eng.start()
    try:
        req = Request(rid=0, tokens=np.arange(1, 5, dtype=np.int32),
                      max_new=2)
        assert eng.submit(req)
        assert req.done.wait(timeout=60)
        assert req.out.shape == (2,)
        eng.gate.set_shed(True)
        assert not eng.submit(Request(rid=1, tokens=np.ones(4, np.int32)))
        assert eng.admission_state()["shed_count"] == 1
        eng.gate.set_shed(False)
        req2 = Request(rid=2, tokens=np.ones(4, np.int32), max_new=2)
        assert eng.submit(req2)
        assert req2.done.wait(timeout=60)
        deadline = time.monotonic() + 30
        while eng.control.ticks == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.control.ticks >= 1
        # capacity advice delegates to the loop's own BufferPolicy
        assert eng.recommended_queue_capacity() == 8
    finally:
        eng.stop()
    assert not eng.control.is_alive()
    h = eng.control.health()
    assert h["tick_errors"] == 0 and not h["impl_degraded"]
    assert not [r for r in eng.control.log.records()
                if r.error and r.policy != "qos"]


# -- the multi-tenant group -----------------------------------------------------

class _FakeActuator:
    def __init__(self, q, caps=64, reps=1):
        self.reps = np.full(q, reps, np.int64)
        self.caps = np.full(q, caps, np.int64)
        self.calls = []

    def replicas(self):
        return self.reps.copy()

    def capacities(self):
        return self.caps.copy()

    def occupancy(self):
        return np.zeros(len(self.reps))

    def scale(self, i, n):
        self.calls.append(("scale", i, n))
        self.reps[i] = n
        return "applied"

    def resize(self, i, cap):
        self.caps[i] = cap
        return "applied"

    def admit(self, i, shed):
        return "applied"


def _raw_tenant(arena, n):
    return ([InstrumentedQueue(8, arena=arena) for _ in range(n)],
            _FakeActuator(n))


class _Cfg:
    vocab_size = 16


class _FakeModel:
    cfg = _Cfg()

    def prefill(self, params, batch):
        raise NotImplementedError

    def decode_step(self, params, cache, tok, pos):
        raise NotImplementedError


def test_control_group_spans_pipelines_and_engine():
    """Two monitor=False pipelines + one monitor=False engine share one
    arena and one ControlGroup; items flow exactly, advisory readouts
    ride the bound tenant views, the engine's admission gate is
    actuated through the composite, and detached tenants can close
    their queues."""
    arena = CounterArena(32)
    group = ControlGroup(
        PolicySet(replica=ReplicaPolicy(), buffer=BufferPolicy(),
                  admission=AdmissionPolicy(), block_q=8),
        arena=arena, monitor_cfg=CFG, period_s=1e-3, chunk_t=8,
        device="cpu")
    pa = Pipeline([Stage("srcA", source=range(2000)),
                   Stage("wA", fn=lambda x: x * 2)], capacity=32,
                  arena=arena, monitor=False, device="cpu")
    pb = Pipeline([Stage("srcB", source=range(1000)),
                   Stage("wB", fn=lambda x: x + 1)], capacity=32,
                  arena=arena, monitor=False, device="cpu")
    eng = Engine(_FakeModel(), None, ServeConfig(queue_capacity=8),
                 arena=arena, monitor=False, device="cpu")
    with pytest.raises(RuntimeError, match="externally monitored"):
        pa.rates()
    group.attach(pa, name="A")
    group.attach(pb, name="B")
    h_eng = group.attach(eng, policies=PolicySet(
        buffer=BufferPolicy(), admission=AdmissionPolicy()),
        name="engine")
    group.start()
    out_a = pa.run_collect(timeout_s=120)
    out_b = pb.run_collect(timeout_s=120)
    assert sorted(out_a) == [2 * i for i in range(2000)]
    assert sorted(out_b) == [i + 1 for i in range(1000)]
    assert set(pa.rates()) == {"srcA->wA", "wA->sink"}
    assert isinstance(pa.recommended_replicas(), dict)
    assert eng.service_rate() >= 0.0
    eng_idx = len(pa.queues) + len(pb.queues)
    assert group.actuator.admit(eng_idx, True) == "applied"
    assert eng.gate.shedding
    group.actuator.admit(eng_idx, False)
    assert all(r.outcome in ("applied", "rejected", "noop")
               for r in group.log)
    group.detach(h_eng)
    with pytest.raises(RuntimeError, match="externally monitored"):
        eng.service_rate()
    group.stop()
    assert not group.loop.is_alive() and not group.monitor.is_alive()
    eng.queue.close()                    # detached + stopped: unpinned


def test_group_attach_detach_keeps_decision_step_flat():
    """Ragged tenant churn under impl='jit' builds the decision step
    once: per-tenant differences ride as operands and the queue axis
    pads to one block_q multiple."""
    arena = CounterArena(32)
    group = ControlGroup(
        PolicySet(replica=ReplicaPolicy(), block_q=8, confirm_ticks=3,
                  cooldown_ticks=6),     # distinct knobs: own cache key
        arena=arena, monitor_cfg=CFG, period_s=1e-3, chunk_t=8,
        scale_to_period=False, impl="jit", device="cpu")
    h1 = group.attach(_raw_tenant(arena, 2), name="t1")
    group.tick()
    warm = control_decide_trace_count()
    h2 = group.attach(_raw_tenant(arena, 3), name="t2")
    group.tick()
    group.detach(h1)
    group.tick()
    group.attach(_raw_tenant(arena, 1), name="t3")
    group.tick()
    group.detach(h2)
    group.tick()
    assert control_decide_trace_count() == warm
    group.service.stop()


def test_group_remap_preserves_tenant_gating_state():
    """Detaching one tenant keeps another's half-built confirmation
    counter: it fires on schedule, not one tick late."""
    arena = CounterArena(16)
    group = ControlGroup(
        PolicySet(replica=ReplicaPolicy(), confirm_ticks=2,
                  cooldown_ticks=0, block_q=8),
        arena=arena, monitor_cfg=CFG, period_s=1e-3, chunk_t=4,
        scale_to_period=False, impl="jit", device="cpu")
    qa, acta = _raw_tenant(arena, 1)
    qb, actb = _raw_tenant(arena, 1)
    ha = group.attach((qa, acta), name="a")
    group.attach((qb, actb), name="b")
    for _ in range(200):
        qa[0].head.tc = qa[0].tail.tc = 50.0
        qb[0].head.tc, qb[0].tail.tc = 50.0, 100.0
        group.service.sample()
    group.service.flush()
    group.tick()                         # b: rep_agree = 1 (of 2)
    assert not actb.calls
    group.detach(ha)                     # restructure mid-confirmation
    group.tick()                         # b: rep_agree = 2 -> fires now
    assert actb.calls == [("scale", 0, 3)]
    group.service.stop()


def test_group_rejects_self_monitoring_tenant_and_stray_legs():
    arena = CounterArena(16)
    group = ControlGroup(PolicySet(replica=ReplicaPolicy(), block_q=8),
                         arena=arena, monitor_cfg=CFG, device="cpu")
    pipe = Pipeline([Stage("src", source=range(4)),
                     Stage("id", fn=lambda x: x)], capacity=8,
                    arena=arena, device="cpu")   # monitor=True: its own
    with pytest.raises(ValueError, match="monitor=False"):
        group.attach(pipe)
    pipe.fleet.stop()
    with pytest.raises(ValueError, match="superset"):
        group.attach(_raw_tenant(arena, 1),
                     policies=PolicySet(admission=AdmissionPolicy()))
    group.service.stop()
