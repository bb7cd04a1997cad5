"""The port's scenario foundry (``repro_torch.workloads``) against the
JAX package's (``repro.workloads``), on the CPU.

The modules are numpy over the port's control plane, so the same seeds
must give the same numbers: arrival envelopes equal on a t grid, the
simulated tandems' counters array-equal draw for draw, the sim-time
storm driver firing the same events, a matrix cell's row equal (ints
equal, floats within 1e-12) with the port's ``ControlGroup`` on the CPU
against the reference's, and traces crossing between the packages: one
package records, the other loads it and replays every decision field bit
for bit.  The cells run at the scenarios' own quick horizons.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.ft as j_ft
import repro.workloads as j_w
import repro_torch.ft as t_ft
import repro_torch.workloads as t_w
from repro_torch.core import device as t_device

torch.set_num_threads(1)


# -- arrival envelopes -------------------------------------------------------

def _envelopes(w):
    """The reference test's envelopes and compositions, built from one
    package's classes."""
    return {
        "step": w.Step(60, 15, at=100),
        "ramp": w.Ramp(0, 10, t0=0, t1=10),
        "square": w.Square(160, 40, period=200),
        "square_shift": w.Square(160, 40, period=200).shift(100),
        "diurnal": w.Diurnal(base=100, amplitude=60, period=400),
        "diurnal_floor": w.Diurnal(base=10, amplitude=60, period=400,
                                   phase=25.0),
        "boxcar": w.Boxcar(50, t0=10, t1=20),
        "flash": w.FlashCrowd(peak=300, at=100, rise=50, fall=20),
        "sum": w.Constant(100) + w.Boxcar(50, 10, 20),
        "product": 2.5 * w.Constant(10) * w.Ramp(1, 3, 0, 50),
        "clip": w.Ramp(0, 100, 0, 10).clip(20, 80),
        "day_with_crowd": (w.Diurnal(base=90.0, amplitude=50.0,
                                     period=1600.0)
                           + w.FlashCrowd(peak=260.0, at=880.0, rise=64.0,
                                          fall=192.0)),
    }


@pytest.mark.parametrize("name", sorted(_envelopes(t_w)))
def test_envelopes_equal_the_reference(name):
    t = np.concatenate([np.linspace(-50, 2000, 4101), [10.0, 20.0, 100.0]])
    got = _envelopes(t_w)[name]
    want = _envelopes(j_w)[name]
    assert [got(x) for x in t] == [want.rate(x) for x in t]


def test_envelope_validation_matches():
    for cls, args in ((t_w.Ramp, (0, 1, 5, 5)), (t_w.Square, (1, 0, 0)),
                      (t_w.FlashCrowd, (1, 0, 0, 1)),
                      (t_w.Boxcar, (1, 3, 3)),
                      (t_w.Diurnal, (1, 1, 0))):
        with pytest.raises(ValueError):
            cls(*args)
    with pytest.raises(ValueError):
        t_w.ParetoService(60.0, alpha=1.0)


# -- simulated tandems -------------------------------------------------------

def _drive_sim(w, service, knobs, seed=7, T=400):
    """Step one package's SimTandem through a fault-knob schedule;
    returns every counter tuple and the end-of-run totals."""
    svc = (w.ParetoService(w.Constant(60.0), alpha=1.25)
           if service == "pareto" else w.Constant(60.0))
    sim = w.SimTandem(seed, w.Square(160.0, 40.0, 50.0), svc, 2, 64)
    rows = []
    for t in range(T):
        if knobs and t == 100:
            sim.kill_replica()
            sim.stalled = 1
            sim.stall_scale = 0.5
        if knobs and t == 200:
            sim.stalled = 0
            sim.meas_scale = 0.5
            sim.shedding = True
        if knobs and t == 300:
            sim.meas_scale = 1.0
            sim.shedding = False
        rows.append(sim.step(float(t)) + (sim.wait, sim.occ_high))
    return rows, (sim.served_total, sim.offered_total, sim.shed_total,
                  sim.backlog, sim.replicas, sim.killed)


@pytest.mark.parametrize("service", ["poisson", "pareto"])
@pytest.mark.parametrize("knobs", [False, True], ids=["clean", "faults"])
def test_sim_tandem_counters_equal_the_reference(service, knobs):
    got, got_tot = _drive_sim(t_w, service, knobs)
    want, want_tot = _drive_sim(j_w, service, knobs)
    assert np.array_equal(np.array(got, float), np.array(want, float))
    assert got_tot == want_tot
    assert got_tot[0] > 0


def test_sim_actuator_verbs_equal_the_reference():
    def drive(w, ft):
        sim = w.SimTandem(0, w.Constant(100), w.Constant(60), 2, 64)
        act = w.SimActuator(sim, fail_verbs={"scale": 1, "admit": 1})
        log = []
        for verb, args in (("scale", (0, 5)), ("scale", (0, 5)),
                           ("resize", (0, 128)), ("admit", (0, True)),
                           ("admit", (0, True)), ("resize", (0, 8))):
            sim.backlog = 16
            try:
                log.append(getattr(act, verb)(*args))
            except ft.InjectedFault:
                log.append("raised")
        return (log, act.actions, sim.replicas, sim.capacity, sim.shedding,
                act.fail_verbs, act.replicas().tolist(),
                act.capacities().tolist(), act.occupancy().tolist())

    assert drive(t_w, t_ft) == drive(j_w, j_ft)


# -- the sim-time storm driver -----------------------------------------------

def _storm_run(w, ft):
    E = ft.FaultEvent
    plan = ft.FaultPlan([
        E(2.0, "crash", "a"), E(4.0, "stall", "a", duration_s=3.0),
        E(5.0, "actuation", "scale"), E(5.0, "actuation", "resize"),
        E(6.0, "monitor_death", duration_s=2.0),
        E(8.0, "clock_skew", duration_s=2.0, factor=2.0)])
    fail = {}
    drv = w.StormDriver(plan, fail)
    sims = {"a": w.SimTandem(0, w.Constant(10), w.Constant(10), 3, 64),
            "b": w.SimTandem(1, w.Constant(10), w.Constant(10), 3, 64)}
    acts = [w.SimActuator(s, fail_verbs=fail) for s in sims.values()]
    trail = []
    for t in np.arange(0.0, 12.0, 0.5):
        alive = drv.apply(float(t), sims)
        raised = []
        for a in acts:
            try:
                a.scale(0, 3)
                raised.append(False)
            except ft.InjectedFault:
                raised.append(True)
        trail.append((float(t), alive, raised,
                      [(s.replicas, s.stalled, s.meas_scale)
                       for s in sims.values()], dict(fail)))
    return trail, drv.fired_kinds, plan.fired()


def test_storm_driver_fires_as_the_reference():
    got, got_kinds, got_fired = _storm_run(t_w, t_ft)
    want, want_kinds, _ = _storm_run(j_w, j_ft)
    assert got == want
    assert got_kinds == want_kinds == [
        "crash", "stall", "actuation", "actuation", "monitor_death"]
    assert got_fired == []               # the plan's wall-clock API is pure


# -- matrix cells ------------------------------------------------------------

CELLS = [("step", "full", "storm", 5), ("bursty", "replica", "none", 0),
         ("flash_crowd", "full", "storm", 0),
         ("pareto_tail", "static", "storm", 0),
         ("antiphase", "full", "crash_storm", 1),
         ("drift", "replica", "act_fail", 2)]

_FLOATS = ("sustained", "availability", "delay_p99", "shed_fraction")


@pytest.mark.parametrize("scenario,policy,fault,seed", CELLS)
def test_run_cell_row_equals_the_reference(scenario, policy, fault, seed):
    """The key test: the port's cell, its ControlGroup on the CPU, gives
    the reference's row (ints equal, floats within 1e-12) and the same
    per-period served and wait series."""
    got = t_w.run_cell(scenario, policy, fault, seed=seed, quick=True,
                       device="cpu")
    want = j_w.run_cell(scenario, policy, fault, seed=seed, quick=True)
    g, w = got.row(), want.row()
    for k in w:
        if isinstance(w[k], float):
            assert g[k] == pytest.approx(w[k], rel=0, abs=1e-12), k
        else:
            assert g[k] == w[k], k
    for f in _FLOATS:
        assert abs(getattr(got, f) - getattr(want, f)) <= 1e-12, f
    assert np.array_equal(got.served, want.served)
    assert np.array_equal(got.wait, want.wait)
    if fault != "none":
        assert got.faults_fired
    if policy != "static":
        assert got.actions > 0


def test_run_matrix_equals_the_reference():
    """A two-scenario slice of the matrix: every row, vs_static too."""
    kw = dict(scenarios=("bursty", "pareto_tail"), faults=("none", "storm"),
              seed=3, quick=True)
    got = t_w.run_matrix(**kw, device="cpu")
    want = j_w.run_matrix(**kw)
    assert got == want
    assert got["n_cells"] == 12


def test_entry_points_run_on_the_card_by_default(monkeypatch):
    """Without a card the default device raises; nothing falls back to
    the CPU."""
    monkeypatch.setattr(t_device.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_w.run_cell("step", "full", "none", quick=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_w.run_matrix(("step",), quick=True)
    tr = t_w.TraceRecorder(1).finish({})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_w.replay(tr, t_w.make_policies("full"))


# -- trace record / replay across the packages -------------------------------

def _decisions_equal(out, trace):
    acted = 0
    for f in t_w.DECISION_FIELDS:
        want = trace.decisions[f]
        assert np.array_equal(out[f], want), f"replay diverged on {f}"
        if f.endswith("_mask"):
            acted += int(np.sum(want))
    assert acted, "the recorded run must actuate"


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """The same recorded cell from both packages, each saved to .npz."""
    d = tmp_path_factory.mktemp("traces")
    j_cell = j_w.run_cell("step", "full", "storm", seed=5, quick=True,
                          record=True)
    t_cell = t_w.run_cell("step", "full", "storm", seed=5, quick=True,
                          record=True, device="cpu")
    return (j_cell.trace.save(d / "reference.npz"),
            t_cell.trace.save(d / "port.npz"))


def test_port_records_the_reference_trace(traces):
    j_tr, t_tr = (j_w.Trace.load(p) for p in traces)
    assert t_tr.meta == j_tr.meta
    for name in ("counters", "sampled", "tick_at", "replicas", "caps",
                 "occupancy"):
        assert np.array_equal(getattr(t_tr, name), getattr(j_tr, name)), \
            name
    for f in t_w.DECISION_FIELDS:
        assert np.array_equal(t_tr.decisions[f], j_tr.decisions[f]), f


@pytest.mark.parametrize("impl", ["numpy", "jit"])
def test_port_replays_a_reference_trace(traces, impl):
    tr = t_w.Trace.load(traces[0])
    assert tr.meta["scenario"] == "step"
    out = t_w.replay(tr, t_w.make_policies(
        "full", decide_every=tr.meta["decide_every"]), impl=impl,
        device="cpu")
    _decisions_equal(out, tr)
    assert out["ticks"] == len(tr.tick_at)
    # the counterfactual: another rung replays against the same record
    cf = t_w.replay(tr, t_w.make_policies(
        "replica", decide_every=tr.meta["decide_every"]), device="cpu")
    assert cf["target_replicas"].shape == tr.decisions[
        "target_replicas"].shape


def test_reference_replays_a_port_trace(traces):
    tr = j_w.Trace.load(traces[1])
    assert tr.meta["scenario"] == "step"
    out = j_w.replay(tr, j_w.make_policies(
        "full", decide_every=tr.meta["decide_every"]))
    _decisions_equal(out, tr)


def test_replay_actions_equal_the_reference(traces):
    """Both replays of one trace issue the same actuation verbs."""
    t_tr = t_w.Trace.load(traces[0])
    j_tr = j_w.Trace.load(traces[0])
    every = t_tr.meta["decide_every"]
    got = t_w.replay(t_tr, t_w.make_policies("full", decide_every=every),
                     device="cpu")
    want = j_w.replay(j_tr, j_w.make_policies("full", decide_every=every))
    assert got["actions"] == want["actions"] and got["actions"]


# -- the scenario axes -------------------------------------------------------

def test_scenario_axes_equal_the_reference():
    assert t_w.POLICIES == j_w.POLICIES
    assert list(t_w.SCENARIOS) == list(j_w.SCENARIOS)
    assert list(t_w.FAULTS) == list(j_w.FAULTS)
    for name, storm in t_w.FAULTS.items():
        assert (dataclasses.asdict(storm)
                == dataclasses.asdict(j_w.FAULTS[name]))
        for T in (1200, 4800):
            got = storm.build(11, T, ["a", "b"])
            want = j_w.FAULTS[name].build(11, T, ["a", "b"])
            assert (got is None) == (want is None)
            if got is not None:
                assert got.events() == tuple(
                    t_ft.FaultEvent(**dataclasses.asdict(e))
                    for e in want.events())
    for name, scn in t_w.SCENARIOS.items():
        ref = j_w.SCENARIOS[name]
        assert (scn.periods, scn.quick_periods, scn.decide_every,
                scn.settle_frac) == (ref.periods, ref.quick_periods,
                                     ref.decide_every, ref.settle_frac)
        for (s1, sim1), (s2, sim2) in zip(scn.build(1600, 4),
                                          ref.build(1600, 4)):
            assert (s1.name, s1.replicas, s1.capacity) == (
                s2.name, s2.replicas, s2.capacity)
            assert [sim1.step(float(t)) for t in range(64)] == [
                sim2.step(float(t)) for t in range(64)]
    for rung in t_w.POLICIES:
        got, want = t_w.make_policies(rung), j_w.make_policies(rung)
        assert (got is None) == (want is None)
        if got is not None:
            assert (dataclasses.asdict(got.control_config())
                    == dataclasses.asdict(want.control_config()))
