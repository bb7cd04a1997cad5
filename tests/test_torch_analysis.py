"""The port's contract analyzer (``repro_torch.analysis``).

The twin of ``tests/test_analysis.py``: every seeded known-bad fixture
fires on the port's checker with its path written ``repro_torch/...``
(LO001-LO003, LG001-LG004, BR001-BR002, RS001-RS003, ST101-ST102), the
runtime ``LockWitness`` catches inversions, ordered re-entry,
unordered-tier ABBA cycles and cross-thread inversions on real
``threading`` locks, the baseline workflow round-trips, and the port's
own tree is clean against the shipped (empty) baseline.

Parity: each fixture shared with the reference goes through both
analyzers, the paths and imports mapped ``repro_torch`` <-> ``repro``,
and must give the same codes on the same lines.  The RS002 cases where
the two differ by design are listed in ``RS002_BY_DESIGN`` with their
reason: the port's traced regions are eager torch, where metadata
(``.device``, strides, presence checks) is host-side and a method that
reads a tensor's value (``t.any()``, ``t.item()``) is a device-to-host
sync.  The port's own additions (its lock placements, its layering
edge, its cache keys and donation registry) have tests of their own.
"""

import ast
import collections
import os
import re
import sys
import textwrap
import threading
import types

import pytest

import repro.analysis as ref_analysis
from repro_torch.analysis import (ALL_CHECKERS, Baseline, BenignRaceChecker,
                                  LayerGuard, LockOrderChecker,
                                  RetraceSentinel, StylePass, run_analysis)
from repro_torch.analysis.__main__ import DEFAULT_BASELINE, main
from repro_torch.analysis.layering import ALLOWED
from repro_torch.analysis.lock_order import (LOCK_ORDER, classify_expr,
                                             classify_site)
from repro_torch.analysis.model import Source
from repro_torch.analysis.retrace import HOST_HELPERS, host_only
from repro_torch.analysis.witness import (LockHazard, LockWitness,
                                          WitnessedLock, armed)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src", "repro_torch")


def _src(rel, code):
    return Source("<test>", rel, textwrap.dedent(code))


def _codes(checker, rel, code):
    return [f.code for f in checker.check(_src(rel, code))]


def _to_ref(rel, code):
    """A port fixture in the reference's terms: ``repro_torch`` -> ``repro``
    in the path and in the imports."""
    return (rel.replace("repro_torch/", "repro/", 1),
            re.sub(r"\brepro_torch\b", "repro", textwrap.dedent(code)))


# ---------------------------------------------------------------------------
# Seeded fixtures shared with tests/test_analysis.py, in the port's terms:
# name (the reference test's) -> (checker, path, code, codes on the port)
# ---------------------------------------------------------------------------

FIXTURES = {
    # -- LockOrderChecker --------------------------------------------------
    "test_declared_order_is_clean": ("LockOrderChecker",
        "repro_torch/control/loop.py", """
        def tick(self):
            with self.loop._lock:
                with self.service._lock:
                    with self.arena.lock:
                        pass
        """, []),
    "test_lo001_inversion": ("LockOrderChecker",
        "repro_torch/streams/fleet.py", """
        def bad(self):
            with self.arena.lock:
                with self.service._lock:
                    pass
        """, ["LO001"]),
    "test_lo002_unclassified_lock": ("LockOrderChecker",
        "repro_torch/streams/fleet.py", """
        def f(self):
            with self._mystery_lock:
                pass
        """, ["LO002"]),
    "test_lo003_ordered_reentry": ("LockOrderChecker",
        "repro_torch/streams/queue.py", """
        def f(a, b):
            with a.arena.lock:
                with b.arena.lock:
                    pass
        """, ["LO003"]),
    "test_unordered_tier_nesting_is_legal": ("LockOrderChecker",
        "repro_torch/streams/pipeline.py", """
        def f(self):
            with self._scale_lock:
                with self._stop_lock:
                    pass
        """, []),
    # fleet's primary is the service lock: re-entering it from a
    # *_locked function is a self-deadlock
    "test_locked_suffix_assumes_module_primary_held": ("LockOrderChecker",
        "repro_torch/streams/fleet.py", """
        def _mutate_locked(self):
            with self._lock:
                pass
        """, ["LO003"]),
    # _rebind_slots_locked runs under the ARENA lock (override), so
    # acquiring the service lock inside it is an inversion
    "test_locked_fn_override_table": ("LockOrderChecker",
        "repro_torch/streams/fleet.py", """
        def _rebind_slots_locked(self):
            with self.service._lock:
                pass
        """, ["LO001"]),
    # -- LayerGuard --------------------------------------------------------
    "test_lg001_module_level_upward_import": ("LayerGuard",
        "repro_torch/streams/pipeline.py",
        "from repro_torch.control import ControlLoop\n", ["LG001"]),
    "test_lg002_obs_importing_repro": ("LayerGuard",
        "repro_torch/obs/exporter.py",
        "from repro_torch.streams import CounterArena\n", ["LG002"]),
    "test_lg003_ft_ban_even_lazily": ("LayerGuard",
        "repro_torch/serve/engine.py", """
        def f():
            from repro_torch.ft import FaultInjector
            return FaultInjector
        """, ["LG003"]),
    "test_lg004_lazy_import_needs_annotation": ("LayerGuard",
        "repro_torch/streams/pipeline.py", """
        def __init__(self):
            from repro_torch.control import ControlLoop
            self.loop = ControlLoop
        """, ["LG004"]),
    "test_lg004_unsanctioned_lazy_target": ("LayerGuard",
        "repro_torch/streams/pipeline.py", """
        def f():
            # layer-ok: an annotation cannot sanction a non-inversion
            from repro_torch.train import Trainer
            return Trainer
        """, ["LG004"]),
    "test_annotated_lazy_inversion_is_clean": ("LayerGuard",
        "repro_torch/streams/pipeline.py", """
        def __init__(self):
            # layer-ok: wiring inversion, constructor-only
            from repro_torch.control import ControlLoop
            self.loop = ControlLoop
        """, []),
    "test_downward_and_stdlib_imports_are_clean": ("LayerGuard",
        "repro_torch/streams/fleet.py", """
        import threading
        from repro_torch.core.monitor import MonitorConfig
        from repro_torch.streams.arena import CounterArena
        """, []),
    "test_relative_imports_resolve[sibling]": ("LayerGuard",
        "repro_torch/streams/queue.py", "from .arena import CounterArena\n",
        []),
    "test_relative_imports_resolve[upward]": ("LayerGuard",
        "repro_torch/streams/pipeline.py",
        "from ..control import ControlLoop\n", ["LG001"]),
    # -- BenignRaceChecker -------------------------------------------------
    "test_br001_unannotated_column_write": ("BenignRaceChecker",
        "repro_torch/streams/queue.py", """
        def bump(self, end, slot):
            end._tc[slot] += 1.0
        """, ["BR001"]),
    "test_br002_bare_annotation": ("BenignRaceChecker",
        "repro_torch/streams/queue.py", """
        def bump(self, end, slot):
            # benign-race:
            end._tc[slot] += 1.0
        """, ["BR002"]),
    "test_annotated_contract_is_clean": ("BenignRaceChecker",
        "repro_torch/streams/queue.py", """
        def bump(self, end, slot):
            # benign-race: copy-and-zero - costs at most one period
            end._tc[slot] += 1.0
        """, []),
    "test_annotation_found_in_comment_block_above": ("BenignRaceChecker",
        "repro_torch/streams/queue.py", """
        def bump(self, end, slot):
            # the write below races the sampler's copy+zero pair;
            # benign-race: copy-and-zero - one period of loss, tolerated
            # by the estimator contract
            end._tc[slot] += 1.0
        """, []),
    "test_arena_lock_scope_is_exempt": ("BenignRaceChecker",
        "repro_torch/streams/arena.py", """
        def zero(self, slot):
            with self.arena.lock:
                self._tc[slot] = 0.0
        """, []),
    "test_locked_fn_is_exempt": ("BenignRaceChecker",
        "repro_torch/streams/arena.py", """
        def _zero_locked(self, slot):
            self._tc[slot] = 0.0
        """, []),
    "test_alias_tracking": ("BenignRaceChecker",
        "repro_torch/streams/queue.py", """
        def bump(self, slot):
            tc_arr = self._tc
            tc_arr[slot] += 1.0
        """, ["BR001"]),
    "test_tuple_unpack_alias_tracking": ("BenignRaceChecker",
        "repro_torch/streams/arena.py", """
        def harvest(self, slot):
            tc_a, blk_a = self._tc, self._blk
            blk_a[slot] = False
        """, ["BR001"]),
    "test_non_column_writes_ignored": ("BenignRaceChecker",
        "repro_torch/streams/queue.py", """
        def f(self, slot):
            self.totals[slot] += 1.0
        """, []),
    # -- RetraceSentinel ---------------------------------------------------
    "test_rs002_python_branch_on_traced_operand": ("RetraceSentinel",
        "repro_torch/control/policy.py", """
        def _step_math(state, lam):
            if lam > 0:
                return state
            return state
        """, ["RS002"]),
    "test_rs002_reaches_call_graph_helpers": ("RetraceSentinel",
        "repro_torch/control/policy.py", """
        def _step_math(state, lam):
            return _clip(state, lam)

        def _clip(state, lam):
            while lam > 0:
                lam = lam - 1
            return state
        """, ["RS002"]),
    "test_rs002_taint_propagates_through_assignment": ("RetraceSentinel",
        "repro_torch/control/policy.py", """
        def _step_math(state, lam):
            pressure = lam * 2.0
            if pressure > 1.0:
                return state
            return state
        """, ["RS002"]),
    "test_presence_and_shape_checks_are_allowed": ("RetraceSentinel",
        "repro_torch/control/policy.py", """
        def _step_math(state, lam):
            if lam is None:
                return state
            if state.shape[0] > 3:
                return state
            if len(state) > 2 and isinstance(lam, float):
                return state
            return state
        """, []),
    "test_untraced_module_not_checked": ("RetraceSentinel",
        "repro_torch/launch/sweep.py", """
        def _step_math(state, lam):
            if lam > 0:
                return state
            return state
        """, []),
    "test_rs001_mutable_default_on_static_param": ("RetraceSentinel",
        "repro_torch/kernels/monitor/ops.py", """
        import jax

        def run(x, opts=[1, 2]):
            return x

        run_j = jax.jit(run, static_argnums=(1,))
        """, ["RS001"]),
    "test_rs001_unhashable_literal_at_static_position": ("RetraceSentinel",
        "repro_torch/core/monitor.py", """
        import jax

        step = jax.jit(fn, static_argnums=(1,))

        def g(x):
            return step(x, [1, 2])
        """, ["RS001"]),
    "test_rs003_donated_buffer_escape": ("RetraceSentinel",
        "repro_torch/core/monitor.py", """
        import jax

        def drive(self):
            step = jax.jit(f, donate_argnums=(0,))
            out = step(self.state)
            return self.state
        """, ["RS003"]),
    "test_rs003_same_statement_rebind_is_sanctioned": ("RetraceSentinel",
        "repro_torch/core/monitor.py", """
        import jax

        def drive(self):
            step = jax.jit(f, donate_argnums=(0,))
            self.state = step(self.state)
            return self.state
        """, []),
    "test_rs003_control_decide_donate_kwarg": ("RetraceSentinel",
        "repro_torch/control/loop.py", """
        def tick(self):
            dec = control_decide(cfg, self.state, donate=True)
            return self.state.occ
        """, ["RS003"]),
    # the real loop.py idiom: donation + rebind inside a try whose except
    # falls back must NOT leak a donation to the outer block
    "test_rs003_try_fallback_rebind_no_false_positive": ("RetraceSentinel",
        "repro_torch/control/loop.py", """
        def tick(self):
            try:
                self.state, dec = control_decide(
                    cfg, self.state, donate=True)
            except ValueError:
                dec = None
            return self.state
        """, []),
    # -- StylePass ---------------------------------------------------------
    "test_st101_wall_clock_call": ("StylePass",
        "repro_torch/streams/queue.py", """
        import time

        def f():
            return time.time()
        """, ["ST101"]),
    "test_st101_annotated_is_clean": ("StylePass",
        "repro_torch/control/log.py", """
        import time

        def stamp():
            # wall-clock: cross-process timestamp for the audit log
            return time.time()
        """, []),
    "test_st101_attribute_reference_is_not_a_call": ("StylePass",
        "repro_torch/control/log.py", """
        import dataclasses
        import time

        @dataclasses.dataclass
        class Rec:
            t: float = dataclasses.field(default_factory=time.time)
        """, []),
    "test_st102_broad_except_in_train": ("StylePass",
        "repro_torch/train/trainer.py", """
        def f():
            try:
                g()
            except Exception:
                pass
        """, ["ST102"]),
    "test_st102_bare_except_in_launch": ("StylePass",
        "repro_torch/launch/sweep.py", """
        def f():
            try:
                g()
            except:
                pass
        """, ["ST102"]),
    "test_st102_scoped_to_train_launch_only": ("StylePass",
        "repro_torch/streams/pipeline.py", """
        def f():
            try:
                g()
            except Exception:
                pass
        """, []),
    "test_st102_crash_containment_annotation": ("StylePass",
        "repro_torch/train/trainer.py", """
        def f():
            try:
                g()
            # crash-containment: worker thread must never die silently
            except Exception:
                pass
        """, []),
}

PORT = {c.name: c for c in ALL_CHECKERS}
REF = {c.name: c for c in ref_analysis.ALL_CHECKERS}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_seeded_fixture(name):
    """Each of the reference's seeded fixtures, written for the port,
    gives the reference's codes on the port's checker."""
    checker, rel, code, want = FIXTURES[name]
    assert _codes(PORT[checker](), rel, code) == want


def _findings(checkers, checker, rel, code):
    return [(f.code, f.line) for f in checkers[checker]().check(
        Source("<test>", rel, textwrap.dedent(code)))]


@pytest.mark.parametrize("name", list(FIXTURES))
def test_fixture_parity_with_the_reference(name):
    """The same fixture through both analyzers, ``repro_torch`` <->
    ``repro``: the same codes on the same lines."""
    checker, rel, code, want = FIXTURES[name]
    got = _findings(PORT, checker, rel, code)
    ref = _findings(REF, checker, *_to_ref(rel, code))
    assert got == ref
    assert [c for c, _ in got] == want


# RS002 where the port differs from the reference by design: (function
# under the fleet dispatch's contract, codes on the port, codes on the
# reference, reason)
_SCAN = "def _fleet_monitor_scan_impl(cfg, state, tc, blocked=None):\n"
RS002_BY_DESIGN = {
    "stride_helper": (_SCAN + """
    if _time_major(tc):
        return tc.T
    return tc
    """, [], ["RS002"], "a helper that reads only strides (HOST_HELPERS)"),
    "presence_inside_a_condition": (_SCAN + """
    full = cfg.mode == "full"
    if full and blocked is not None:
        return tc
    return state
    """, [], ["RS002"], "'is not None' is a presence check anywhere"),
    "tuple_assigned_pairwise": (_SCAN + """
    x, dim = tc.T, 0
    return x if dim == 0 else tc
    """, [], ["RS002"], "a constant in a tuple assignment is not a tensor"),
    "device_metadata": (_SCAN + """
    if tc.device.type == "cuda":
        return tc
    return state
    """, [], ["RS002"], "the device is host-side metadata"),
    "method_reads_a_value": (_SCAN + """
    if blocked.any():
        return tc
    return state
    """, ["RS002"], [], "t.any() syncs the device to the host"),
    "item_reads_a_value": (_SCAN + """
    while state.epoch.max().item() > 0:
        state = state
    return state
    """, ["RS002"], [], "t.item() syncs the device to the host"),
    "tolist_reads_a_value": (_SCAN + """
    assert tc.sum(dim=1).tolist()
    return state
    """, ["RS002"], [], "t.tolist() syncs the device to the host"),
    "comprehension_reads_values": (_SCAN + """
    if any(v > 0 for v in tc):
        return tc
    return state
    """, ["RS002"], [], "iterating a tensor reads its values"),
}


@pytest.mark.parametrize("name", list(RS002_BY_DESIGN))
def test_rs002_differs_from_the_reference_by_design(name):
    code, port, ref, reason = RS002_BY_DESIGN[name]
    rel = "repro_torch/kernels/monitor/ops.py"
    assert _codes(RetraceSentinel(), rel, code) == port, reason
    assert [c for c, _ in _findings(REF, "RetraceSentinel",
                                    *_to_ref(rel, code))] == ref, reason


@pytest.mark.parametrize("code", [
    "if float(state.mean[0]) > 1.0:\n        return tc\n    return state\n",
    "if int(tc[0, 0]):\n        return tc\n    return state\n",
    "if tc:\n        return tc\n    return state\n",
], ids=["float", "int", "bare"])
def test_rs002_builtin_value_reads_fire_on_both(code):
    """``float(t)``, ``int(t)`` and ``if t`` read a value in both."""
    rel = "repro_torch/kernels/monitor/ops.py"
    src = _SCAN + "    " + code
    assert _codes(RetraceSentinel(), rel, src) == ["RS002"]
    assert _findings(REF, "RetraceSentinel", *_to_ref(rel, src)) \
        == _findings(PORT, "RetraceSentinel", rel, src)


def test_rs002_metadata_reads_are_allowed():
    code = _SCAN + """
    Q, T = tc.shape
    if tc.dim() != 2 or tc.ndim != 2 or tc.numel() == 0:
        return state
    if not tc.is_contiguous() and tc.stride(0) == 1 and tc.is_cuda:
        return state
    if tc.dtype == blocked.dtype and tc.size(0) == Q:
        return state
    if any(leaf.device != tc.device for leaf in state):
        return state
    return state
    """
    assert _codes(RetraceSentinel(), "repro_torch/kernels/monitor/ops.py",
                  code) == []


def test_the_real_dispatch_region_is_clean_and_a_seeded_value_read_fires():
    """``kernels/monitor/ops.py`` as shipped has no RS002 (the three
    branches that read metadata only), and a branch on a tensor's value
    seeded into ``_compact``, inside the same traced region, fires."""
    path = os.path.join(SRC, "kernels", "monitor", "ops.py")
    rel = "repro_torch/kernels/monitor/ops.py"
    text = open(path, encoding="utf-8").read()
    assert [f.code for f in RetraceSentinel().check(
        Source(path, rel, text))] == []
    anchor = "    Q, T = tc.shape\n    if blocked is None:\n"
    assert text.count(anchor) == 1
    seeded = text.replace(anchor, "    Q, T = tc.shape\n    if blocked.any():"
                          "\n        pass\n    if blocked is None:\n")
    found = list(RetraceSentinel().check(Source(path, rel, seeded)))
    assert [(f.code, f.snippet.strip()) for f in found] == [
        ("RS002", "if blocked.any():")]


@pytest.mark.parametrize("name,module", sorted(HOST_HELPERS.items()))
def test_host_helpers_read_only_metadata(name, module):
    """Every entry of ``HOST_HELPERS`` is a function of its module that
    ``host_only`` accepts; a value read in it would not be."""
    tree = ast.parse(open(os.path.join(SRC, module), encoding="utf-8").read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == name)
    assert host_only(fn)
    bad = ast.parse("def f(x):\n    return bool(x.any())\n").body[0]
    assert not host_only(bad)
    bad = ast.parse("def f(x):\n    if x.sum() > 0:\n        return True\n"
                    "    return False\n").body[0]
    assert not host_only(bad)


# ---------------------------------------------------------------------------
# The port's own rules
# ---------------------------------------------------------------------------

class TestPortTables:
    def test_classifier_tables(self):
        assert classify_expr("repro_torch/control/loop.py",
                             "self._lock").name == "loop"
        assert classify_expr("repro_torch/x.py",
                             "self._arena.lock").name == "arena"
        assert classify_expr("repro_torch/x.py", "self._random_thing") \
            is None
        assert classify_site("repro_torch/streams/arena.py", "lock").name \
            == "arena"
        assert classify_site("repro_torch/serve/engine.py",
                             "_acct_lock").name == "sync"
        assert classify_site("repro_torch/streams/arena.py", "nope") is None

    def test_six_levels_of_the_reference(self):
        assert [(lv.rank, lv.name, lv.ordered) for lv in LOCK_ORDER] == [
            (lv.rank, lv.name, lv.ordered)
            for lv in ref_analysis.LOCK_ORDER]

    @pytest.mark.parametrize("rel,expr,site,level", [
        ("control/policy.py", "_STEPS_LOCK", "_STEPS_LOCK", "sync"),
        ("control/policy.py", "step.lock", "lock", "sync"),
        ("kernels/_build.py", "self._lock", "_lock", "sync"),
        ("kernels/attention/kernel.py", "_COUNT_LOCK", "_COUNT_LOCK",
         "audit"),
        ("kernels/ssd/kernel.py", "_COUNT_LOCK", "_COUNT_LOCK", "audit"),
    ])
    def test_port_locks_are_placed(self, rel, expr, site, level):
        """The port's own locks: the decision-step cache, one captured
        decision graph and the nvcc build in the sync tier (below the
        service lock a monitor dispatch holds), the launch counters in
        the audit tier."""
        rel = "repro_torch/" + rel
        assert classify_expr(rel, expr).name == level
        assert classify_site(rel, site).name == level

    def test_build_lock_under_the_service_lock_is_clean(self):
        code = """
        def build(self):
            with self.service._lock:
                with self._lock:
                    pass
        """
        # the nesting a first launch inside a dispatch makes, written in
        # the build module's own terms
        assert _codes(LockOrderChecker(), "repro_torch/kernels/_build.py",
                      code.replace("self.service._lock",
                                   "self.fleet._lock")) == []

    def test_models_may_import_kernels(self):
        code = "from repro_torch.kernels.attention import ops\n"
        assert _codes(LayerGuard(), "repro_torch/models/attention.py",
                      code) == []
        assert "kernels" in ALLOWED["models"]
        assert _codes(LayerGuard(), "repro_torch/dist/sharding.py",
                      "from repro_torch.train.optimizer import _tree_map\n"
                      ) == ["LG001"]

    def test_rs001_cache_keys(self):
        code = """
        import functools

        @functools.lru_cache(maxsize=None)
        def _fleet_plan(cfg, impl, chunk_t, opts={}):
            return cfg

        def f(cfg):
            _fleet_plan(cfg, "cuda", [32])
            _fleet_plan(cfg, "cuda", 32, opts=[1])
            return _decide_step({"a": 1}, 64, "cuda")
        """
        found = list(RetraceSentinel().check(
            _src("repro_torch/core/monitor.py", code)))
        assert [(f.code, f.line) for f in found] == [
            ("RS001", 5), ("RS001", 9), ("RS001", 10), ("RS001", 11)]

    def test_rs003_fleet_scan_donation(self):
        code = """
        def tick(self, tc):
            st, out = run_monitor_fleet(cfg, tc, state=self.state,
                                        donate=True)
            _fleet_monitor_scan_impl(cfg, self.s2, tc, donate=True)
            return self.state, self.s2
        """
        found = list(RetraceSentinel().check(
            _src("repro_torch/streams/fleet.py", code)))
        assert [(f.code, f.line) for f in found] == [("RS003", 6)] * 2
        sanctioned = """
        def tick(self, tc):
            self.state, out = run_monitor_fleet(cfg, tc, state=self.state,
                                                donate=True)
            return self.state
        """
        assert _codes(RetraceSentinel(), "repro_torch/streams/fleet.py",
                      sanctioned) == []

    def test_capture_roots_reach_the_step_math(self):
        """The decision's contract starts at its CUDA-graph capture and
        follows ``self.fn()`` into ``_step_math``."""
        code = """
        class _DecideStep:
            def _capture(self):
                self.fn()

            def fn(self):
                _step_math(xp, cfg, state, lam=self.lam)

        def _step_math(xp, cfg, state, lam):
            return _leg(state, lam)

        def _leg(state, lam):
            if lam.max() > 0:
                return state
            return state
        """
        found = list(RetraceSentinel().check(
            _src("repro_torch/control/policy.py", code)))
        assert [(f.code, f.line) for f in found] == [("RS002", 13)]

    def test_paths_are_rooted_at_the_port(self, tmp_path):
        pkg = tmp_path / "src" / "repro_torch" / "streams"
        pkg.mkdir(parents=True)
        (pkg / "q.py").write_text("import time\nx = time.time()\n")
        (f,) = run_analysis([str(tmp_path / "src")])
        assert f.path == "repro_torch/streams/q.py" and f.code == "ST101"


# ---------------------------------------------------------------------------
# Fingerprints + baseline workflow
# ---------------------------------------------------------------------------

class TestBaseline:
    BAD = """
    import time

    def f():
        return time.time()
    """

    def test_fingerprint_survives_line_shift(self):
        a = list(StylePass().check(_src("repro_torch/x/y.py", self.BAD)))
        shifted = "# a new comment line\n" + textwrap.dedent(self.BAD)
        b = list(StylePass().check(Source("<test>", "repro_torch/x/y.py",
                                          shifted)))
        assert a[0].line != b[0].line
        assert a[0].fingerprint == b[0].fingerprint

    def test_fingerprint_dies_with_the_code(self):
        a = list(StylePass().check(_src("repro_torch/x/y.py", self.BAD)))
        changed = textwrap.dedent(self.BAD).replace(
            "return time.time()", "return 1.0 + time.time()")
        b = list(StylePass().check(Source("<test>", "repro_torch/x/y.py",
                                          changed)))
        assert a[0].fingerprint != b[0].fingerprint

    def test_split_new_baselined_stale(self, tmp_path):
        findings = list(StylePass().check(_src("repro_torch/x/y.py",
                                               self.BAD)))
        bl_path = str(tmp_path / "baseline.json")
        Baseline().save(bl_path, findings)
        bl = Baseline.load(bl_path)
        new, old, stale = bl.split(findings)
        assert (len(new), len(old), len(stale)) == (0, 1, 0)
        new, old, stale = bl.split([])          # finding fixed -> stale
        assert (len(new), len(old), len(stale)) == (0, 0, 1)
        new, old, stale = Baseline().split(findings)
        assert (len(new), len(old), len(stale)) == (1, 0, 0)


class TestCli:
    BAD = ("import time\n"
           "def f():\n"
           "    return time.time()\n")
    CLEAN = ("import time\n"
             "def f():\n"
             "    return time.monotonic()\n")

    def test_exit_codes_and_baseline_roundtrip(self, tmp_path, capsys):
        bad = tmp_path / "bad.py"
        bad.write_text(self.BAD)
        bl = str(tmp_path / "baseline.json")
        assert main([str(bad), "--baseline", bl]) == 1
        assert "ST101" in capsys.readouterr().out
        assert main([str(bad), "--baseline", bl,
                     "--write-baseline"]) == 0
        assert main([str(bad), "--baseline", bl]) == 0   # baselined
        assert main([str(bad), "--baseline", bl,
                     "--no-baseline"]) == 1               # raw report
        bad.write_text(self.CLEAN)                        # fixed
        assert main([str(bad), "--baseline", bl]) == 1    # stale entry
        assert "stale" in capsys.readouterr().out

    def test_missing_path_is_usage_error(self, tmp_path):
        assert main([str(tmp_path / "nope.py")]) == 2

    def test_default_path_is_the_port(self, capsys):
        assert main(["-q"]) == 0
        assert capsys.readouterr().out.startswith(
            "repro_torch.analysis: 0 finding(s)")


def test_src_tree_is_clean_against_shipped_baseline():
    """Every checker over the port's tree, matched against the shipped
    baseline: it is empty, and nothing is found."""
    findings = run_analysis([SRC])
    bl = Baseline.load(DEFAULT_BASELINE)
    assert bl.entries == {}
    new, _, stale = bl.split(findings)
    assert not new, "unbaselined findings:\n" + "\n".join(
        f.render() for f in new)
    assert not stale, f"stale baseline entries: {stale}"


def test_all_checkers_registry():
    names = {c.name for c in ALL_CHECKERS}
    assert names == {"LockOrderChecker", "LayerGuard",
                     "BenignRaceChecker", "RetraceSentinel", "StylePass"}
    assert names == set(REF)


# ---------------------------------------------------------------------------
# LockWitness (runtime)
# ---------------------------------------------------------------------------

def _site_module(tmp_path, rel, attrs, kinds=None):
    """Write a module at ``tmp_path/<rel>`` whose ``make_<attr>()``
    functions create a lock at a creation site classify_site maps to a
    hierarchy level, and return its namespace."""
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    kinds = kinds or {}
    lines = ["import threading"]
    for attr in attrs:
        kind = kinds.get(attr, "Lock")
        lines += [f"def make_{attr}():",
                  f"    {attr} = threading.{kind}()",
                  f"    return {attr}"]
    code = "\n".join(lines) + "\n"
    path.write_text(code)
    ns = {}
    exec(compile(code, str(path), "exec"), ns)
    return ns


class TestLockWitness:
    def test_classified_sites_get_wrapped_unclassified_stay_raw(
            self, tmp_path):
        fleet = _site_module(tmp_path, "repro_torch/streams/fleet.py",
                             ["_lock"])
        ref = _site_module(tmp_path, "repro/streams/fleet.py", ["_lock"])
        with LockWitness() as w:
            svc = fleet["make__lock"]()
            raw = threading.Lock()            # this file: unclassified
            ref_lock = ref["make__lock"]()    # the reference's: not ours
        assert isinstance(svc, WitnessedLock)
        assert svc.level.name == "service"
        assert not isinstance(raw, WitnessedLock)
        assert not isinstance(ref_lock, WitnessedLock)
        assert svc in w.locks() and w.report() == []

    def test_deactivate_restores_factories(self, tmp_path):
        before = (threading.Lock, threading.RLock)
        w = LockWitness().activate()
        assert (threading.Lock, threading.RLock) != before
        w.deactivate()
        assert (threading.Lock, threading.RLock) == before
        w.deactivate()                        # idempotent
        assert (threading.Lock, threading.RLock) == before

    def test_double_activation_refused(self):
        w = LockWitness().activate()
        try:
            with pytest.raises(RuntimeError, match="already active"):
                w.activate()
        finally:
            w.deactivate()

    def test_inversion_recorded(self, tmp_path):
        fleet = _site_module(tmp_path, "repro_torch/streams/fleet.py",
                             ["_lock"])
        loop = _site_module(tmp_path, "repro_torch/control/loop.py",
                            ["_lock"])
        with LockWitness() as w:
            svc, lp = fleet["make__lock"](), loop["make__lock"]()
            with svc:
                with lp:                       # service held, loop outer
                    pass
        report = w.report()
        assert len(report) == 1 and "inversion" in report[0]
        assert "service" in report[0] and "loop" in report[0]

    def test_declared_order_records_nothing(self, tmp_path):
        loop = _site_module(tmp_path, "repro_torch/control/loop.py",
                            ["_lock"])
        fleet = _site_module(tmp_path, "repro_torch/streams/fleet.py",
                             ["_lock"])
        arena = _site_module(tmp_path, "repro_torch/streams/arena.py",
                             ["lock"], kinds={"lock": "RLock"})
        with LockWitness() as w:
            lp, svc, ar = (loop["make__lock"](), fleet["make__lock"](),
                           arena["make_lock"]())
            with lp:
                with svc:
                    with ar:
                        pass
        assert w.report() == []

    def test_reentrant_rlock_is_not_a_violation(self, tmp_path):
        arena = _site_module(tmp_path, "repro_torch/streams/arena.py",
                             ["lock"], kinds={"lock": "RLock"})
        with LockWitness() as w:
            ar = arena["make_lock"]()
            with ar:
                with ar:                       # RLock re-entry
                    pass
        assert w.report() == []

    def test_same_ordered_rank_nesting_recorded(self, tmp_path):
        fleet = _site_module(tmp_path, "repro_torch/streams/fleet.py",
                             ["_lock"])
        with LockWitness() as w:
            a, b = fleet["make__lock"](), fleet["make__lock"]()
            with a:
                with b:                        # two service-rank locks
                    pass
        report = w.report()
        assert len(report) == 1 and "same-rank" in report[0]

    def test_unordered_tier_abba_cycle_detected(self, tmp_path):
        engine = _site_module(tmp_path, "repro_torch/serve/engine.py",
                              ["_scale_lock", "_acct_lock"])
        with LockWitness() as w:
            a = engine["make__scale_lock"]()
            b = engine["make__acct_lock"]()
            with a:
                with b:                        # edge a -> b (legal tier)
                    pass
            with b:
                with a:                        # edge b -> a: ABBA
                    pass
        assert w.violations == []              # no static-rank violation
        report = w.report()
        assert len(report) == 1 and "cycle" in report[0]

    def test_unordered_tier_consistent_order_is_clean(self, tmp_path):
        engine = _site_module(tmp_path, "repro_torch/serve/engine.py",
                              ["_scale_lock", "_acct_lock"])
        with LockWitness() as w:
            a = engine["make__scale_lock"]()
            b = engine["make__acct_lock"]()
            for _ in range(3):
                with a:
                    with b:
                        pass
        assert w.report() == []

    def test_cross_thread_inversion_caught(self, tmp_path):
        """The witness sees call-graph nesting the AST checker cannot:
        a worker thread acquiring outer-rank under inner-rank."""
        fleet = _site_module(tmp_path, "repro_torch/streams/fleet.py",
                             ["_lock"])
        arena = _site_module(tmp_path, "repro_torch/streams/arena.py",
                             ["lock"], kinds={"lock": "RLock"})
        with LockWitness() as w:
            svc, ar = fleet["make__lock"](), arena["make_lock"]()

            def worker():
                with ar:
                    with svc:                  # arena held, service outer
                        pass

            t = threading.Thread(target=worker)
            t.start()
            t.join()
        report = w.report()
        assert len(report) == 1 and "inversion" in report[0]

    def test_port_lock_sites_are_wrapped_at_their_levels(self, tmp_path):
        """The port-only sites: the step cache, a decision graph's lock
        and the build lock in the sync tier, the launch counters in the
        audit tier.  A build under the service lock with a counter
        inside is clean; the service lock taken under a launch counter
        is an inversion."""
        policy = _site_module(tmp_path, "repro_torch/control/policy.py",
                              ["_STEPS_LOCK", "lock"])
        build = _site_module(tmp_path, "repro_torch/kernels/_build.py",
                             ["_lock"])
        attn = _site_module(tmp_path,
                            "repro_torch/kernels/attention/kernel.py",
                            ["_COUNT_LOCK"])
        ssd = _site_module(tmp_path, "repro_torch/kernels/ssd/kernel.py",
                           ["_COUNT_LOCK"])
        fleet = _site_module(tmp_path, "repro_torch/streams/fleet.py",
                             ["_lock"])
        loop = _site_module(tmp_path, "repro_torch/control/loop.py",
                            ["_lock"])
        with LockWitness() as w:
            steps, graph = policy["make__STEPS_LOCK"](), policy["make_lock"]()
            nvcc = build["make__lock"]()
            counters = attn["make__COUNT_LOCK"](), ssd["make__COUNT_LOCK"]()
            svc, lp = fleet["make__lock"](), loop["make__lock"]()
        made = (steps, graph, nvcc) + counters
        assert [lk.level.name for lk in made] == ["sync"] * 3 + ["audit"] * 2
        assert all(lk in w.locks() for lk in made + (svc, lp))
        with lp:                       # a tick: the step cache, the graph
            with steps:
                pass
            with graph:
                pass
        with svc:                      # a first launch inside a dispatch
            with nvcc:
                with counters[0]:
                    pass
        assert w.report() == []
        with counters[1]:
            with svc:
                pass
        report = w.report()
        assert len(report) == 1 and "inversion" in report[0]
        assert "audit" in report[0] and "service" in report[0]


def test_module_level_locks_are_adopted_and_put_back(tmp_path,
                                                     monkeypatch):
    """A classified lock that a package module made at import time (the
    decision-step cache's ``_STEPS_LOCK``) is wrapped while a witness is
    active, shares its raw lock, and is put back after; an unclassified
    one is left alone."""
    path = tmp_path / "repro_torch" / "control" / "policy.py"
    path.parent.mkdir(parents=True)
    path.write_text("")
    mod = types.ModuleType("repro_torch._witness_fixture")
    mod.__file__ = str(path)
    mod._STEPS_LOCK, mod._OTHER_LOCK = threading.Lock(), threading.Lock()
    raw = mod._STEPS_LOCK
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    fleet = _site_module(tmp_path, "repro_torch/streams/fleet.py",
                         ["_lock"])
    with LockWitness() as w:
        assert isinstance(mod._STEPS_LOCK, WitnessedLock)
        assert mod._STEPS_LOCK.level.name == "sync"
        assert mod._OTHER_LOCK is not raw and \
            not isinstance(mod._OTHER_LOCK, WitnessedLock)
        svc = fleet["make__lock"]()
        with mod._STEPS_LOCK:
            assert raw.locked()
            with svc:                   # sync held, then the service
                pass
    assert mod._STEPS_LOCK is raw and not raw.locked()
    report = w.report()
    assert len(report) == 1 and "inversion" in report[0]
    assert "_STEPS_LOCK" in report[0]


class TestArmed:
    def test_clean_block_passes(self, tmp_path):
        fleet = _site_module(tmp_path, "repro_torch/streams/fleet.py",
                             ["_lock"])
        before = (threading.Lock, threading.RLock)
        with armed() as w:
            with fleet["make__lock"]() as svc:
                pass
        assert w.report() == [] and svc in w.locks()
        # the package's module-level locks imported so far are adopted
        # too: the count is by rank over every wrapped lock
        assert w.wrapped() == dict(collections.Counter(
            lk.level.rank for lk in w.locks()))
        assert (threading.Lock, threading.RLock) == before

    def test_hazard_is_handed_to_fail(self, tmp_path):
        fleet = _site_module(tmp_path, "repro_torch/streams/fleet.py",
                             ["_lock"])
        arena = _site_module(tmp_path, "repro_torch/streams/arena.py",
                             ["lock"])
        with pytest.raises(LockHazard, match="inversion"):
            with armed():
                svc, ar = fleet["make__lock"](), arena["make_lock"]()
                with ar:
                    with svc:
                        pass
        seen = []
        with armed(seen.append):
            svc, ar = fleet["make__lock"](), arena["make_lock"]()
            with ar:
                with svc:
                    pass
        assert len(seen) == 1 and "LOCK_ORDER" in seen[0]

    def test_a_failing_block_keeps_its_own_error(self, tmp_path):
        before = threading.Lock
        with pytest.raises(KeyError):
            with armed():
                raise KeyError("the block's own")
        assert threading.Lock is before
