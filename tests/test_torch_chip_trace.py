"""``chip_smoke._trace_split``, the profiler reader behind every device-time
split the smoke script prints.

It reads the profiler's raw events and ties each kernel to the CPU op
that launched it by correlation id; a kernel counts toward a span's
category when that op lies inside a ``span`` range on the range's own
thread.  The CPU cases hold that attribution on hand-made events and
the span membership against the profiler's own event tree on a real CPU
trace; the card case holds the whole split against a split computed from
the event tree (``prof.events()``, each CPU op's ``kernels``)."""

import sys
import threading
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
SPAN = "test.span"


class _Event:
    """The accessors of a raw profiler event that ``_trace_split`` reads."""

    def __init__(self, name, device, tid, start, end, corr, linked):
        self._v = (name, device, tid, start, end, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_thread_id(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def end_ns(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]


def _prof(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def test_trace_split_attributes_each_kernel_by_its_op():
    """A kernel launched by an op inside the span (same thread) is the
    span's; one launched after it, or by an op of another thread inside
    its interval, keeps its own category; the span's device annotation
    is no kernel."""
    ev = [_Event(SPAN, CPU, 1, 100, 200, 10, 0),
          _Event("aten::add", CPU, 1, 110, 120, 11, 0),
          _Event("aten::mul", CPU, 1, 210, 220, 12, 0),
          _Event("aten::mm", CPU, 2, 110, 120, 13, 0),
          _Event("cudaLaunchKernel", CPU, 1, 111, 112, 14, 11),
          _Event("vectorized_elementwise_kernel", CUDA, 7, 1000, 3000, 15,
                 11),
          _Event("vectorized_elementwise_kernel", CUDA, 7, 3000, 4000, 16,
                 12),
          _Event("nvjet_gemm", CUDA, 7, 4000, 8000, 17, 13),
          _Event(SPAN, CUDA, 7, 1000, 3000, 18, 0)]
    out = CS._trace_split(torch, _prof(ev), 0.01, 1, CS._TRAIN_CATEGORIES,
                          (SPAN, "optimizer"))
    assert out["kernels"] == 3
    assert out["optimizer_ms"] == pytest.approx(2e-3)
    assert out["elementwise_ms"] == pytest.approx(1e-3)
    assert out["gemm_ms"] == pytest.approx(4e-3)
    assert out["device_ms"] == pytest.approx(7e-3)
    assert out["idle_share"] == pytest.approx(0.3)


def test_trace_split_without_device_events_is_none():
    ev = [_Event(SPAN, CPU, 1, 100, 200, 10, 0)]
    assert CS._trace_split(torch, _prof(ev), 1.0, 1) is None


def _work(x):
    for _ in range(3):
        x = torch.relu(x @ x.T + 1.0)
    return x.sum()


def test_span_ops_are_the_event_tree_descendants_of_the_spans():
    """On a real CPU trace (two spans on the main thread, ops run in
    another thread inside the first), the ops ``_span_ops`` places in a
    span are the descendants of the span's events in the profiler's own
    tree, plus the ops that tree folds into a parent of the same name
    (``aten::sum`` calls an inner ``aten::sum``; the tree lifts the
    inner op's kernels into the outer)."""
    x = torch.randn(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _work(x)
        with record_function(SPAN):
            _work(x)
            t = threading.Thread(target=_work, args=(x,))
            t.start()
            t.join()
        _work(x)
        with record_function(SPAN):
            _work(x)
    raw = prof.profiler.kineto_results.events()
    ops = [(e.name(), e.start_thread_id(), e.start_ns(), e.end_ns(),
            e.correlation_id(), e.linked_correlation_id())
           for e in raw if e.device_type() == CPU]
    got = CS._span_ops(ops, SPAN)
    want, stack = set(), [e for e in prof.events()
                          if e.device_type == CPU and e.name == SPAN]
    assert len(stack) == 2
    while stack:
        e = stack.pop()
        want.add(e.id)
        stack.extend(e.cpu_children)
    assert len(want) > 2 and want <= got
    by_id = {op[4]: op for op in ops}
    for i in got - want:
        name, tid, a, b, _, _ = by_id[i]
        assert any(by_id[j][0] == name and by_id[j][1] == tid
                   and by_id[j][2] <= a and b <= by_id[j][3]
                   for j in want), by_id[i]


@pytest.mark.cuda
def test_trace_split_equals_the_event_tree_on_the_card():
    """On the card: the raw reader's split of a trace with kernels inside
    and outside a span equals one computed from the profiler's event
    tree, category by category (rel 1e-9)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the trace has device events")
    x = torch.randn(256, 256, device="cuda")
    _work(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _work(x)
        with record_function(SPAN):
            _work(x)
        torch.cuda.synchronize()
    span, cats = (SPAN, "optimizer"), CS._TRAIN_CATEGORIES
    got = CS._trace_split(torch, prof, 1.0, 1, cats, span)
    events = prof.events()
    want = {c: 0.0 for c, _ in cats}
    want[span[1]] = want["other"] = 0.0
    n = 0
    for e in events:
        if e.device_type == CUDA and e.name != SPAN:
            n += 1
            ms = e.time_range.elapsed_us() / 1e3
            want[CS._category(e.name, cats)] += ms
    stack = [e for e in events if e.device_type == CPU and e.name == SPAN]
    while stack:
        e = stack.pop()
        for k in e.kernels:
            want[CS._category(k.name, cats)] -= k.duration / 1e3
            want[span[1]] += k.duration / 1e3
        stack.extend(e.cpu_children)
    assert got["kernels"] == n and want[span[1]] > 0
    for c, ms in want.items():
        assert got[f"{c}_ms"] == pytest.approx(ms, rel=1e-9, abs=1e-9), c
