"""Collective bytes and FLOPs of a step, counted while it runs.

The JAX package reads the collectives of a step from its compiled HLO
(``roofline/hlo.py``): XLA prints a scanned layer's body once, so that
parse recovers each loop's trip count and multiplies.  An eager PyTorch
step has no HLO, and it runs each collective as often as it executes:
``CollectiveCounter`` is a ``TorchDispatchMode`` that sees every
collective at dispatch, so a collective inside a 24-step loop counts
24 times and no trip count is needed.

Counted: the functional collectives (``_c10d_functional``) and the
eager ``torch.distributed`` calls (``c10d``) -- all-reduce, all-gather,
reduce-scatter, all-to-all, and send (a ``collective-permute``: the
bytes this card sends; a recv's bytes are its peer's send).  Each adds
its operand's bytes on this card times the ring multiplier ``_MULT``,
under the JAX package's op names, as the HLO parse counts an
instruction's operand shapes.  Broadcasts and barriers are not counted
(the HLO parse has no such op).

The counter also adds the FLOPs of the aten operators it sees, by
``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s table).
The hand-written kernels are called through ``ctypes`` and dispatch no
aten operator, so the counter does not see them: count a step whose
kernels run their plain versions (``kernel_impl="plain"``), as a dry
run does.

Under DTensor the counter sees what this rank executes: it lets a
``DTensor`` operator desugar first (it returns ``NotImplemented`` to
it, as ``CommDebugMode`` does) and counts the local operators and the
collectives of the redistributions that come out, at the local
shapes.  DTensor's sharding propagation runs operators on fake tensors
of their global shapes to learn the outputs' metadata; those are not
executions, and the counter skips every call on a ``FakeTensor``.
(``FlopCounterMode`` itself would count a DTensor operator at its
global shape, the FLOPs of every rank together.)

``MemoryTracker`` follows the same local operators' memory: the bytes
of every storage an operator's output holds, from its creation until
it is freed, and the peak of their sum.  It stands in for
``torch.distributed._tools.mem_tracker.MemTracker``, which counts the
fake global-shape tensors of DTensor's propagation as live memory
(PyTorch 2.13).  It also keeps the storages that local operators read
(``read``), so a dry run can tell the inputs a step never reads.
"""

from __future__ import annotations

from typing import Any

import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_any, tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.analysis import _MULT, CollectiveStats

__all__ = ["CollectiveCounter", "MemoryTracker", "count_collectives",
           "storage_key"]

# (namespace, op) -> (the JAX package's op name, index of the operand
# argument: a tensor or a list of tensors, lists of lists included)
_OPS = {
    ("_c10d_functional", "all_reduce"): ("all-reduce", 0),
    ("_c10d_functional", "all_reduce_"): ("all-reduce", 0),
    ("_c10d_functional", "all_reduce_coalesced"): ("all-reduce", 0),
    ("_c10d_functional", "all_reduce_coalesced_"): ("all-reduce", 0),
    ("_c10d_functional", "all_gather_into_tensor"): ("all-gather", 0),
    ("_c10d_functional", "all_gather_into_tensor_out"): ("all-gather", 0),
    ("_c10d_functional", "all_gather_into_tensor_coalesced"):
        ("all-gather", 0),
    ("_c10d_functional", "reduce_scatter_tensor"): ("reduce-scatter", 0),
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"):
        ("reduce-scatter", 0),
    ("_c10d_functional", "all_to_all_single"): ("all-to-all", 0),
    ("c10d", "allreduce_"): ("all-reduce", 0),
    ("c10d", "allreduce_coalesced_"): ("all-reduce", 0),
    ("c10d", "allgather_"): ("all-gather", 1),
    ("c10d", "_allgather_base_"): ("all-gather", 1),
    ("c10d", "allgather_coalesced_"): ("all-gather", 1),
    ("c10d", "allgather_into_tensor_coalesced_"): ("all-gather", 1),
    ("c10d", "reduce_scatter_"): ("reduce-scatter", 1),
    ("c10d", "_reduce_scatter_base_"): ("reduce-scatter", 1),
    ("c10d", "reduce_scatter_tensor_coalesced_"): ("reduce-scatter", 1),
    ("c10d", "alltoall_"): ("all-to-all", 1),
    ("c10d", "alltoall_base_"): ("all-to-all", 1),
    ("c10d", "send"): ("collective-permute", 0),
}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def _kind(types, args, kwargs):
    """``DTensor`` for a call on DTensors (let it desugar to local
    operators first), ``FakeTensor`` for DTensor's propagation on fake
    global-shape tensors (not an execution), else None."""
    if any(issubclass(t, DTensor) for t in types):
        return DTensor
    found = []

    def hit(a):
        if isinstance(a, (DTensor, FakeTensor)):
            found.append(type(a))
            return True
        return False
    if tree_any(hit, (args, kwargs)):
        return DTensor if issubclass(found[0], DTensor) else FakeTensor
    return None


class CollectiveCounter(TorchDispatchMode):
    """While active, adds each collective's wire bytes (operand bytes x
    ``_MULT``) and one count under its op name, and each operator's
    FLOPs to ``flops``; local operators only (see the module's note on
    DTensor)."""

    def __init__(self):
        super().__init__()
        self.bytes_by_op: dict[str, float] = {}
        self.count_by_op: dict[str, int] = {}
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = _kind(types, args, kwargs)
        if kind is not None:
            return NotImplemented if kind is DTensor else func(*args,
                                                                **kwargs)
        packet = getattr(func, "_overloadpacket", None)
        hit = _OPS.get((func.namespace, getattr(packet, "__name__", "")))
        if hit is not None:
            op, i = hit
            b = _MULT[op] * _nbytes(args[i] if i < len(args) else None)
            self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + b
            self.count_by_op[op] = self.count_by_op.get(op, 0) + 1
        out = func(*args, **kwargs)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        return out

    def stats(self) -> CollectiveStats:
        return CollectiveStats(dict(self.bytes_by_op),
                               dict(self.count_by_op))


class MemoryTracker(TorchDispatchMode):
    """While active, the live bytes of the storages that local operators
    create, and their peak (``peak``), each storage counted once from
    its first output to its release.  ``track`` adds tensors made
    before (a step's inputs) to the live bytes; ``read`` holds the keys
    (``storage_key``) of the storages the operators took as arguments,
    less those a view's output aliases (a view, such as one layer's
    slice of stacked weights, reads nothing; ``contiguous`` that
    copies does)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.read: set[int] = set()
        self._seen: dict[int, int] = {}

    def _release(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def track(self, *tensors) -> None:
        for t in tensors:
            t = getattr(t, "_local_tensor", t)
            if not isinstance(t, torch.Tensor) or isinstance(t, FakeTensor):
                continue
            st = t.untyped_storage()
            key = storage_key(t)
            if key not in self._seen:
                self._seen[key] = st.nbytes()
                self.live += st.nbytes()
                weakref.finalize(st, self._release, key)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = _kind(types, args, kwargs)
        if kind is DTensor:
            return NotImplemented
        out = func(*args, **kwargs)
        if kind is None:
            outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            views = ({storage_key(t) for t in outs} if func.is_view
                     else set())
            self.read.update(k for k in (storage_key(t) for t in tree_leaves(
                (args, kwargs)) if isinstance(t, torch.Tensor))
                if k not in views)
            self.track(*outs)
        return out


def storage_key(t) -> int:
    """The key of a tensor's (a DTensor's local) storage."""
    return getattr(t, "_local_tensor", t).untyped_storage()._cdata


def count_collectives(fn, *args, **kwargs) -> tuple[Any, CollectiveStats,
                                                    float]:
    """Run ``fn(*args, **kwargs)``; return (its result, the collectives
    it executed as ``CollectiveStats``, the FLOPs of its aten operators
    by ``FlopCounterMode``'s formulas), all on this rank."""
    with CollectiveCounter() as coll:
        out = fn(*args, **kwargs)
    return out, coll.stats(), float(coll.flops)
