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

``count_collectives`` also runs ``torch.utils.flop_counter.
FlopCounterMode`` over the call, for the FLOPs of its aten operators.
The hand-written kernels are called through ``ctypes`` and dispatch no
aten operator, so neither mode sees them: count a step whose kernels
run their plain versions (``kernel_impl="plain"``), as a dry run does.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.roofline.analysis import _MULT, CollectiveStats

__all__ = ["CollectiveCounter", "count_collectives"]

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


class CollectiveCounter(TorchDispatchMode):
    """While active, adds each collective's wire bytes (operand bytes x
    ``_MULT``) and one count under its op name."""

    def __init__(self):
        super().__init__()
        self.bytes_by_op: dict[str, float] = {}
        self.count_by_op: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        hit = _OPS.get((func.namespace, func._overloadpacket.__name__))
        if hit is not None:
            op, i = hit
            b = _MULT[op] * _nbytes(args[i] if i < len(args) else None)
            self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + b
            self.count_by_op[op] = self.count_by_op.get(op, 0) + 1
        return func(*args, **kwargs)

    def stats(self) -> CollectiveStats:
        return CollectiveStats(dict(self.bytes_by_op),
                               dict(self.count_by_op))


def count_collectives(fn, *args, **kwargs) -> tuple[Any, CollectiveStats,
                                                    float]:
    """Run ``fn(*args, **kwargs)``; return (its result, the collectives
    it executed as ``CollectiveStats``, the FLOPs of its aten operators
    by ``FlopCounterMode``)."""
    with FlopCounterMode(display=False) as flops, \
            CollectiveCounter() as coll:
        out = fn(*args, **kwargs)
    return out, coll.stats(), float(flops.get_total_flops())
