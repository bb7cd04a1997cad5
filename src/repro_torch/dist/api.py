"""Sharding context plumbing.

Model code never mentions mesh axes — it annotates tensors with *logical*
axis names (``constrain(x, ("batch", "seq", "d_model"))``).  The active
:class:`ShardingContext` (mesh + rule tables, installed with
``use_sharding``) resolves those names to a ``PartitionSpec`` via
``repro_torch.dist.sharding.spec_for``; with no context installed
``constrain`` is the identity, so the same model runs unsharded on one
card.  With a context, a ``DTensor`` is redistributed to the resolved
placements over the context's ``DeviceMesh``; a plain tensor is left as
it is (it has no layout to change).

The model calls ``constrain`` at the JAX package's places, with its
logical axes (``models.transformer``, ``attention``, ``moe``,
``whisper``).  Under a context the parameters and inputs are DTensors,
and the model also makes plain tensors of its own (positions, RoPE
tables, masks, zeros, the cache it stacks): ``use_sharding`` enters
``torch.distributed.tensor.experimental.implicit_replication`` for its
extent, so DTensor takes each such tensor as replicated over the mesh,
as XLA takes a constant.  That switch is DTensor's own and process-wide
(not per thread, unlike the context): run one sharded step at a time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Mapping, Optional

import torch

__all__ = ["ShardingContext", "active_context", "use_sharding", "constrain"]


@dataclasses.dataclass
class ShardingContext:
    """Mesh + rule tables.  Mutable on purpose: the dry-run overrides
    individual rules per cell (``ctx.act_rules = {**ctx.act_rules, ...}``)."""
    mesh: Any
    act_rules: Mapping[str, tuple]
    param_rules: Mapping[str, tuple]


_local = threading.local()


def active_context() -> Optional[ShardingContext]:
    return getattr(_local, "ctx", None)


@contextlib.contextmanager
def use_sharding(ctx: ShardingContext):
    from torch.distributed.tensor.experimental import implicit_replication

    prev = active_context()
    _local.ctx = ctx
    try:
        with implicit_replication():
            yield ctx
    finally:
        _local.ctx = prev


class _Constrain(torch.autograd.Function):
    """``x`` redistributed to ``placements``, and its gradient too: the
    transpose of JAX's sharding constraint is the same constraint on the
    cotangent.  (DTensor's own ``redistribute`` would hand the gradient
    back in whatever placement its search finds cheapest to move, a
    partial sum as often as not, and the products upstream of it then
    gather their weights whole.)"""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.placements), None, None


def as_dtensor(t, mesh):
    """``t`` as a DTensor over ``mesh``: a plain tensor is taken as the
    same global value on every rank (replicated)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def reshard(x, mesh, placements):
    """DTensor ``x`` redistributed to ``placements``, its gradient too
    (``_Constrain``): the gradient of a reduced partial sum is the whole
    gradient on every rank, where DTensor's own backward would try to
    turn it back into a partial sum."""
    return _Constrain.apply(x, mesh, tuple(placements))


def constrain(x, axes: tuple):
    """Annotate ``x`` with logical axis names; redistributes it (and its
    gradient, ``_Constrain``) iff a context is active and ``x`` is a
    ``DTensor``: to the resolved placements where at least one axis
    resolves to a mesh axis; else (no constraint, as the JAX package
    leaves it) only its pending partial sums are reduced, since a value
    under XLA is never a partial sum, and DTensor would carry one on."""
    ctx = active_context()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.dist.sharding import placements_for, spec_for

    if not isinstance(x, DTensor):
        return x
    spec = spec_for(x.shape, axes, ctx.act_rules, ctx.mesh)
    if any(spec):
        return reshard(x, ctx.mesh, placements_for(spec, ctx.mesh))
    if any(p.is_partial() for p in x.placements):
        return reshard(x, ctx.mesh, [Replicate() if p.is_partial() else p
                                     for p in x.placements])
    return x
