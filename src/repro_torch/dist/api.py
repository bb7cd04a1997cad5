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


def on_shards(fn, *args, ins=None, outs=None, grads=None, shape=None):
    """``fn(*args)`` run on each rank's local shards of the DTensor
    ``args``, its outputs made DTensors again: the port's one way past
    DTensor's placement search, which on a mesh of three or four dims
    prices every strategy of every operator, up to minutes an operator
    on the CPU (a product's by a graph search per candidate).  With no
    DTensor among ``args`` it is ``fn(*args)``.

    ``ins`` gives each argument's placements (None: as it is); a
    DTensor in others is redistributed to them first.  ``grads`` gives
    the placements its gradient comes back in (None: its ``ins``; a
    partial sum where ``fn`` sums over what its shards split).
    ``outs`` gives each output's (one output: one tuple; default: the
    first DTensor argument's, as for an elementwise ``fn``).  An output
    whose local shape and placements are the first DTensor argument's
    takes its global shape and stride; else its global shape is
    ``shape`` if given (contiguous), or inferred from even shards.  Plain
    arguments pass as they are; a ``fn`` that returns None (an update
    in place) returns None."""
    from torch.distributed.tensor import DTensor
    first = next((a for a in args if isinstance(a, DTensor)), None)
    if first is None:
        return fn(*args)
    mesh = first.device_mesh
    ins = ins or (None,) * len(args)
    grads = grads or (None,) * len(args)
    local, placed = [], []
    for a, want, g in zip(args, ins, grads):
        if isinstance(a, DTensor):
            if want is not None and tuple(want) != tuple(a.placements):
                a = a.redistribute(mesh, want)
            placed.append(a)
            a = a.to_local(grad_placements=g)
        local.append(a)
    out = fn(*local)
    if out is None:
        return None
    ref = placed[0]
    single = not isinstance(out, (tuple, list))
    pls = ([outs or ref.placements] if single
           else outs or [ref.placements] * len(out))

    def wrap(o, pl):
        if tuple(pl) == tuple(ref.placements) and \
                o.shape == ref._local_tensor.shape:
            size, stride = ref.shape, ref.stride()
        elif shape is not None:
            size = tuple(shape)
            stride = o.new_empty(size, device="meta").stride()
        else:
            size = stride = None
        return DTensor.from_local(o, mesh, pl, run_check=False, shape=size,
                                  stride=stride)
    if single:
        return wrap(out, pls[0])
    return type(out)(wrap(o, pl) for o, pl in zip(out, pls))


class _GradAs(torch.autograd.Function):
    """``x`` as it is; its gradient redistributed to ``placements``."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.mesh, ctx.placements = x.device_mesh, placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.placements), None


def hold(x):
    """DTensor ``x`` as it is, its gradient brought to ``x``'s layout (a
    pending partial sum's as the whole gradient on every rank, its
    transpose); a plain tensor, or no context, as it is.  For an
    activation whose layout no logical axes name: DTensor's backward may
    hand its gradient over in another (a norm's backward splits the
    batch over the model axis too, a residual sum the sequence), and on
    a mesh of three dims the products upstream then meet strided shards
    once their rows are flattened, and price every strategy by a graph
    search."""
    from torch.distributed.tensor import DTensor, Replicate
    if active_context() is None or not isinstance(x, DTensor):
        return x
    return _GradAs.apply(x, tuple(Replicate() if p.is_partial() else p
                                  for p in x.placements))


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
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import placements_for, spec_for

    if not isinstance(x, DTensor):
        return x
    spec = spec_for(x.shape, axes, ctx.act_rules, ctx.mesh)
    if any(spec):
        return reshard(x, ctx.mesh, placements_for(spec, ctx.mesh))
    return reduce_partials(x, axes)


def reduce_partials(x, axes: tuple):
    """``x`` with its pending partial sums reduced (and its gradient
    constrained alike, ``_Constrain``), its other placements kept: on a
    mesh dim where ``axes`` resolve to a shard, onto that shard (a
    reduce-scatter), elsewhere whole (an all-reduce).  The identity with
    no context, on a plain tensor, or with no partial sum pending.  For
    products whose outputs meet in one operator: DTensor may leave one
    a partial sum and another a shard on the same mesh dim, and has no
    redistribution from a shard to a partial sum."""
    ctx = active_context()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import placements_for, spec_for

    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    want = placements_for(spec_for(x.shape, axes, ctx.act_rules, ctx.mesh),
                          ctx.mesh)
    return reshard(x, ctx.mesh, [w if p.is_partial() else p
                                 for p, w in zip(x.placements, want)])
