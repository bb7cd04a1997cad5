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

The model does not call ``constrain`` yet: its call sites come with the
dry run (``launch/dryrun.py``, ROADMAP.md, Queue 1 item 6).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Mapping, Optional

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
    prev = active_context()
    _local.ctx = ctx
    try:
        yield ctx
    finally:
        _local.ctx = prev


def constrain(x, axes: tuple):
    """Annotate ``x`` with logical axis names; redistributes it iff a
    context is active, ``x`` is a ``DTensor`` and at least one axis
    resolves to a mesh axis."""
    ctx = active_context()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import placements_for, spec_for

    spec = spec_for(x.shape, axes, ctx.act_rules, ctx.mesh)
    if not any(spec) or not isinstance(x, DTensor):
        return x
    return x.redistribute(ctx.mesh, placements_for(spec, ctx.mesh))
