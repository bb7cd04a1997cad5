"""DTensor helpers shared by the kernel ops and the models.

``along_shards`` works around two gaps of DTensor in PyTorch 2.11, the
card's release: it has no sharding rule for ``aten.flip`` (cumsum's
backward), and ``constant_pad_nd`` gives its output one placement on a
mesh of two or more dims, which a view in the backward rejects.  Once
DTensor has both rules, the SSD path can call its functions on the
DTensor and this module can go.
"""

from __future__ import annotations

from torch.distributed.tensor import DTensor, Replicate

__all__ = ["along_shards"]


def along_shards(fn, t, dim: int, shape=None):
    """``fn(t)`` for a function that works along ``dim`` (and leaves the
    other dims as they are; ``shape``, default ``t``'s, is its output's).
    A DTensor runs ``fn`` on each rank's shard, a placement that splits
    ``dim`` or holds a partial sum gathered first.  The SSD path's
    cumsum and the ssm block's zero-padding go through it (see the
    module's docstring)."""
    if not isinstance(t, DTensor):
        return fn(t)
    whole = [Replicate() if p.is_partial() or p.is_shard(dim) else p
             for p in t.placements]
    if whole != list(t.placements):
        t = t.redistribute(t.device_mesh, whole)
    out = fn(t.to_local()).contiguous()
    shape = tuple(t.shape if shape is None else shape)
    return DTensor.from_local(out, t.device_mesh, t.placements,
                              run_check=False, shape=shape,
                              stride=out.new_empty(shape,
                                                   device="meta").stride())
