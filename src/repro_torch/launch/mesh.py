"""Production mesh construction over ``torch.distributed``.

Defined as FUNCTIONS so importing this module never touches device or
process-group state (required by the dry-run contract).  The caller
initialises the world (``torch.distributed.init_process_group``, with
its address, rank and world size); each function then builds a
``DeviceMesh`` with the JAX package's shape and axis names over ranks
0 .. n - 1 of the default group (``init_device_mesh`` when the world is
exactly n ranks), and raises when the world has fewer than n.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_production_mesh", "make_local_mesh", "fake_world"]


def _mesh(shape: tuple, axes: tuple, device: str):
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks, have {have}; the caller must initialise a "
            f"process group of at least {n} ranks "
            "(torch.distributed.init_process_group) before building the "
            "mesh")
    if have == n:
        return init_device_mesh(device, shape, mesh_dim_names=axes)
    return DeviceMesh(device, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """Single pod: (data=16, model=16) = 256 ranks.
    Multi-pod: (pod=2, data=16, model=16) = 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_moe_mesh(*, multi_pod: bool = False, device="cuda"):
    """Refactored pod for hybrid expert x tensor parallelism: the same
    256/512 ranks as the canonical mesh, viewed as (data=16, expert=8,
    tp=2)."""
    shape = (2, 16, 8, 2) if multi_pod else (16, 8, 2)
    axes = (("pod", "data", "expert", "tp") if multi_pod
            else ("data", "expert", "tp"))
    return _mesh(shape, axes, device)


def make_local_mesh(data: int = 2, model: int = 4, *, pod: int = 0,
                    device="cuda"):
    """Small mesh for tests (a world of >= data*model*max(pod,1) ranks;
    a ``fake`` process group will do)."""
    if pod:
        shape, axes = (pod, data, model), ("pod", "data", "model")
    else:
        shape, axes = (data, model), ("data", "model")
    return _mesh(shape, axes, device)


def _fake_group(common_opts, backend_opts):
    from torch._C._distributed_c10d import FakeProcessGroup
    rank, size = common_opts.group_rank, common_opts.group_size
    if hasattr(FakeProcessGroup, "_create_internal"):
        return FakeProcessGroup._create_internal(rank, size, backend_opts)
    return FakeProcessGroup(rank, size)


@contextlib.contextmanager
def fake_world(size: int, rank: int = 0):
    """A world of ``size`` ranks on PyTorch's ``fake`` backend, this
    process being rank ``rank``: collectives return at once and move
    nothing, so one process can trace one rank's part of a 256- or
    512-rank step (the dry run).  The backend is registered here from
    ``torch._C``'s ``FakeProcessGroup`` (its registration otherwise
    lives in ``torch.testing``); the world is destroyed on exit."""
    dist.Backend.register_backend("fake", _fake_group, extended_api=True,
                                  devices=["cpu", "cuda"])
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()
