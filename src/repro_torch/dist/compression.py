"""Int8 error-feedback gradient compression for the cross-pod axis.

Numerical semantics of the scheme: each step's gradients are quantized
to int8 with a per-row scale, the quantization residual is fed back into
the next step's gradients (error feedback, Seide et al. style) so the
compression error stays bounded instead of accumulating, and the
dequantized values are mean-reduced across the pod axis.

Note this module models the *numerics only*: the all-reduce here moves
dequantized float32, as the JAX package's ``psum`` does, so it measures
convergence impact, not wire savings.  An actual 4x-payload deployment
needs a collective that reduces the int8 tensors and scales directly.

The arithmetic is the JAX package's, in its order; divisions are tensor
by tensor on the operand's device (on the card PyTorch turns a division
by a Python number into a multiply by its reciprocal).  Gradient trees
are nested dicts of tensors, each rank holding its own.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import _tree_map

__all__ = ["quantize_int8", "dequantize_int8", "ef_compress_grads"]


def _const(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _finite(x):
    return torch.where(torch.isfinite(x), x, _const(0.0, x))


def quantize_int8(x):
    """Per-row (last axis) symmetric int8 quantization.

    Returns ``(q int8, scale f32)`` with ``scale`` shaped like ``x`` minus
    its last axis.  All-zero rows get scale 0 and survive the round trip
    exactly.  Non-finite elements (overflowed mixed-precision grads) are
    treated as 0 — otherwise one inf would drive the row scale to inf,
    the round trip to NaN, and (through error feedback) poison the
    residual for every subsequent step.
    """
    x = _finite(torch.as_tensor(x).float())
    amax = torch.amax(torch.abs(x), dim=-1)
    scale = amax / _const(127.0, x)
    safe = torch.where(scale > 0, scale, _const(1.0, x))
    q = torch.clamp(torch.round(x / safe[..., None]), -127, 127).to(
        torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * torch.as_tensor(scale).float()[..., None]


def _roundtrip(x):
    return dequantize_int8(*quantize_int8(x))


def ef_compress_grads(grads, residuals, mesh, axis_name: str = "pod"):
    """EF-quantized all-reduce-mean of a gradient tree over
    ``axis_name``.

    Each rank quantizes (grad + carried residual) to int8, the
    round-tripped values are mean-reduced over the process group of
    ``mesh``'s ``axis_name`` dim (a ``DeviceMesh`` with named dims), and
    the local quantization error becomes the new residual.  Returns
    ``(reduced, new_residuals)``.  See the module docstring: this
    reproduces the scheme's numerics; the reduction itself is float32.
    """
    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)
    # drop non-finite elements before the round trip AND the residual
    # (c - deq with an inf would otherwise feed back forever)
    c = _tree_map(lambda g, r: _finite(g + r), grads, residuals)
    deq = _tree_map(_roundtrip, c)

    def mean(d):
        d = d.clone()
        dist.all_reduce(d, op=dist.ReduceOp.SUM, group=group)
        return d / _const(float(n), d)
    red = _tree_map(mean, deq)
    res = _tree_map(torch.sub, c, deq)
    return red, res
