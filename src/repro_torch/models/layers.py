"""Shared layer primitives and the parameter-definition factory.

One source of truth for every parameter: model code builds its parameter
tree through a ``creator`` callback ``mk(path, shape, axes, fan_in=None,
kind="normal")``, as in the JAX package, so the same definitions yield
initialised tensors (``init_creator``) or bare shapes
(``shape_creator``).  The numerics keep the JAX package's casts: norms
and rotations compute in float32 and return the input's dtype.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

__all__ = [
    "Creator", "init_creator", "shape_creator",
    "rmsnorm", "layernorm", "softcap", "gelu_mlp", "glu_mlp",
    "rope_apply", "mrope_apply", "take_embedding",
]

# creator(path, shape, axes, fan_in=None, kind="normal") -> leaf
Creator = Callable


def init_creator(generator: torch.Generator, device,
                 param_dtype=torch.float32) -> Creator:
    """Truncated-normal(0, 1/sqrt(fan_in)) cut at 3 sd; norms at zero
    (rmsnorm scales by 1 + w) or one.  Draws come from ``generator`` in
    definition order; they are not the JAX package's draws (carry its
    weights across with ``api.params_from_numpy`` to compare)."""
    def create(path, shape, axes, fan_in=None, kind="normal"):
        del path, axes
        if kind == "ones":
            return torch.ones(shape, dtype=param_dtype, device=device)
        if kind == "zeros":
            return torch.zeros(shape, dtype=param_dtype, device=device)
        scale = 1.0 / (fan_in or shape[-1]) ** 0.5
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, scale, -3.0 * scale,
                                    3.0 * scale, generator=generator)
        return w.to(param_dtype)
    return create


def shape_creator() -> Creator:
    """Yields each leaf's shape (no allocation)."""
    def create(path, shape, axes, fan_in=None, kind="normal"):
        del path, axes, fan_in, kind
        return tuple(shape)
    return create


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rmsnorm(x, w, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(dt)


def layernorm(x, w, b, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def softcap(x, cap: float):
    """Gemma-2/grok-style logit soft capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def _mm(x, w, compute_dtype):
    """x (..., a) @ w (a, ...) in the compute dtype -> (..., *w.shape[1:])."""
    w = w.to(compute_dtype)
    out = x.to(compute_dtype) @ w.reshape(w.shape[0], -1)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def gelu_mlp(x, p, compute_dtype):
    h = F.gelu(_mm(x, p["w_up"], compute_dtype), approximate="tanh")
    return _mm(h, p["w_down"], compute_dtype)


def glu_mlp(x, p, act: str, compute_dtype):
    """SwiGLU / GeGLU gated MLP (GELU in its tanh form, as jax.nn.gelu)."""
    g = _mm(x, p["w_gate"], compute_dtype)
    u = _mm(x, p["w_up"], compute_dtype)
    g = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
    return _mm(g * u, p["w_down"], compute_dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def _rope_angles(positions, head_dim: int, theta: float):
    """positions (..., S) int -> (..., S, head_dim//2) angles fp32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    return positions.float()[..., None] * freqs


def _rotate(x, angles):
    """x (..., S, H, hd); angles (..., S, hd//2) -> rotated x."""
    dt = x.dtype
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    c = torch.cos(angles)[..., None, :]   # (..., S, 1, hd//2) over heads
    s = torch.sin(angles)[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(dt)


def rope_apply(x, positions, theta: float):
    """Standard RoPE. x: (B, S, H, hd); positions: (B, S) int."""
    return _rotate(x, _rope_angles(positions, x.shape[-1], theta))


def mrope_apply(x, positions3, theta: float, sections=(2, 3, 3)):
    """Qwen2-VL M-RoPE: the hd/2 frequency slots are split into
    (t, h, w) sections, each rotated by its own position stream.

    x: (B, S, H, hd); positions3: (3, B, S) int.  ``sections`` are
    relative weights scaled to hd//2.
    """
    half = x.shape[-1] // 2
    total = sum(sections)
    sizes = [s * half // total for s in sections]
    sizes[-1] = half - sum(sizes[:-1])
    angles_full = _rope_angles(positions3, x.shape[-1], theta)  # (3,B,S,half)
    pieces, off = [], 0
    for i, sz in enumerate(sizes):
        pieces.append(angles_full[i, ..., off:off + sz])
        off += sz
    return _rotate(x, torch.cat(pieces, dim=-1))


def take_embedding(embed, tokens, scale: bool, compute_dtype):
    x = embed[tokens].to(compute_dtype)
    if scale:
        # a 0-dim host tensor: a scalar operand, no copy to the device
        x = x * torch.tensor(embed.shape[-1] ** 0.5, dtype=compute_dtype)
    return x
