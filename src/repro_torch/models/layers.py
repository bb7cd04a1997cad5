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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.dist.api import as_dtensor, reshard

__all__ = [
    "Creator", "init_creator", "abstract_creator", "axes_creator",
    "rmsnorm", "layernorm", "softcap", "gelu_mlp", "glu_mlp", "rope_apply",
    "mrope_apply", "take_embedding", "shape_creator", "target_logits",
    "logsumexp_last",
]

# creator(path, shape, axes, fan_in=None, kind="normal") -> leaf
Creator = Callable


def init_creator(generator: torch.Generator, param_dtype=torch.float32,
                 *, device="cuda") -> Creator:
    """Truncated-normal(0, 1/sqrt(fan_in)) cut at 3 sd; norms at zero
    (rmsnorm scales by 1 + w) or one, on ``device`` (the card unless the
    caller asks for the CPU).  Draws come from ``generator`` in
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


def abstract_creator(param_dtype=torch.float32) -> Creator:
    """Yields each leaf as a ``meta`` tensor of ``param_dtype``."""
    def create(path, shape, axes, fan_in=None, kind="normal"):
        del path, axes, fan_in, kind
        return torch.empty(shape, dtype=param_dtype, device="meta")
    return create


def axes_creator() -> Creator:
    """Yields each leaf's logical-axis tuple."""
    def create(path, shape, axes, fan_in=None, kind="normal"):
        del fan_in, kind
        assert len(axes) == len(shape), f"{path}: {axes} vs {shape}"
        return tuple(axes)
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
    """x (..., a) @ w (a, ...) in the compute dtype -> (..., *w.shape[1:]).

    A DTensor projection to (heads, head_dim) whose head_dim is sharded
    (the rules put a mesh axis there when the heads don't divide it)
    runs as one product per head: flattened, that dim is strided-
    sharded, which DTensor's matrix product turns into a plain shard
    that the result cannot be unflattened from."""
    w = w.to(compute_dtype)
    x = x.to(compute_dtype)
    if isinstance(w, DTensor) and w.ndim == 3 and Shard(2) in w.placements:
        x2 = x.reshape(1, -1, w.shape[0]).expand(w.shape[1], -1, -1)
        out = torch.bmm(x2, w.permute(1, 0, 2))              # (H, N, hd)
        return out.permute(1, 0, 2).reshape(*x.shape[:-1], *w.shape[1:])
    out = x @ w.reshape(w.shape[0], -1)
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
    """The rows of ``embed`` at ``tokens``, times sqrt(d) with ``scale``.
    A DTensor table takes ``_embedding_on_shards``."""
    x = (_embedding_on_shards(embed, tokens) if isinstance(embed, DTensor)
         else embed[tokens]).to(compute_dtype)
    if scale:
        # a 0-dim host tensor: a scalar operand, no copy to the device
        x = x * torch.tensor(embed.shape[-1] ** 0.5, dtype=compute_dtype)
    return x


def _embedding_on_shards(embed, tokens):
    """A DTensor table's rows at ``tokens``, on each rank's shards: the
    table gathered but on its vocab shards, each rank looks up the
    tokens of its batch rows that fall in its vocab slice (0 for the
    rest) and the partial sums are all-reduced.  DTensor's own indexing
    has no backward sharding rule in PyTorch 2.11, and the partial sum
    of its ``F.embedding`` fails to reduce on a two-dim mesh."""
    mesh = embed.device_mesh
    vocab = [p == Shard(0) for p in embed.placements]
    tokens = as_dtensor(tokens, mesh)
    tok_pl = [Replicate() if v else p
              for v, p in zip(vocab, tokens.placements)]
    t_pl = [Shard(0) if v else Replicate() for v in vocab]
    table = embed.redistribute(mesh, t_pl).to_local(grad_placements=[
        Shard(0) if v else (Partial() if isinstance(p, Shard)
                            else Replicate())
        for v, p in zip(vocab, tok_pl)])
    shape, off = compute_local_shape_and_global_offset(embed.shape, mesh,
                                                       t_pl)
    t = tokens.redistribute(mesh, tok_pl).to_local().long() - off[0]
    hit = (t >= 0) & (t < shape[0])
    x = table[t * hit] * hit[..., None].to(table.dtype)
    out_shape = tuple(tokens.shape) + (embed.shape[-1],)
    x = DTensor.from_local(x, mesh, [Partial() if v else p for v, p in
                                     zip(vocab, tok_pl)], run_check=False,
                           shape=out_shape, stride=torch.empty(
                               out_shape, device="meta").stride())
    return reshard(x, mesh, tok_pl)


def target_logits(logits, targets):
    """``logits`` (..., V) at the int ``targets`` (...): a gather on the
    last dim.  For a DTensor whose last dim is sharded (the vocab, under
    a sharding context) each rank gathers from its own vocab slice, 0
    for a target outside it, and the result is partial over the mesh
    dims that shard the vocab: DTensor's own gather there marks the
    result with a mask of the unsqueezed rank, which a later reduction
    cannot apply."""
    last = Shard(logits.ndim - 1)
    if not isinstance(logits, DTensor) or last not in logits.placements:
        return torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    mesh, pls = logits.device_mesh, logits.placements
    shape, offset = compute_local_shape_and_global_offset(logits.shape,
                                                          mesh, pls)
    t = as_dtensor(targets, mesh).redistribute(
        mesh, [Replicate() if p == last else p for p in pls]).to_local()
    t = t.long() - offset[-1]
    hit = (t >= 0) & (t < shape[-1])
    got = torch.gather(logits.to_local(), -1, (t * hit)[..., None])[..., 0]
    return DTensor.from_local(got * hit, mesh,
                              [Partial() if p == last else p for p in pls],
                              run_check=False, shape=logits.shape[:-1],
                              stride=torch.empty(logits.shape[:-1],
                                                 device="meta").stride())


def logsumexp_last(x):
    """``torch.logsumexp`` over the last dim.  For a DTensor sharded
    there (the vocab, under a sharding context) it runs on each rank's
    slice: the row max (all-reduced), the local sum of exp(x - max), a
    partial sum that DTensor all-reduces before the log.  Left to
    DTensor, the logsumexp and its backward gather whole batches of
    logits onto every rank."""
    last = Shard(x.ndim - 1)
    if not isinstance(x, DTensor) or last not in x.placements:
        return torch.logsumexp(x, dim=-1)
    mesh, pls = x.device_mesh, x.placements
    xl = x.to_local()
    m = DTensor.from_local(
        xl.detach().amax(-1), mesh,
        [Partial("max") if p == last else p for p in pls],
        run_check=False).redistribute(
            mesh, [Replicate() if p == last else p for p in pls])
    e = torch.exp(xl - m.to_local()[..., None]).sum(-1)
    part = DTensor.from_local(e, mesh,
                              [Partial() if p == last else p for p in pls],
                              run_check=False, shape=x.shape[:-1],
                              stride=m.stride())
    return m + torch.log(part)
