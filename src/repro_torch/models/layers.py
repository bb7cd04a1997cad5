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

from repro_torch.dist.api import as_dtensor, hold, on_shards, reshard

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

def _rowwise(fn, x, *ws):
    """``fn(x, *ws)`` for a norm over x's last dim with weights ``ws``
    over it; a DTensor x's runs on its shard of rows (``on_shards``; a
    split last dim gathered first), the weights whole, their gradients
    partial sums over the mesh dims that split the rows."""
    last = x.ndim - 1
    rows = tuple(Replicate() if p.is_shard(last) else p
                 for p in x.placements)
    whole = (Replicate(),) * len(rows)
    sums = tuple(Partial() if p.is_shard() else Replicate() for p in rows)
    return on_shards(fn, x, *ws, ins=(rows,) + (whole,) * len(ws),
                     outs=rows, grads=(rows,) + (sums,) * len(ws))


def _on_rows(x) -> bool:
    """Whether a norm of ``x`` runs on its shard of rows: a DTensor with
    no pending partial sum (a partial sum is left to DTensor, which
    reduces it onto a shard where it can)."""
    return isinstance(x, DTensor) and not any(p.is_partial()
                                              for p in x.placements)


def _f32_node(x):
    """``x`` in float32, through an autograd node of its own even when it
    is float32 already (a view, which allocates and saves nothing): the
    norm's gradient terms for ``x`` are then summed before they meet the
    residual's, as on a DTensor's shard (``_rowwise``), so a sharded
    gradient keeps the unsharded one's bits."""
    return x.float() if x.dtype != torch.float32 else x.view_as(x)


def rmsnorm(x, w, eps: float = 1e-6):
    if _on_rows(x):
        return _rowwise(lambda u, v: rmsnorm(u, v, eps), x, w)
    dt = x.dtype
    xf = _f32_node(x)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(dt)


def layernorm(x, w, b, eps: float = 1e-5):
    if _on_rows(x):
        return _rowwise(lambda u, v, c: layernorm(u, v, c, eps), x, w, b)
    dt = x.dtype
    xf = _f32_node(x)
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
    that the result cannot be unflattened from.  The rows of either
    product are x's leading dims flattened (``_rows_whole``)."""
    w = _cast(w, compute_dtype)
    x = _cast(x, compute_dtype)
    if isinstance(x, DTensor) and isinstance(w, DTensor):
        x = _rows_whole(x, w)
    if isinstance(w, DTensor) and w.ndim == 3 and Shard(2) in w.placements:
        x2 = x.reshape(1, -1, w.shape[0]).expand(w.shape[1], -1, -1)
        out = torch.bmm(x2, w.permute(1, 0, 2))              # (H, N, hd)
        out = out.permute(1, 0, 2).reshape(*x.shape[:-1], *w.shape[1:])
    else:
        out = x @ w.reshape(w.shape[0], -1)
        out = out.reshape(*x.shape[:-1], *w.shape[1:])
    return hold(out)


def _cast(t, dtype):
    """``t.to(dtype)``, a DTensor's on its local shard (``on_shards``: as
    a DTensor operator, a cast's placement search on a mesh of four dims
    took about a second a weight)."""
    if t.dtype == dtype:
        return t
    return on_shards(lambda u: u.to(dtype), t)


def _rows_whole(x, w):
    """DTensor ``x`` with its inner leading dims (the sequence) gathered
    on each mesh dim where ``w`` splits its output, as DTensor's own
    choice for the product gathers them (the output cannot be split
    twice on one mesh dim).  Left split, they would be a strided shard
    once the rows are flattened, and DTensor's placement search would
    then price every strategy by a graph search, seconds a candidate on
    a mesh of three dims."""
    want = [Replicate() if p.is_shard() and 0 < p.dim < x.ndim - 1
            and q.is_shard() and q.dim >= 1 else p
            for p, q in zip(x.placements, w.placements)]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


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
    if isinstance(x, DTensor):
        return _rotate_on_shards(x, angles)
    dt = x.dtype
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    c = torch.cos(angles)[..., None, :]   # (..., S, 1, hd//2) over heads
    s = torch.sin(angles)[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(dt)


def _rotate_on_shards(x, angles):
    """``_rotate`` of DTensor ``x`` on each rank's shard (``on_shards``),
    with the rows of ``angles`` (broadcast over heads) that the shard
    holds: a plain tensor's sliced, a DTensor's (decode's, from the
    positions) redistributed to x's split of those rows.  A split head
    dim (the rotation mixes its halves) or a pending partial sum is
    gathered first.  Elementwise, so each shard's result is the whole
    result's; as DTensor operators, on a mesh of four dims, a good part
    of a minute a layer kind."""
    mesh, last = x.device_mesh, x.ndim - 1
    whole = tuple(Replicate() if p.is_partial() or p.is_shard(last) else p
                  for p in x.placements)
    lead = x.ndim - angles.ndim - 1      # x dims before angles' first
    if isinstance(angles, DTensor):
        rows = [Shard(p.dim - lead) if p.is_shard() and 0 <= p.dim - lead
                < angles.ndim - 1 and angles.shape[p.dim - lead]
                == x.shape[p.dim] else Replicate() for p in whole]
        local = angles.redistribute(mesh, rows).to_local()
    else:
        shape, off = compute_local_shape_and_global_offset(
            x.shape, mesh, whole)
        local = angles[tuple(
            slice(off[j + lead], off[j + lead] + shape[j + lead])
            if n == x.shape[j + lead] else slice(None)
            for j, n in enumerate(angles.shape[:-1]))]
    return on_shards(lambda u: _rotate(u, local), x, ins=(whole,))


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
