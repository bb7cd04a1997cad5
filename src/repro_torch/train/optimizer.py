"""Optimizers: AdamW (float32 moments) and AdamW8bit (int8 moments with
per-row float32 scales, the second moment stored in sqrt space).

Implemented directly on nested dicts of tensors, as the JAX package
implements them on pytrees.  The arithmetic is the JAX package's, in its
order (``src/repro/train/optimizer.py``); ``torch.round`` and
``jnp.round`` both round half to even.  One difference: ``opt_update``
updates the parameters and the state in place and returns them, as the
JAX package's trainer donates its state buffers, so that a 1.9 B
parameter model's float32 parameters, gradients and moments fit one card
once, not twice.  Divisions are tensor by tensor on the tensors' device
(on the card PyTorch turns a division by a Python number into a multiply
by its reciprocal).

DTensor leaves (a sharded step) are updated on each rank's local shards
(``_on_shards``, through ``dist.api.on_shards``), and the clip scales
them there: the arithmetic is
elementwise, so a shard's update is the whole update's rows.  Run as
DTensor operators, each operator of each leaf would cost DTensor a
placement search over every strategy of every mesh dim, minutes for a
large model's leaves on a mesh of three or four dims (the dry run).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.dist.api import on_shards
from repro_torch.dist.sharding import _tree_map

__all__ = ["OptConfig", "lr_schedule", "init_opt_state", "opt_update",
           "opt_state_axes", "abstract_opt_state", "clip_by_global_norm",
           "pick_optimizer"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"              # adamw | adamw8bit
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 200
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0


def pick_optimizer(n_params: int) -> str:
    """Float32 Adam moments don't fit device memory beyond ~100B params on
    one pod (the JAX package's rule)."""
    return "adamw8bit" if n_params > 100e9 else "adamw"


def _leaves(tree) -> list:
    """Leaves in ``jax.tree_util``'s order for nested dicts: sorted keys."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _const(x, like):
    """A float32 scalar on ``like``'s device (a tensor operand, so a
    division by it is a true division there)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def lr_schedule(cfg: OptConfig, step):
    """Linear warmup to ``lr_peak``, then a cosine to ``lr_min`` at
    ``total_steps``; float32, on ``step``'s device."""
    if isinstance(step, torch.Tensor):
        step = step.float()
    else:
        step = torch.tensor(float(step), dtype=torch.float32)
    warm = cfg.lr_peak * (step + 1.0) / _const(max(cfg.warmup_steps, 1),
                                               step)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / _const(max(cfg.total_steps - cfg.warmup_steps, 1),
                                step), 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (
        1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


# ---------------------------------------------------------------------------
# state construction (real / abstract / axes — mirrors the param factory)
# ---------------------------------------------------------------------------

def _scale_shape(shape):
    return tuple(shape[:-1]) if len(shape) >= 1 else tuple(shape)


def init_opt_state(name: str, params):
    """Zero moments on each parameter's device."""
    if name == "adamw":
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
        return {"m": _tree_map(z, params), "v": _tree_map(z, params)}
    if name == "adamw8bit":
        z8 = lambda p: torch.zeros(p.shape, dtype=torch.int8,  # noqa: E731
                                   device=p.device)
        zs = lambda p: torch.zeros(_scale_shape(p.shape),  # noqa: E731
                                   dtype=torch.float32, device=p.device)
        return {"m_q": _tree_map(z8, params), "m_s": _tree_map(zs, params),
                "v_q": _tree_map(z8, params), "v_s": _tree_map(zs, params)}
    raise ValueError(name)


def abstract_opt_state(name: str, abstract_params):
    """The state's leaves as (shape, dtype) pairs, from parameters given
    as tensors (meta tensors too) or as (shape, dtype) pairs."""
    shape = lambda p: tuple(p.shape if hasattr(p, "shape")  # noqa: E731
                            else p[0])
    if name == "adamw":
        f = lambda p: (shape(p), torch.float32)              # noqa: E731
        return {"m": _tree_map(f, abstract_params),
                "v": _tree_map(f, abstract_params)}
    if name == "adamw8bit":
        q = lambda p: (shape(p), torch.int8)                 # noqa: E731
        s = lambda p: (_scale_shape(shape(p)), torch.float32)  # noqa: E731
        return {"m_q": _tree_map(q, abstract_params),
                "m_s": _tree_map(s, abstract_params),
                "v_q": _tree_map(q, abstract_params),
                "v_s": _tree_map(s, abstract_params)}
    raise ValueError(name)


def opt_state_axes(name: str, param_axes):
    """Logical axes for the optimizer state (for the sharding engine)."""
    same = lambda a: a                                       # noqa: E731
    drop_last = lambda a: a[:-1] if len(a) >= 1 else a       # noqa: E731
    if name == "adamw":
        return {"m": _tree_map(same, param_axes),
                "v": _tree_map(same, param_axes)}
    if name == "adamw8bit":
        return {"m_q": _tree_map(same, param_axes),
                "m_s": _tree_map(drop_last, param_axes),
                "v_q": _tree_map(same, param_axes),
                "v_s": _tree_map(drop_last, param_axes)}
    raise ValueError(name)


# ---------------------------------------------------------------------------
# updates
# ---------------------------------------------------------------------------

def _local(t):
    """A replicated DTensor's value as a plain tensor; else ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to global norm <= max_norm, the global norm).  The
    squares are summed leaf by leaf in the JAX package's leaf order."""
    leaves = _leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(_const(max_norm, gn) / torch.clamp(gn, min=1e-12),
                        max=1.0)
    s = _local(scale)
    return _tree_map(lambda g: on_shards(
        lambda u: (u.float() * s).to(u.dtype), g), grads), gn


def _q8(x, rowmax=None):
    """Per-row (last dim) symmetric int8 quantization; ``rowmax`` takes
    the rows' maximum over the shards of a split last dim."""
    s = torch.amax(torch.abs(x), dim=-1)
    if rowmax is not None:
        s = rowmax(s)
    s = s / _const(127.0, x)
    safe = torch.where(s > 0, s, _const(1.0, s))[..., None]
    q = torch.clamp(torch.round(x / safe), -127, 127).to(torch.int8)
    return q, s


def _dq8(q, s):
    return q.float() * s[..., None]


def _on_shards(upd):
    """``upd(p, g, *state, rowmax=...)`` for one leaf; a DTensor leaf's
    runs on the local shards (``on_shards``), its gradient taken in the
    parameter's placements (the train step has reduced it onto them, as
    an FSDP step reduce-scatters its gradients; the state shares the
    parameter's rows), and ``rowmax`` all-reduces a per-row maximum over
    the mesh dims that split the last dim."""
    from torch.distributed._functional_collectives import all_reduce

    def run(p, g, *state):
        if not isinstance(p, DTensor):
            return upd(p, g, *state, rowmax=None)
        mesh = p.device_mesh
        dims = [d for d, pl in enumerate(p.placements)
                if p.ndim and pl.is_shard(p.ndim - 1)]

        def rowmax(s):
            for d in dims:
                s = all_reduce(s, "max", (mesh, d))
            return s
        return on_shards(lambda *ts: upd(*ts, rowmax=rowmax), p, g, *state,
                         ins=(None, p.placements) + (None,) * len(state))
    return run


@torch.no_grad()
def opt_update(name: str, cfg: OptConfig, params, grads, state, step):
    """One optimizer step at ``step`` (an int32 tensor): updates
    ``params`` and ``state`` in place and returns (params, state)."""
    lr = _local(lr_schedule(cfg, step))
    t = _local(step).float() + 1.0
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t

    def new_param(p, m, v):
        mh = m / bc1
        vh = v / bc2
        pf = p.float()
        p.copy_(pf - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                           + cfg.weight_decay * pf))

    if name == "adamw":
        def upd(p, g, m, v, rowmax):
            g = g.float()
            m.copy_(cfg.b1 * m + (1.0 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1.0 - cfg.b2) * g * g)
            new_param(p, m, v)
        _tree_map(_on_shards(upd), params, grads, state["m"], state["v"])
        return params, state

    if name == "adamw8bit":
        def upd(p, g, mq, ms, vq, vs, rowmax):
            g = g.float()
            m = cfg.b1 * _dq8(mq, ms) + (1.0 - cfg.b1) * g
            # v is stored in sqrt space: linear int8 cannot represent v's
            # dynamic range (tiny second moments quantize to 0 and the
            # update explodes); sqrt halves the range in decades.
            v_prev = _dq8(vq, vs) ** 2
            v = cfg.b2 * v_prev + (1.0 - cfg.b2) * g * g
            new_param(p, m, v)
            for dst, src in zip((mq, ms, vq, vs),
                                (*_q8(m, rowmax), *_q8(torch.sqrt(v),
                                                       rowmax))):
                dst.copy_(src)
        _tree_map(_on_shards(upd), params, grads, state["m_q"],
                  state["m_s"], state["v_q"], state["v_s"])
        return params, state
    raise ValueError(name)
