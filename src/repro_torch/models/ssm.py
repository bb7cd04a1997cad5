"""Mamba2 / SSD (state-space duality) block, chunked.

Prefill uses the chunked SSD form: within a chunk a masked (Q x Q)
product pair, which the SSD op (``kernels.ssd``) computes — on the card
the hand-written Hopper kernel, on the CPU its plain version — and
chunks exchange an (H, P, N) state through a short loop.  Decode is the
O(1) recurrent update in plain PyTorch, as the JAX package leaves it to
XLA.  The casts follow the JAX package step for step: projections in the
compute dtype (dt's with float32 accumulation in prefill), the SSD and
the gated RMSNorm in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.api import on_shards, reduce_partials
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.layers import _mm

__all__ = ["mamba_param_defs", "mamba_block", "mamba_decode_step",
           "ssd_chunked", "ssd_reference", "causal_conv1d",
           "conv_decode_step", "init_ssm_cache_spec", "F32_LEAVES"]

# parameters the block reads in float32 (the model holds them so)
F32_LEAVES = ("A_log", "dt_bias", "D_skip", "gnorm")


def mamba_param_defs(mk, prefix: str, cfg: ArchConfig, *, layers: int = 0):
    L = (layers,) if layers else ()
    lax_ = ("layers",) if layers else ()
    d, di = cfg.d_model, cfg.d_inner
    n, h, kc = cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_conv
    return {
        "w_x": mk(f"{prefix}.w_x", L + (d, di), lax_ + ("d_model",
                                                        "ssm_inner"), d),
        "w_z": mk(f"{prefix}.w_z", L + (d, di), lax_ + ("d_model",
                                                        "ssm_inner"), d),
        "w_B": mk(f"{prefix}.w_B", L + (d, n), lax_ + ("d_model",
                                                       "ssm_state"), d),
        "w_C": mk(f"{prefix}.w_C", L + (d, n), lax_ + ("d_model",
                                                       "ssm_state"), d),
        "w_dt": mk(f"{prefix}.w_dt", L + (d, h), lax_ + ("d_model",
                                                         "ssm_heads"), d),
        "dt_bias": mk(f"{prefix}.dt_bias", L + (h,), lax_ + ("ssm_heads",),
                      kind="zeros"),
        "A_log": mk(f"{prefix}.A_log", L + (h,), lax_ + ("ssm_heads",),
                    kind="zeros"),
        "D_skip": mk(f"{prefix}.D_skip", L + (h,), lax_ + ("ssm_heads",),
                     kind="ones"),
        "conv_x": mk(f"{prefix}.conv_x", L + (kc, di), lax_ + ("conv",
                                                               "ssm_inner"),
                     kc),
        "conv_B": mk(f"{prefix}.conv_B", L + (kc, n), lax_ + ("conv",
                                                              "ssm_state"),
                     kc),
        "conv_C": mk(f"{prefix}.conv_C", L + (kc, n), lax_ + ("conv",
                                                              "ssm_state"),
                     kc),
        "gnorm": mk(f"{prefix}.gnorm", L + (di,), lax_ + ("ssm_inner",),
                    kind="zeros"),
        "w_out": mk(f"{prefix}.w_out", L + (di, d), lax_ + ("ssm_inner",
                                                            "d_model"), di),
    }


def _pad_seq(t, before: int = 0, after: int = 0):
    """``t`` zero-padded along dim 1, the sequence; a DTensor's on each
    rank's shard (``on_shards``), a split sequence or a pending partial
    sum gathered first.  (PyTorch 2.11's DTensor gives ``constant_pad_nd``
    one output placement on a mesh of two or more dims, which a view in
    the backward rejects.)"""
    pad = (0, 0) * (t.dim() - 2) + (before, after)
    shape = (t.shape[0], t.shape[1] + before + after) + tuple(t.shape[2:])
    whole = (None if not isinstance(t, DTensor) else
             tuple(Replicate() if p.is_partial() or p.is_shard(1) else p
                   for p in t.placements))
    return on_shards(lambda u: F.pad(u, pad), t, ins=(whole,), shape=shape)


def causal_conv1d(x, w):
    """Depthwise causal conv. x: (B, S, C); w: (K, C)."""
    K, S = w.shape[0], x.shape[1]
    pad = _pad_seq(x, K - 1)
    acc = torch.zeros_like(x)
    for i in range(K):
        acc = acc + pad[:, i:i + S] * w[i]
    return acc


def conv_decode_step(x_t, conv_state, w):
    """One-token causal conv. x_t: (B, C); conv_state: (B, K-1, C)."""
    window = torch.cat([conv_state, x_t[:, None]], dim=1)    # (B,K,C)
    y = torch.einsum("bkc,kc->bc", window, w)
    return y, window[:, 1:]


def ssd_reference(x, dt, A, Bm, Cm):
    """Sequential SSD oracle (a loop over time).

    x: (B,S,H,P) dt: (B,S,H) A: (H,)<=0 exponent coeff  Bm/Cm: (B,S,N).
    h_t = h_{t-1} * exp(dt_t A) + dt_t * B_t (x) x_t ;  y_t = C_t . h_t
    Returns (y (B,S,H,P), final state (B,H,P,N)), float32.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    x, dt, Bm, Cm = (t.float() for t in (x, dt, Bm, Cm))
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A)                       # (B,H)
        upd = torch.einsum("bn,bhp,bh->bhpn", Bm[:, t], x[:, t], dt[:, t])
        h = h * decay[..., None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], h))
    return torch.stack(ys, dim=1), h


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None,
                impl: str = "kernel"):
    """Chunked SSD (Mamba-2 paper section 6) through the SSD op.  S is
    zero-padded to a multiple of Q = min(chunk, S): dt = 0 at the padded
    steps gives decay 1 and no state update, so the tail is inert.
    Returns (y (B,S,H,P), final_state (B,H,P,N)), float32."""
    S = x.shape[1]
    Q = min(chunk, S)
    if S % Q:
        pad = Q - S % Q
        x, dt, Bm, Cm = (_pad_seq(t, 0, pad) for t in (x, dt, Bm, Cm))
    f32 = torch.float32
    y, hT = _ssd_on_shards(
        lambda x, dt, A, Bm, Cm, h0: ssd_ops.ssd_chunked(
            x, dt, A, Bm, Cm, Q, h0=h0, impl=impl),
        x.to(f32).contiguous(), dt.to(f32).contiguous(), A.to(f32),
        Bm.to(f32).contiguous(), Cm.to(f32).contiguous(), h0)
    return y[:, :S], hT


# an SSD tensor's placement on a mesh dim that splits x on batch, or on
# heads, by kind: "x" x, dt or y (B,S,H,...), "a" A (H,), "b" B or C
# (B,S,N), "s" a state (B,H,P,N); under batch A's gradient sums over the
# split, under heads B's and C's
_SSD_SPLIT = {"x": (Shard(0), Shard(2)), "a": (Replicate(), Shard(0)),
              "b": (Shard(0), Replicate()), "s": (Shard(0), Shard(1))}


def _ssd_on_shards(fn, x, dt, A, Bm, Cm, h0):
    """``fn`` (the SSD op) of DTensor inputs on each rank's shards
    (``on_shards``), a mesh dim at a time: batch where x is split on
    batch, heads where on heads, else whole; the other inputs are
    redistributed to match, and their gradients come back as partial
    sums where the split sums over them.  The SSD's products, recurrence
    and cumsum are then operators on local tensors, which a counter sees
    at their local shapes: as DTensor operators, on a mesh of three
    dims, DTensor priced each product's strategies by a graph search
    per candidate, minutes a product on the CPU (and PyTorch 2.11's
    DTensor has no rule for the cumsum's backward, a flip).  Plain
    inputs: ``fn`` as it is."""
    if not isinstance(x, DTensor):
        return fn(x, dt, A, Bm, Cm, h0)
    splits = [0 if p.is_shard(0) else 1 if p.is_shard(2) else None
              for p in x.placements]

    def pl(kind, grad=False):
        return tuple(Replicate() if m is None else
                     Partial() if grad and kind == "ab"[m] else
                     _SSD_SPLIT[kind][m] for m in splits)
    kinds = ("x", "x", "a", "b", "b", "s")
    return on_shards(fn, x, dt, A, Bm, Cm, h0,
                     ins=tuple(pl(k) for k in kinds),
                     grads=tuple(pl(k, True) for k in kinds),
                     outs=(pl("x"), pl("s")))


def _gated_rmsnorm(y, z, gnorm, compute_dtype):
    """mamba2's norm(y * silu(z)) in float32 with weight 1 + gnorm."""
    y = y * F.silu(z)
    yf = y.float()
    y = yf * torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + 1e-6)
    return (y * (1.0 + gnorm.float())).to(compute_dtype)


def _split_conv(conv_out, di: int, n: int):
    return (conv_out[..., :di], conv_out[..., di:di + n],
            conv_out[..., di + n:])


def _conv_seq(conv_in, w, conv_state, K: int):
    """The causal conv of a sequence, continued from ``conv_state`` (its
    last K - 1 inputs) when given."""
    if conv_state is None:
        return causal_conv1d(conv_in, w)
    ext = torch.cat([conv_state.to(conv_in.dtype), conv_in], dim=1)
    return causal_conv1d(ext, w)[:, K - 1:]


def _heads(t, H: int, P: int):
    """(B, S, H * P) as (B, S, H, P).  A DTensor split on the last dim
    over more ranks than divide the heads is gathered on those mesh dims
    first (the conv keeps the inner dim's shards, ``mamba_block``)."""
    if isinstance(t, DTensor):
        dims = [d for d, p in enumerate(t.placements) if p.is_shard(2)]
        if H % math.prod(t.device_mesh.size(d) for d in dims):
            t = t.redistribute(t.device_mesh, [
                Replicate() if d in dims else p
                for d, p in enumerate(t.placements)])
    return t.reshape(*t.shape[:2], H, P)


def _conv_weight(p, compute_dtype):
    return torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]],
                     dim=-1).to(compute_dtype)


def mamba_block(x, p, cfg: ArchConfig, compute_dtype=torch.bfloat16,
                conv_state=None, ssm_state=None, ssd_impl: str = "kernel"):
    """Full Mamba2 block over a sequence (prefill; with ``conv_state`` and
    ``ssm_state`` it continues an earlier segment).

    x: (B, S, D) -> (B, S, D).  Returns (out, (conv_state, ssm_state)).
    ``ssd_impl`` selects the SSD op (``kernels.ssd.ops``).
    """
    B, S, D = x.shape
    di, n = cfg.d_inner, cfg.ssm_state
    H, P = cfg.ssm_nheads, cfg.ssm_headdim
    cdt = compute_dtype

    xin = _mm(x, p["w_x"], cdt)
    z = _mm(x, p["w_z"], cdt)
    Bm = _mm(x, p["w_B"], cdt)
    Cm = _mm(x, p["w_C"], cdt)
    # bf16 products accumulated in float32 (preferred_element_type)
    dt = x.to(cdt).float() @ p["w_dt"].to(cdt).float()

    K = cfg.ssm_conv
    if isinstance(xin, DTensor):
        # one conv a part (the conv is depthwise): a concat along the
        # model-split inner dim would gather it whole on every model
        # rank, and the SSD after it would then run whole on each
        parts = (xin, Bm, Cm)
        new_conv_state = torch.cat([t[:, -(K - 1):] for t in parts], dim=-1)
        states = ((None,) * 3 if conv_state is None
                  else _split_conv(conv_state, di, n))
        xin, Bm, Cm = (F.silu(_conv_seq(t, p[w].to(cdt), st, K))
                       for t, w, st in zip(parts,
                                           ("conv_x", "conv_B", "conv_C"),
                                           states))
    else:
        conv_in = torch.cat([xin, Bm, Cm], dim=-1)
        new_conv_state = conv_in[:, -(K - 1):, :]
        conv_out = _conv_seq(conv_in, _conv_weight(p, cdt), conv_state, K)
        xin, Bm, Cm = _split_conv(F.silu(conv_out), di, n)

    dt = F.softplus(dt + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    xh = _heads(xin, H, P)
    y, hT = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk, h0=ssm_state,
                        impl=ssd_impl)
    y = y + xh.float() * p["D_skip"].float()[None, None, :, None]
    y = y.reshape(B, S, di).to(cdt)
    y = _gated_rmsnorm(y, z, p["gnorm"], cdt)
    out = _mm(y, p["w_out"], cdt)
    return out, (new_conv_state.to(cdt), hT)


def mamba_decode_step(x, p, cfg: ArchConfig, conv_state, ssm_state,
                      compute_dtype=torch.bfloat16):
    """One-token recurrent update. x: (B, 1, D); states carried (new
    tensors are returned, the inputs are not written)."""
    B = x.shape[0]
    di, n = cfg.d_inner, cfg.ssm_state
    H, P = cfg.ssm_nheads, cfg.ssm_headdim
    cdt = compute_dtype
    xt = x[:, 0]

    # the products' pending partial sums reduced onto the batch shards
    # before the concat (``reduce_partials``)
    xin, z = (reduce_partials(_mm(xt, p[w], cdt), ("batch", "ssm_inner"))
              for w in ("w_x", "w_z"))
    Bm, Cm = (reduce_partials(_mm(xt, p[w], cdt), ("batch", "ssm_state"))
              for w in ("w_B", "w_C"))
    dt = reduce_partials(_mm(xt, p["w_dt"], cdt),
                         ("batch", "ssm_heads")).float()

    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_out, new_conv_state = conv_decode_step(
        conv_in, conv_state.to(cdt), _conv_weight(p, cdt))
    xin, Bm, Cm = _split_conv(F.silu(conv_out), di, n)

    dt = F.softplus(dt + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * A)                                  # (B,H)

    xh = xin.reshape(B, H, P).float()
    upd = torch.einsum("bn,bhp,bh->bhpn", Bm.float(), xh, dt)
    h = ssm_state * decay[..., None, None] + upd               # (B,H,P,N)
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), h)
    y = y + xh * p["D_skip"].float()[None, :, None]
    y = y.reshape(B, di).to(cdt)
    y = _gated_rmsnorm(y, z, p["gnorm"], cdt)
    out = _mm(y, p["w_out"], cdt)[:, None, :]
    return out, (new_conv_state.to(cdt), h)


def init_ssm_cache_spec(cfg: ArchConfig, batch: int, n_layers: int,
                        state_dtype=torch.float32,
                        conv_dtype=torch.bfloat16) -> dict:
    """Cache leaf (shape, dtype): ``conv`` (L, B, K-1, d_inner + 2N) and
    ``ssm`` (L, B, H, P, N)."""
    di, n = cfg.d_inner, cfg.ssm_state
    return {
        "conv": ((n_layers, batch, cfg.ssm_conv - 1, di + 2 * n),
                 conv_dtype),
        "ssm": ((n_layers, batch, cfg.ssm_nheads, cfg.ssm_headdim,
                 cfg.ssm_state), state_dtype),
    }
