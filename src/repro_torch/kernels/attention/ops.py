"""Public op: flash attention, the hand-written kernels or their plain
versions, differentiable.

``impl="kernel"`` (the default) goes through ``kernel.flash_attention``:
on CUDA tensors the Hopper kernel, on CPU tensors the plain version.
When grad mode is on and q, k or v requires grad it goes through
``FlashAttentionFn``, whose forward keeps the kernel's log-sum-exp and
whose backward is ``kernel.flash_attention_bwd`` (the Hopper backward
kernel on the card, ``ref.attention_bwd_ref`` on the CPU).  The forward
with its log-sum-exp is the operator ``torch.ops.repro_torch.
flash_attention_fwd``, so a selective activation checkpoint can keep its
outputs (``models.transformer``'s "dots" policies).  Every form takes an
attention-logit ``softcap`` and a sliding ``window``, forward and
backward, at every head dim of ``kernel.HEAD_DIMS``; on the card
``FlashAttentionFn`` raises before its forward launches for a call the
backward kernel does not take (``kernel.require_bwd_instance``: another
head dim, or a window that leaves a row with no key).  ``impl="plain"``
always runs the plain version, differentiated by autograd; it exists for
the tests and for ``chip_smoke.py``'s comparison on the card.

Under DTensor: the forward and the backward are the operators
``flash_attention_fwd`` and ``flash_attention_bwd``, each with its
sharding registered (``register_sharding``): all inputs replicated,
sharded on batch (dim 0 of q, k, v, the outputs and the gradients, and
of lse), or sharded on heads (dim 2 of q, k and v and their gradients,
dim 1 of lse) where the mesh's size divides the KV heads, so that every
rank's q heads meet their own KV heads.  DTensor redistributes any
other placement to one of these before the call, and the hand-written
kernels run unchanged on each rank's local shards.  The plain version
on DTensors runs on local shards too, placed by ``_local_placements``
(the same three choices), and blocked (``ref.attention_ref_blocked``)
at S T >= ``PLAIN_BLOCKED_AT``, where the JAX package's attention runs
its chunked form: a dry run's memory then sees what the reference's
does.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import register_sharding

from repro_torch.kernels.attention import kernel as _kernel
from repro_torch.kernels.attention.ref import (attention_ref,
                                               attention_ref_blocked)

__all__ = ["flash_attention", "attention_ref", "FlashAttentionFn",
           "flash_attention_fwd", "flash_attention_bwd", "IMPLS"]

IMPLS = ("kernel", "plain")
PLAIN_BLOCKED_AT = 16_384 ** 2     # the JAX package's chunked_threshold^2


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, scale: float, softcap: float = 0.0,
                        window: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out (B,S,H,hd) float32, lse (B,H,S) float32): the forward kernel
    with its log-sum-exp, as one operator (softcap 0: none; window 0:
    none)."""
    return _kernel.flash_attention(q, k, v, causal=causal, scale=scale,
                                   softcap=softcap, window=window,
                                   return_lse=True)


@flash_attention_fwd.register_fake
def _(q, k, v, causal, scale, softcap=0.0, window=0):
    B, S, H, hd = q.shape
    return (q.new_empty((B, S, H, hd), dtype=torch.float32),
            q.new_empty((B, H, S), dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, causal: bool, scale: float,
                        softcap: float = 0.0, window: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) float32: the backward kernel, as one operator."""
    return tuple(t.float() for t in _kernel.flash_attention_bwd(
        q, k, v, out, dout, lse, causal=causal, scale=scale,
        softcap=softcap, window=window))


@flash_attention_bwd.register_fake
def _(q, k, v, out, dout, lse, causal, scale, softcap=0.0, window=0):
    return tuple(t.new_empty(t.shape, dtype=torch.float32)
                 for t in (q, k, v))


def _strategies(q, k, outs: list, ins: list, n_args: int) -> list:
    """The sharding strategies of the two operators on one mesh dim:
    (output placements, input placements) for all replicated, for batch
    and, where the mesh's size divides the KV heads, for heads.  An
    entry of ``outs`` and ``ins`` is None for a (B, S or T, heads, hd)
    tensor, "lse" for the (B, H, S) log-sum-exp."""
    def pl(entries, heads):
        return [Shard(0) if not heads else Shard(1 if d == "lse" else 2)
                for d in entries]
    rest = [None] * (n_args - len(ins))
    done = [([Replicate()] * len(outs), [Replicate()] * len(ins) + rest),
            (pl(outs, False), pl(ins, False) + rest)]
    if k.shape[2] % q.mesh.size() == 0:
        done.append((pl(outs, True), pl(ins, True) + rest))
    return done


@register_sharding(torch.ops.repro_torch.flash_attention_fwd.default)
def _(q, k, v, causal, scale, softcap=0.0, window=0):
    # outputs (out, lse), inputs (q, k, v)
    return _strategies(q, k, [None, "lse"], [None] * 3, 7)


@register_sharding(torch.ops.repro_torch.flash_attention_bwd.default)
def _(q, k, v, out, dout, lse, causal, scale, softcap=0.0, window=0):
    # outputs (dq, dk, dv), inputs (q, k, v, out, dout, lse)
    return _strategies(q, k, [None] * 3, [None] * 5 + ["lse"], 10)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with the hand-written backward: the forward saves
    q, k, v, its output and its log-sum-exp; the backward returns dq, dk
    and dv in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float,
                softcap: float = 0.0, window: int = 0):
        if q.device.type == "cuda":
            _kernel.require_bwd_instance(q.shape[-1], q.shape[1],
                                         k.shape[1], window)
        out, lse = flash_attention_fwd(q, k, v, causal, scale, softcap,
                                       window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.softcap, ctx.window = softcap, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, dout.float().contiguous(), lse, ctx.causal,
            ctx.scale, ctx.softcap, ctx.window)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def flash_attention(q, k, v, *, causal: bool = True,
                    use_pallas: bool = True, interpret: bool = True,
                    scale=None, softcap=None, window: int = 0,
                    impl: str = "kernel"):
    """q: (B,S,H,hd), k/v: (B,T,K,hd) -> (B,S,H,hd) float32; ``softcap``
    (None or 0: none) and ``window`` (0: none) as ``ref.attention_ref``
    takes them.  On DTensors the output comes back in q's placements
    (a pending partial sum reduced), whatever layout the call ran in:
    heads-sharded q gives heads-sharded output for the output projection
    to contract locally.

    ``use_pallas`` and ``interpret`` are the JAX package's keywords:
    ``use_pallas=False`` runs the plain version (as ``impl="plain"``),
    ``use_pallas=True`` leaves the route to ``impl``; ``interpret`` is
    accepted and dropped (there is nothing to interpret on the card)."""
    del interpret
    if not use_pallas:
        impl = "plain"
    softcap, window = float(softcap or 0.0), int(window or 0)
    if impl not in IMPLS:
        raise ValueError(f"bad impl {impl!r}; expected one of {IMPLS}")
    if impl == "plain":
        kw = dict(causal=causal, scale=scale, softcap=softcap, window=window)
        out = (_plain_on_shards(q, k, v, **kw) if isinstance(q, DTensor)
               else attention_ref(q, k, v, **kw))
    else:
        scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            out = FlashAttentionFn.apply(q, k, v, causal, scale, softcap,
                                         window)
        elif isinstance(q, DTensor):
            out = flash_attention_fwd(q, k, v, causal, scale, softcap,
                                      window)[0]
        else:
            return _kernel.flash_attention(q, k, v, causal=causal,
                                           scale=scale, softcap=softcap,
                                           window=window)
    if isinstance(q, DTensor):
        want = tuple(Replicate() if p.is_partial() else p
                     for p in q.placements)
        if out.placements != want:
            out = out.redistribute(q.device_mesh, want)
            if not out.to_local().is_contiguous():
                # a shard cut from a larger block is a strided view,
                # which a later DTensor reshape would view wrongly
                out = DTensor.from_local(out.to_local().contiguous(),
                                         out.device_mesh, out.placements,
                                         run_check=False, shape=out.shape,
                                         stride=out.stride())
    return out


def _local_placements(q, k):
    """(placements, expand) for the plain version on shards: per mesh dim
    of q's mesh, heads (``Shard(2)``) where q is heads-sharded there, or
    batch (``Shard(0)``), or heads, where the dim's size divides what is
    left of them, else ``Replicate()``.  When q's heads are sharded more
    finely than the KV heads divide, ``expand`` says to repeat each KV
    head for its G query heads first (each rank then holds the KV head
    of its own query heads)."""
    mesh = q.device_mesh
    B, H, K = q.shape[0], q.shape[2], k.shape[2]
    n_heads = 1
    for i, p in enumerate(q.placements):
        if p == Shard(2):
            n_heads *= mesh.size(i)
    expand = K % n_heads != 0 and H % n_heads == 0
    K = H if expand else K
    out = []
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        for d in ([2, 0] if p == Shard(2) else [0, 2]):
            if (B if d == 0 else K) % n == 0:
                out.append(Shard(d))
                B, K = (B // n, K) if d == 0 else (B, K // n)
                break
        else:
            out.append(Replicate())
    return out, expand


def _plain_on_shards(q, k, v, **kw):
    """The plain version on each rank's shards of DTensor inputs, placed
    by ``_local_placements``; blocked at S T >= ``PLAIN_BLOCKED_AT``.
    An expanded call gathers k and v over the heads' mesh dims and takes
    the rank's query heads' KV heads locally (their gradient is partial
    there)."""
    mesh = q.device_mesh
    pl, expand = _local_placements(q, k)
    ql = q.redistribute(mesh, pl).to_local()
    if expand:
        H, K = q.shape[2], k.shape[2]
        shape, off = compute_local_shape_and_global_offset(q.shape, mesh, pl)
        kv_pl = [Replicate() if p == Shard(2) else p for p in pl]
        grad_pl = [Partial() if p == Shard(2) else p for p in pl]

        def local(t):
            t = t.redistribute(mesh, kv_pl).to_local(grad_placements=grad_pl)
            Bl, T, _, hd = t.shape
            t = t[:, :, :, None].expand(Bl, T, K, H // K, hd)
            return t.reshape(Bl, T, H, hd)[:, :, off[2]:off[2] + shape[2]]
        kl, vl = local(k), local(v)
    else:
        kl, vl = (t.redistribute(mesh, pl).to_local() for t in (k, v))
    ref = (attention_ref_blocked if q.shape[1] * k.shape[1]
           >= PLAIN_BLOCKED_AT else attention_ref)
    out = ref(ql, kl, vl, **kw).contiguous()
    return DTensor.from_local(out, mesh, pl, run_check=False,
                              shape=q.shape, stride=out.new_empty(
                                  q.shape, device="meta").stride())
