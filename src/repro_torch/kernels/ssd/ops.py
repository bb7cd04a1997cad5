"""Public op: the chunked SSD built on the intra-chunk kernel.

The counterpart of the JAX package's ``kernels/ssd/ops.py::
ssd_chunked_pallas``, which keeps its name and signature here and runs
``ssd_chunked`` on its default route.  ``impl="kernel"`` (the default)
computes the intra-chunk step with ``kernel.ssd_chunk``: on CUDA tensors
the Hopper kernel, on CPU tensors its plain version.  ``impl="plain"``
always runs the plain version; it exists for the tests and for
``chip_smoke.py``'s comparison on the card.  The inter-chunk state recurrence is a short
loop over the chunks and the inter-chunk output an einsum, as the JAX
package keeps both outside its kernel.

The kernel route goes through two operators, ``torch.ops.repro_torch.
ssd_chunk_fwd`` (``kernel.ssd_chunk``) and ``ssd_chunk_bwd``
(``kernel.ssd_chunk_bwd``, under grad through ``SSDChunkFn``).  Each has its sharding registered (``register_sharding``):
all inputs replicated; sharded on batch (dim 0 of x, dt, B, C, the
cotangents and every output but dA, with A replicated); or sharded on
heads where the mesh's size divides H (x, dt and dy on dim 3, A on dim
0, dstate and ddecay on dim 2, B and C replicated; y on dim 3, the state
and the decay on dim 2).  The backward's sums over what a strategy
splits come back as pending partial sums: dA under batch, dB and dC
under heads.  DTensor redistributes any other placement to one of these
before the call, and the kernels run unchanged on each rank's local
shards.  The plain route runs under DTensor as aten operators.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from repro_torch.kernels._dtensor import along_shards
from repro_torch.kernels.ssd import kernel as _kernel
from repro_torch.kernels.ssd.ref import ssd_chunk_batched_ref, ssd_chunk_ref

__all__ = ["ssd_chunked_pallas", "ssd_chunk_ref", "ssd_chunked", "IMPLS",
           "SSDChunkFn", "ssd_chunk_fwd", "ssd_chunk_bwd"]

IMPLS = ("kernel", "plain")


@torch.library.custom_op("repro_torch::ssd_chunk_fwd", mutates_args=())
def ssd_chunk_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y (B,c,Q,H,P), sstate (B,c,H,P,N), decay (B,c,H)) float32: the
    intra-chunk kernel, as one operator.  Its outputs are contiguous, as
    the fake says (the CPU's plain version returns a permuted y)."""
    return tuple(t.contiguous() for t in _kernel.ssd_chunk(x, dt, A, Bm,
                                                           Cm))


@ssd_chunk_fwd.register_fake
def _(x, dt, A, Bm, Cm):
    B, c, Q, H, P = x.shape
    f32 = torch.float32
    return (x.new_empty((B, c, Q, H, P), dtype=f32),
            x.new_empty((B, c, H, P, Bm.shape[-1]), dtype=f32),
            x.new_empty((B, c, H), dtype=f32))


@torch.library.custom_op("repro_torch::ssd_chunk_bwd", mutates_args=())
def ssd_chunk_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor,
                  dy: Optional[torch.Tensor], dstate: Optional[torch.Tensor],
                  ddecay: Optional[torch.Tensor]
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor]:
    """(dx, ddt, dA, dB, dC) float32: the backward kernel, as one
    operator (a cotangent of None counts as zeros); contiguous, as
    ``ssd_chunk_fwd``'s."""
    return tuple(t.contiguous() for t in _kernel.ssd_chunk_bwd(
        x, dt, A, Bm, Cm, dy, dstate, ddecay))


@ssd_chunk_bwd.register_fake
def _(x, dt, A, Bm, Cm, dy, dstate, ddecay):
    return tuple(t.new_empty(t.shape, dtype=torch.float32)
                 for t in (x, dt, A, Bm, Cm))


def _strategies(x, outs: str, ins: str) -> list:
    """The sharding strategies of the two operators on one mesh dim:
    (output placements, input placements) for all replicated, for batch
    and, where the mesh's size divides the heads, for heads.  A letter
    of ``outs`` and ``ins`` names a tensor's kind: "x" a (B,c,Q,H,...)
    tensor, "s" a (B,c,H,...) one, "a" A or dA (H,), "b" B, C, dB or dC
    (B,c,Q,N), "-" an absent cotangent.  Under batch dA is a partial sum
    over the ranks' rows, under heads dB and dC over their heads."""
    def pl(kinds, table, partial=""):
        return [None if k == "-" else Partial() if k == partial
                else table.get(k, Replicate()) for k in kinds]
    batch = {"x": Shard(0), "s": Shard(0), "b": Shard(0)}
    heads = {"x": Shard(3), "s": Shard(2), "a": Shard(0)}
    done = [(pl(outs, {}), pl(ins, {})),
            (pl(outs, batch, "a"), pl(ins, batch))]
    if x.shape[3] % x.mesh.size() == 0:
        done.append((pl(outs, heads, "b"), pl(ins, heads)))
    return done


@register_sharding(torch.ops.repro_torch.ssd_chunk_fwd.default)
def _(x, dt, A, Bm, Cm):
    # outputs (y, sstate, decay), inputs (x, dt, A, Bm, Cm)
    return _strategies(x, "xss", "xxabb")


@register_sharding(torch.ops.repro_torch.ssd_chunk_bwd.default)
def _(x, dt, A, Bm, Cm, dy, dstate, ddecay):
    # outputs (dx, ddt, dA, dB, dC), inputs (x, dt, A, Bm, Cm, dy, dstate,
    # ddecay)
    cots = "".join("-" if t is None else k
                   for t, k in zip((dy, dstate, ddecay), "xss"))
    return _strategies(x, "xxabb", "xxabb" + cots)


class SSDChunkFn(torch.autograd.Function):
    """The intra-chunk step with the hand-written backward: the forward
    (the operator ``ssd_chunk_fwd``) saves its inputs; the backward (the
    operator ``ssd_chunk_bwd``) takes the cotangents of (y, state,
    decay) and returns the inputs' gradients in their dtypes.  Autograd
    may hand a cotangent over strided (``y.sum()`` gives a stride-0
    one), and the kernel takes contiguous float32, so each is made so
    here."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        return ssd_chunk_fwd(x, dt, A, Bm, Cm)

    @staticmethod
    def backward(ctx, dy, dstate, ddecay):
        ins = ctx.saved_tensors
        cots = (None if g is None else g.float().contiguous()
                for g in (dy, dstate, ddecay))
        grads = ssd_chunk_bwd(*ins, *cots)
        return tuple(g.to(t.dtype) for g, t in zip(grads, ins))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, *, h0=None,
                impl: str = "kernel"):
    """x: (B,S,H,P) dt: (B,S,H) A: (H,) Bm/Cm: (B,S,N) -> (y (B,S,H,P),
    hT (B,H,P,N)), float32.  S must be a multiple of Q = min(chunk, S);
    ``models.ssm.ssd_chunked`` pads to one.  ``h0`` (B,H,P,N) is the
    state carried in from an earlier segment."""
    if impl == "kernel":
        chunk_fn = ssd_chunk_fwd
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, dt, A, Bm, Cm)):
            chunk_fn = SSDChunkFn.apply
    elif impl == "plain":
        chunk_fn = ssd_chunk_batched_ref
    else:
        raise ValueError(f"bad impl {impl!r}; expected one of {IMPLS}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"S {S} is not a multiple of the chunk {Q}")
    c = S // Q
    f32 = torch.float32

    xc = x.reshape(B, c, Q, H, P)
    dtc = dt.reshape(B, c, Q, H)
    Bc = Bm.reshape(B, c, Q, N)
    Cc = Cm.reshape(B, c, Q, N)
    y_intra, sstate, decay = chunk_fn(xc, dtc, A, Bc, Cc)

    h = (torch.zeros((B, H, P, N), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    h_prevs = []
    for k in range(c):
        h_prevs.append(h)
        h = h * decay[:, k, :, None, None] + sstate[:, k]
    h_prevs = torch.stack(h_prevs, dim=1)               # (B,c,H,P,N)

    acum = along_shards(lambda t: torch.cumsum(t, 2),
                        dtc.to(f32) * A.to(f32), 2)
    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cc.to(f32),
                           torch.exp(acum), h_prevs)
    return (y_intra + y_inter).reshape(B, S, H, P), h


def ssd_chunked_pallas(x, dt, A, Bm, Cm, chunk: int, *, h0=None,
                       interpret: bool = True):
    """The JAX package's public op: ``ssd_chunked`` on the kernel route
    (the Hopper kernel on CUDA tensors, its plain version on CPU
    tensors); ``interpret`` is accepted and dropped."""
    del interpret
    return ssd_chunked(x, dt, A, Bm, Cm, chunk, h0=h0)
