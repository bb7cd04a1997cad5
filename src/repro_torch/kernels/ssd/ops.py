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

The kernel takes no DTensor: its sharding is not registered (ROADMAP.md,
Queue 2 item 7), so on the card an ssm model under a sharding context
raises here; the plain version runs under one (the dry run's).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels.ssd import kernel as _kernel
from repro_torch.kernels.ssd.ref import ssd_chunk_batched_ref, ssd_chunk_ref

__all__ = ["ssd_chunked_pallas", "ssd_chunk_ref", "ssd_chunked", "IMPLS",
           "SSDChunkFn"]

IMPLS = ("kernel", "plain")


class SSDChunkFn(torch.autograd.Function):
    """The intra-chunk step with the hand-written backward: the forward
    (``kernel.ssd_chunk``) saves its inputs; the backward
    (``kernel.ssd_chunk_bwd``) takes the cotangents of (y, state, decay)
    and returns the inputs' gradients in their dtypes.  Autograd may
    hand a cotangent over strided (``y.sum()`` gives a stride-0 one),
    and the kernel takes contiguous float32, so each is made so here."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        return _kernel.ssd_chunk(x, dt, A, Bm, Cm)

    @staticmethod
    def backward(ctx, dy, dstate, ddecay):
        ins = ctx.saved_tensors
        cots = (None if g is None else g.float().contiguous()
                for g in (dy, dstate, ddecay))
        grads = _kernel.ssd_chunk_bwd(*ins, *cots)
        return tuple(g.to(t.dtype) for g, t in zip(grads, ins))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, *, h0=None,
                impl: str = "kernel"):
    """x: (B,S,H,P) dt: (B,S,H) A: (H,) Bm/Cm: (B,S,N) -> (y (B,S,H,P),
    hT (B,H,P,N)), float32.  S must be a multiple of Q = min(chunk, S);
    ``models.ssm.ssd_chunked`` pads to one.  ``h0`` (B,H,P,N) is the
    state carried in from an earlier segment."""
    if impl == "kernel":
        if isinstance(x, DTensor) and x.device.type == "cuda":
            raise NotImplementedError(
                "the SSD kernel takes no DTensor: its sharding is not "
                "registered (ROADMAP.md, Queue 2 item 7); run the ssm model "
                "unsharded on the card, or with kernel_impl=\"plain\"")
        chunk_fn = _kernel.ssd_chunk
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

    acum = torch.cumsum(dtc.to(f32) * A.to(f32), dim=2)
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
