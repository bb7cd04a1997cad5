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
(``kernel.ssd_chunk_bwd``, under grad through ``SSDChunkFn``).  They
take plain tensors: DTensor inputs reach ``ssd_chunked`` on each rank's
local shards through ``models.ssm.ssd_chunked``.
"""

from __future__ import annotations

from typing import Optional

import torch

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

    acum = torch.cumsum(dtc.to(f32) * A.to(f32), 2)
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
