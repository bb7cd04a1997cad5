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
attention-logit ``softcap`` and a sliding ``window``; on the card
``FlashAttentionFn`` raises before its forward launches when the backward
kernel has no instance for the call (``kernel.require_bwd_instance``: hd
112 and 256, a softcap, a window; ROADMAP.md, Queue 2 item 2).  ``impl="plain"``
always runs the plain version, differentiated by autograd; it exists for
the tests and for ``chip_smoke.py``'s comparison on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.attention import kernel as _kernel
from repro_torch.kernels.attention.ref import attention_ref

__all__ = ["flash_attention", "attention_ref", "FlashAttentionFn",
           "flash_attention_fwd", "IMPLS"]

IMPLS = ("kernel", "plain")


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


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with the hand-written backward: the forward saves
    q, k, v, its output and its log-sum-exp; the backward returns dq, dk
    and dv in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float,
                softcap: float = 0.0, window: int = 0):
        if q.device.type == "cuda":
            _kernel.require_bwd_instance(q.shape[-1], softcap, window)
        out, lse = flash_attention_fwd(q, k, v, causal, scale, softcap,
                                       window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.softcap, ctx.window = softcap, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _kernel.flash_attention_bwd(
            q, k, v, out, dout.float().contiguous(), lse,
            causal=ctx.causal, scale=ctx.scale, softcap=ctx.softcap,
            window=ctx.window)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    softcap=None, window: int = 0, impl: str = "kernel"):
    """q: (B,S,H,hd), k/v: (B,T,K,hd) -> (B,S,H,hd) float32; ``softcap``
    (None or 0: none) and ``window`` (0: none) as ``ref.attention_ref``
    takes them."""
    softcap, window = float(softcap or 0.0), int(window or 0)
    if impl == "kernel":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
            return FlashAttentionFn.apply(q, k, v, causal, scale, softcap,
                                          window)
        return _kernel.flash_attention(q, k, v, causal=causal, scale=scale,
                                       softcap=softcap, window=window)
    if impl == "plain":
        return attention_ref(q, k, v, causal=causal, scale=scale,
                             softcap=softcap, window=window)
    raise ValueError(f"bad impl {impl!r}; expected one of {IMPLS}")
