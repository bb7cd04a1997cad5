"""Public op: flash attention, the hand-written kernel or its plain
version.

``impl="kernel"`` (the default) goes through ``kernel.flash_attention``:
on CUDA tensors the Hopper kernel, on CPU tensors the plain version.
``impl="plain"`` always runs the plain version; it exists for the tests
and for ``chip_smoke.py``'s comparison on the card.
"""

from __future__ import annotations

from repro_torch.kernels.attention import kernel as _kernel
from repro_torch.kernels.attention.ref import attention_ref

__all__ = ["flash_attention", "attention_ref", "IMPLS"]

IMPLS = ("kernel", "plain")


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    impl: str = "kernel"):
    """q: (B,S,H,hd), k/v: (B,T,K,hd) -> (B,S,H,hd) float32."""
    if impl == "kernel":
        return _kernel.flash_attention(q, k, v, causal=causal, scale=scale)
    if impl == "plain":
        return attention_ref(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"bad impl {impl!r}; expected one of {IMPLS}")
