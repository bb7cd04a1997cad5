"""Plain PyTorch versions of the flash-attention kernels (GQA forward
and backward).

``attention_ref`` is the same function as the JAX package's
``kernels/attention/ref.py::attention_ref``: the full (S, T) score
matrix in float32, a causal mask aligned at the first position,
softmax, then the weighted sum of v.  ``attention_lse_ref`` is the
forward kernels' second output, the per-row log-sum-exp in base 2.
``attention_bwd_ref`` is the backward written out (no autograd): what
the JAX package gets from ``jax.value_and_grad`` through its XLA
attention.  They are what the wrappers run on CPU tensors and what
``chip_smoke.py`` and the card tests hold the kernels against.
"""

from __future__ import annotations

import torch

__all__ = ["attention_ref", "attention_lse_ref", "attention_bwd_ref",
           "LOG2E"]

LOG2E = 1.4426950408889634


def _scores(q, k, causal, scale):
    """(B,S,H,hd), (B,T,K,hd) -> masked scale * q.k^T, (B,K,G,S,T) f32."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * scale
    if causal:
        mask = (torch.arange(T, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None])
        scores = scores.masked_fill(~mask, float("-inf"))
    return scores


def attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """q: (B,S,H,hd) k/v: (B,T,K,hd), H % K == 0 -> (B,S,H,hd) float32.

    f32 or bf16 inputs; the arithmetic is float32 either way."""
    B, S, H, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    w = torch.softmax(_scores(q, k, causal, scale), dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return out.reshape(B, S, H, hd)


def attention_lse_ref(q, k, *, causal: bool = True, scale=None):
    """The forward kernels' ``lse``: log2 of sum_t 2^(scale log2(e)
    q.k_t) per row, (B,H,S) float32 — the natural log-sum-exp of the
    scaled scores times log2(e)."""
    B, S, H, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    lse = torch.logsumexp(_scores(q, k, causal, scale), dim=-1) * LOG2E
    return lse.reshape(B, H, S)


def attention_bwd_ref(q, k, v, o, do, *, causal: bool = True, scale=None):
    """The gradients of ``attention_ref``'s output ``o`` (B,S,H,hd) under
    an output gradient ``do`` (B,S,H,hd), from the explicit formulas in
    float32:

        P = softmax(scale q.k^T)          dV = sum_g P^T dO
        dP = dO v^T     D = rowsum(dO o)  dS = P (dP - D)
        dQ = scale dS k                   dK = scale sum_g dS^T q

    (the sums over the G query heads that share a kv head) -> (dq
    (B,S,H,hd), dk (B,T,K,hd), dv (B,T,K,hd)), float32."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else hd ** -0.5
    p = torch.softmax(_scores(q, k, causal, scale), dim=-1)    # (B,K,G,S,T)
    dog = do.reshape(B, S, K, G, hd).float()
    og = o.reshape(B, S, K, G, hd).float()
    qg = q.reshape(B, S, K, G, hd).float()
    kf, vf = k.float(), v.float()
    dv = torch.einsum("bkgst,bskgh->btkh", p, dog)
    dp = torch.einsum("bskgh,btkh->bkgst", dog, vf)
    delta = torch.einsum("bskgh,bskgh->bkgs", dog, og)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bkgst,btkh->bskgh", ds, kf) * scale
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qg) * scale
    return dq.reshape(B, S, H, hd), dk, dv

