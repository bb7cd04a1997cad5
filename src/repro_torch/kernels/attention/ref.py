"""Plain PyTorch version of the flash-attention kernel (GQA forward).

The same function as the JAX package's ``kernels/attention/ref.py::
attention_ref``: the full (S, T) score matrix in float32, a causal mask
aligned at the first position, softmax, then the weighted sum of v.  It
is what the wrapper runs on CPU tensors and what ``chip_smoke.py`` and
the card tests hold the kernel against.
"""

from __future__ import annotations

import torch

__all__ = ["attention_ref"]


def attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """q: (B,S,H,hd) k/v: (B,T,K,hd), H % K == 0 -> (B,S,H,hd) float32.

    f32 or bf16 inputs; the arithmetic is float32 either way."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else hd ** -0.5
    qg = q.reshape(B, S, K, G, hd).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * scale
    if causal:
        mask = (torch.arange(T, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None])
        scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return out.reshape(B, S, H, hd)
