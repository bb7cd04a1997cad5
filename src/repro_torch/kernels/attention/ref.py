"""Plain PyTorch versions of the flash-attention kernels (GQA forward
and backward).

``attention_ref`` is the JAX package's ``kernels/attention/ref.py::
attention_ref`` grown by the two score transforms the JAX package's XLA
attention applies (``src/repro/models/attention.py``): the full (S, T)
score matrix in float32, scaled, then an attention-logit softcap
(``softcap tanh(s / softcap)``, ``models/layers.py::softcap``), then a
causal mask aligned at the first position, then a sliding window (keys
``t > q - window`` kept), softmax, then the weighted sum of v.
``attention_lse_ref`` is the forward kernels' second output, the
per-row log-sum-exp in base 2 of the capped scores.
``attention_bwd_ref`` is the backward written out (no autograd): what
the JAX package gets from ``jax.value_and_grad`` through its XLA
attention.  They are what the wrappers run on CPU tensors and what
``chip_smoke.py`` and the card tests hold the kernels against.
``softcap`` None or 0 and ``window`` 0 mean none.  Masked scores are
the reference's finite ``NEG_INF``, so a row that a window leaves with
no key (S >= T + window) gets a uniform softmax, the mean of v, as the
JAX package's attention gives it (the kernels refuse such calls).
"""

from __future__ import annotations

import torch

__all__ = ["attention_ref", "attention_ref_blocked", "attention_lse_ref",
           "attention_bwd_ref", "LOG2E"]

LOG2E = 1.4426950408889634
NEG_INF = -2.0e38    # src/repro/models/attention.py's masked score


def _raw_scores(q, k, scale):
    """(B,S,H,hd), (B,T,K,hd) -> scale * q.k^T, (B,K,G,S,T) float32."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd).float()
    return torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * scale


def _keep(scores, causal, window):
    """(S, T) True where a key is kept: at or before the query (causal)
    and after ``q - window`` (window > 0); None when every key is."""
    S, T = scores.shape[-2:]
    t = torch.arange(T, device=scores.device)[None, :]
    s = torch.arange(S, device=scores.device)[:, None]
    keep = t <= s if causal else None
    if window:
        keep = (t > s - window) if keep is None else keep & (t > s - window)
    return keep


def _mask(scores, keep):
    return scores if keep is None else scores.masked_fill(~keep, NEG_INF)


def _scores(q, k, causal, scale, softcap=None, window=0):
    """Capped and masked scores, (B,K,G,S,T) float32."""
    scores = _raw_scores(q, k, scale)
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    return _mask(scores, _keep(scores, causal, window))


def attention_ref(q, k, v, *, causal: bool = True, scale=None,
                  softcap=None, window: int = 0):
    """q: (B,S,H,hd) k/v: (B,T,K,hd), H % K == 0 -> (B,S,H,hd) float32.

    f32 or bf16 inputs; the arithmetic is float32 either way."""
    B, S, H, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    w = torch.softmax(_scores(q, k, causal, scale, softcap, window), dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return out.reshape(B, S, H, hd)


def attention_ref_blocked(q, k, v, *, causal: bool = True, scale=None,
                          softcap=None, window: int = 0, block: int = 1024):
    """``attention_ref`` as an online softmax over blocks of ``block``
    keys (halved until it divides T), so that the (S, T) scores never
    materialise: the JAX package's ``_chunked_attention``, which its
    attention runs at S T >= 16384^2, in its order (a running max, the
    block's exponentials, the rescaled sums), float32."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    block = min(block, T)
    while T % block:
        block //= 2
    qg = q.reshape(B, S, K, H // K, hd).float()
    acc = qg.new_zeros((B, K, H // K, S, hd))
    m = qg.new_full((B, K, H // K, S), NEG_INF)
    den = qg.new_zeros((B, K, H // K, S))
    s_idx = torch.arange(S, device=q.device)[:, None]
    for j in range(0, T, block):
        kj, vj = k[:, j:j + block].float(), v[:, j:j + block].float()
        s = torch.einsum("bskgh,btkh->bkgst", qg, kj) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        t = j + torch.arange(block, device=q.device)[None, :]
        keep = t <= s_idx if causal else None
        if window:
            keep = (t > s_idx - window) if keep is None else (
                keep & (t > s_idx - window))
        s = _mask(s, keep)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        den = den * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgst,btkh->bkgsh", p,
                                                    vj)
        m = m_new
    out = acc / torch.clamp(den, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


def attention_lse_ref(q, k, *, causal: bool = True, scale=None,
                      softcap=None, window: int = 0):
    """The forward kernels' ``lse``: log2 of sum_t 2^(log2(e) s_t) per
    row over the unmasked scores s (scaled, then capped), (B,H,S)
    float32 — the natural log-sum-exp of the scores times log2(e)."""
    B, S, H, hd = q.shape
    scale = scale if scale is not None else hd ** -0.5
    lse = torch.logsumexp(_scores(q, k, causal, scale, softcap, window),
                          dim=-1) * LOG2E
    return lse.reshape(B, H, S)


def attention_bwd_ref(q, k, v, o, do, *, causal: bool = True, scale=None,
                      softcap=None, window: int = 0):
    """The gradients of ``attention_ref``'s output ``o`` (B,S,H,hd) under
    an output gradient ``do`` (B,S,H,hd), from the explicit formulas in
    float32:

        P = softmax(s'), s' = scale q.k^T, capped and masked
        dV = sum_g P^T dO
        dP = dO v^T     D = rowsum(dO o)  dS = P (dP - D) c
        dQ = scale dS k                   dK = scale sum_g dS^T q

    (the sums over the G query heads that share a kv head), where c = 1
    without a softcap and 1 - tanh^2(scale q.k^T / softcap) with one ->
    (dq (B,S,H,hd), dk (B,T,K,hd), dv (B,T,K,hd)), float32."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else hd ** -0.5
    scores = _raw_scores(q, k, scale)                           # (B,K,G,S,T)
    if softcap:
        tanh = torch.tanh(scores / softcap)
        scores = softcap * tanh
    keep = _keep(scores, causal, window)
    p = torch.softmax(_mask(scores, keep), dim=-1)
    dog = do.reshape(B, S, K, G, hd).float()
    og = o.reshape(B, S, K, G, hd).float()
    qg = q.reshape(B, S, K, G, hd).float()
    kf, vf = k.float(), v.float()
    dv = torch.einsum("bkgst,bskgh->btkh", p, dog)
    dp = torch.einsum("bskgh,btkh->bkgst", dog, vf)
    delta = torch.einsum("bskgh,bskgh->bkgs", dog, og)
    ds = p * (dp - delta[..., None])
    if softcap:
        ds = ds * (1.0 - tanh * tanh)
    if keep is not None:      # a masked score has no gradient, also in
        ds = ds.masked_fill(~keep, 0.0)    # a keyless row's uniform P
    dq = torch.einsum("bkgst,btkh->bskgh", ds, kf) * scale
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qg) * scale
    return dq.reshape(B, S, H, hd), dk, dv
