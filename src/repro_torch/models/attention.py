"""GQA attention with a KV cache, self- and cross-attention, sliding-window
masks and attention-logit softcaps.

Head layout is explicit, as in the JAX package — q: (B, S, H, hd); k/v:
(B, T, K, hd) with G = H // K query heads per KV head.

* **Prefill** (no cache) runs the flash-attention op
  (``kernels.attention``) at every length: on the card the hand-written
  Hopper kernel, on the CPU its plain version.  Its float32 result is
  cast to the compute dtype before ``wo``.  (The JAX package runs its
  own plain softmax below 16384² score entries and a scanned online
  softmax above; both compute the kernel's function.)  Cross-attention
  (``kv_x``: k and v projected from the encoder states, no RoPE on k)
  goes through the same op, non-causal, with S != T.
* **Decode** over the cache, and attention over a static (cross)
  cache, is the plain masked softmax, as the JAX package leaves it to
  XLA: scores are the products of the compute dtype summed in float32
  (the reference's ``preferred_element_type``): the cache is regrouped
  in its own dtype, never copied to float32.

The softcap (``cfg.attn_logit_softcap``: scores ``cap tanh(s / cap)``)
and the sliding window (``cfg.sliding_window`` on a layer whose
``is_local`` is true: keys ``t > q - window`` kept; ``is_local`` None
means no window) follow the JAX package: scaled scores, then the cap,
then the causal mask, then the window.  Prefill passes both to the
flash op; decode and the static cache apply them to the float32 scores.

Rotary positions: RoPE over (B, S) positions (given (3, B, S) streams
it takes the first, as the JAX package does), or M-RoPE (vlm) over the
(3, B, S) (t, h, w) streams, each rotating its own section of the
frequency slots.  Both rotate q, and k when it comes from ``x``, before
the flash op, which sees ordinary q and k; a decode writes the cache at
the (B,) ``pos_offset`` whichever the rotation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.models.layers import _mm, mrope_apply, rope_apply, softcap

__all__ = ["attn_param_defs", "attention", "KVCache", "init_cache_spec"]

NEG_INF = -2.0e38


def attn_param_defs(mk, prefix: str, cfg: ArchConfig, *, layers: int = 0):
    """Attention parameter tree; optionally stacked over a leading layer
    axis (layers > 0)."""
    L = (layers,) if layers else ()
    lax_ = ("layers",) if layers else ()
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": mk(f"{prefix}.wq", L + (d, h, hd), lax_ + ("d_model", "heads",
                                                         "head_dim"), d),
        "wk": mk(f"{prefix}.wk", L + (d, k, hd), lax_ + ("d_model",
                                                         "kv_heads",
                                                         "head_dim"), d),
        "wv": mk(f"{prefix}.wv", L + (d, k, hd), lax_ + ("d_model",
                                                         "kv_heads",
                                                         "head_dim"), d),
        "wo": mk(f"{prefix}.wo", L + (h, hd, d), lax_ + ("heads", "head_dim",
                                                         "d_model"),
                 h * hd),
    }


class KVCache(NamedTuple):
    """Decode-time cache spec for one attention stack: each leaf is
    (shape, dtype), the JAX package's ``ShapeDtypeStruct`` as the ssm
    cache spec writes it.  k/v: (L, B, S_max, K, hd)."""
    k: tuple
    v: tuple


def init_cache_spec(cfg: ArchConfig, batch: int, max_seq: int,
                    dtype=torch.bfloat16, *, layers: Optional[int] = None,
                    kv_heads: Optional[int] = None) -> KVCache:
    L = layers if layers is not None else cfg.n_layers
    K = kv_heads if kv_heads is not None else cfg.n_kv_heads
    shape = (L, batch, max_seq, K, cfg.head_dim)
    return KVCache(k=(shape, dtype), v=(shape, dtype))


def _window(cfg: ArchConfig, is_local) -> int:
    """The layer's sliding window, 0 for none: the config's window where
    ``is_local`` is given and true (a bool or a 0-d bool tensor)."""
    if not cfg.sliding_window or is_local is None or not bool(is_local):
        return 0
    return cfg.sliding_window


def _update_cache(ck, cv, k_new, v_new, pos):
    """Write (B, S_new, K, hd) into ck/cv (B, S_max, K, hd) in place at
    per-batch offsets ``pos`` (B,).

    The offset is clamped to [0, S_max - S_new], as
    ``jax.lax.dynamic_update_slice`` clamps it: a row decoded past the
    end of the cache overwrites its last S_new positions.  (The JAX
    package returns updated copies; the port updates in place, which is
    what its donated buffers amount to.)"""
    B, S_max = ck.shape[0], ck.shape[1]
    S_new = k_new.shape[1]
    start = pos.to(torch.long).clamp(0, S_max - S_new)
    rows = torch.arange(B, device=ck.device)[:, None]
    cols = start[:, None] + torch.arange(S_new, device=ck.device)[None, :]
    ck[rows, cols] = k_new.to(ck.dtype)
    cv[rows, cols] = v_new.to(cv.dtype)
    return ck, cv


def _f32_scores(qg, k):
    """qg (B,S,K,G,hd), k (B,T,K,hd) in one dtype -> q.k^T (B,K,G,S,T)
    float32: the products of that dtype summed in float32.  On the card
    a bf16 k goes into ``bmm`` with a float32 output (products of bf16
    are exact in float32): its (B*K, T, hd) layout is a bf16 copy of the
    cache when T > 1, never a float32 one."""
    B, S, K, G, hd = qg.shape
    T = k.shape[1]
    if qg.dtype == torch.float32 or qg.device.type != "cuda":
        return torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float())
    a = qg.permute(0, 2, 3, 1, 4).reshape(B * K, G * S, hd)
    b = k.permute(0, 2, 1, 3).reshape(B * K, T, hd)
    return torch.bmm(a, b.transpose(1, 2),
                     out_dtype=torch.float32).reshape(B, K, G, S, T)


def attention(p, x, positions, cfg: ArchConfig, *,
              is_local=None, cache_k=None, cache_v=None, pos_offset=None,
              kv_x=None, causal: bool = True, compute_dtype=torch.bfloat16,
              return_kv: bool = False, chunked_threshold: int = 16_384,
              impl: str = "kernel"):
    """GQA attention, as the JAX package's:

    * prefill: cache_* None; k/v from x, or from ``kv_x`` (B, T, D) for
      cross-attention; through the flash op (``impl`` selects the kernel
      or the plain version, see ``kernels.attention.ops``), causal
      unless ``causal=False`` or ``kv_x`` is given; with ``return_kv``
      the fresh k/v are returned as the cache;
    * decode:  cache_k/v (B, S_max, K, hd) written in place at
      pos_offset (B,), then the plain masked softmax over the cache;
    * a static cache (cross-attention decode): cache_k/v given with
      ``pos_offset`` None are the keys and values as they are; the
      plain softmax over them, causal only if ``causal`` and no
      ``kv_x``; the cache is returned unchanged.

    positions: (B, S) int, or (3, B, S) under M-RoPE (the (t, h, w)
    streams; RoPE takes the first).  Returns (out, (new_cache_k,
    new_cache_v)).

    ``is_local`` selects the config's sliding window for this layer
    (None or false: none); ``cfg.attn_logit_softcap`` caps the scores.
    ``chunked_threshold`` is where the JAX package switches to its
    scanned online softmax; the port's prefill is the blocked flash op
    at every length, which computes the same function, so it changes
    nothing here.
    """
    del chunked_threshold
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // K
    scale = cfg.qk_scale if cfg.qk_scale else hd ** -0.5
    window = _window(cfg, is_local)
    static = cache_k is not None and pos_offset is None

    def rotate(t):
        if cfg.rope_mode == "rope":
            pos = positions if positions.ndim == 2 else positions[0]
            return rope_apply(t, pos, cfg.rope_theta)
        if cfg.rope_mode == "mrope":
            return mrope_apply(t, positions, cfg.rope_theta)
        return t

    q = rotate(_mm(x, p["wq"], compute_dtype))
    if not static:            # a static cache holds k and v already
        src = x if kv_x is None else kv_x
        k = _mm(src, p["wk"], compute_dtype)
        v = _mm(src, p["wv"], compute_dtype)
        if kv_x is None:
            k = rotate(k)
    wo = p["wo"].reshape(H * hd, D)

    if cache_k is None:
        out = attn_ops.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            causal=causal and kv_x is None, scale=scale,
            softcap=cfg.attn_logit_softcap, window=window, impl=impl)
        out = _mm(out.to(compute_dtype).reshape(B, S, H * hd), wo,
                  compute_dtype)
        return out, ((k, v) if return_kv else (None, None))

    if not static:
        cache_k, cache_v = _update_cache(cache_k, cache_v, k, v,
                                         pos_offset)
    ck, cv = cache_k.to(compute_dtype), cache_v.to(compute_dtype)
    T = ck.shape[1]
    scores = softcap(_f32_scores(q.reshape(B, S, K, G, hd), ck) * scale,
                     cfg.attn_logit_softcap)
    t_idx = torch.arange(T, device=x.device)
    q_abs = torch.arange(S, device=x.device)[None, :]             # (1, S)
    mask = None
    if pos_offset is not None:
        q_abs = pos_offset.to(torch.long)[:, None] + q_abs         # (B, S)
        mask = t_idx[None, None, :] <= q_abs[..., None]          # (B, S, T)
    elif causal and kv_x is None:
        mask = t_idx[None, None, :] <= q_abs[..., None]
    if window:
        local = t_idx[None, None, :] > q_abs[..., None] - window
        mask = local if mask is None else mask & local
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(compute_dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, cv)
    return (_mm(out.reshape(B, S, H * hd), wo, compute_dtype),
            (cache_k, cache_v))
