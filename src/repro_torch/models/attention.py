"""GQA attention with a KV cache.

Head layout is explicit, as in the JAX package — q: (B, S, H, hd); k/v:
(B, T, K, hd) with G = H // K query heads per KV head.

* **Prefill** (no cache) runs the flash-attention op
  (``kernels.attention``) at every length: on the card the hand-written
  Hopper kernel, on the CPU its plain version.  Its float32 result is
  cast to the compute dtype before ``wo``.  (The JAX package runs its
  own plain softmax below 16384² score entries and a scanned online
  softmax above; both compute the kernel's function.)
* **Decode** over the cache is the plain masked softmax, as the JAX
  package leaves it to XLA.

Self-attention only, with RoPE: cross-attention (enc-dec), M-RoPE (vlm),
sliding windows and attention-logit softcaps are not ported yet — the
flash kernel has neither of the last two (ROADMAP.md, Queue 1 item 4).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.models.layers import _mm, rope_apply

__all__ = ["attn_param_defs", "attention", "KVCache", "init_cache_spec",
           "check_supported"]

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
    """Decode-time cache shape for one attention stack.
    k/v: (L, B, S_max, K, hd)."""
    k: tuple
    v: tuple


def init_cache_spec(cfg: ArchConfig, batch: int, max_seq: int, *,
                    layers: Optional[int] = None,
                    kv_heads: Optional[int] = None) -> KVCache:
    L = layers if layers is not None else cfg.n_layers
    K = kv_heads if kv_heads is not None else cfg.n_kv_heads
    shape = (L, batch, max_seq, K, cfg.head_dim)
    return KVCache(k=shape, v=shape)


def check_supported(cfg: ArchConfig) -> None:
    """Raise for attention features the port does not have yet."""
    if cfg.attn_logit_softcap or cfg.sliding_window:
        raise NotImplementedError(
            f"{cfg.name}: attention-logit softcaps and sliding windows are "
            "not ported yet (ROADMAP.md, Queue 1 item 4); the flash kernel "
            "has neither")


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


def attention(p, x, positions, cfg: ArchConfig, *, cache_k=None,
              cache_v=None, pos_offset=None, compute_dtype=torch.bfloat16,
              return_kv: bool = False, impl: str = "kernel"):
    """Causal GQA self-attention:

    * prefill: cache_* None; causal attention over x through the flash
      op (``impl`` selects the kernel or the plain version, see
      ``kernels.attention.ops``); with ``return_kv`` the fresh k/v are
      returned as the cache;
    * decode:  cache_k/v (B, S_max, K, hd) written in place at
      pos_offset (B,), then the plain masked softmax over the cache.

    positions: (B, S) int.  Returns (out, (new_cache_k, new_cache_v)).
    """
    check_supported(cfg)
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // K
    scale = cfg.qk_scale if cfg.qk_scale else hd ** -0.5

    q = _mm(x, p["wq"], compute_dtype)
    k = _mm(x, p["wk"], compute_dtype)
    v = _mm(x, p["wv"], compute_dtype)
    if cfg.rope_mode == "rope":
        q = rope_apply(q, positions, cfg.rope_theta)
        k = rope_apply(k, positions, cfg.rope_theta)
    wo = p["wo"].reshape(H * hd, D)

    if cache_k is None:
        out = attn_ops.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
            scale=scale, impl=impl)
        out = _mm(out.to(compute_dtype).reshape(B, S, H * hd), wo,
                  compute_dtype)
        return out, ((k, v) if return_kv else (None, None))

    cache_k, cache_v = _update_cache(cache_k, cache_v, k, v, pos_offset)
    T = cache_k.shape[1]
    qg = q.reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                          cache_k.float()) * scale
    q_abs = (pos_offset.to(torch.long)[:, None]
             + torch.arange(S, device=x.device)[None, :])      # (B, S)
    mask = (torch.arange(T, device=x.device)[None, None, :]
            <= q_abs[..., None])                                # (B, S, T)
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(compute_dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, cache_v.to(compute_dtype))
    return (_mm(out.reshape(B, S, H * hd), wo, compute_dtype),
            (cache_k, cache_v))
