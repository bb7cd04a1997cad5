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

Where the scores are formed (decode, the static cache), the grouped q
and the scores are annotated with ``dist.api.constrain`` at the JAX
package's places; the prefill hands q, k and v to the flash op, whose
sharding is its own (``kernels.attention.ops``).

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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.api import as_dtensor, constrain, on_shards
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
    if isinstance(ck, DTensor):
        return _update_sharded_cache(ck, cv, k_new, v_new, start)
    rows = torch.arange(B, device=ck.device)[:, None]
    cols = start[:, None] + torch.arange(S_new, device=ck.device)[None, :]
    ck[rows, cols] = k_new.to(ck.dtype)
    cv[rows, cols] = v_new.to(cv.dtype)
    return ck, cv


def _update_sharded_cache(ck, cv, k_new, v_new, start):
    """``_update_cache`` on DTensor caches, on each rank's shard: DTensor
    has no in-place index write into a dim it shards (the cache's
    sequence, in decode).  Each rank writes the new positions that fall
    in its slice of the sequence, for its rows and heads, and keeps its
    old values elsewhere."""
    mesh, pls = ck.device_mesh, ck.placements
    shape, off = compute_local_shape_and_global_offset(ck.shape, mesh, pls)
    new_pl = [Replicate() if p == Shard(1) else p for p in pls]
    row_pl = [p if p == Shard(0) else Replicate() for p in pls]
    start = as_dtensor(start, mesh).redistribute(mesh, row_pl).to_local()
    cols = (start[:, None] - off[1]
            + torch.arange(k_new.shape[1], device=start.device)[None, :])
    mine = (cols >= 0) & (cols < shape[1])
    cols = cols.clamp(0, shape[1] - 1)
    rows = torch.arange(cols.shape[0], device=cols.device)[:, None]
    for c, t in ((ck, k_new), (cv, v_new)):
        cl = c.to_local()
        tl = as_dtensor(t, mesh).redistribute(mesh, new_pl).to_local()
        cl[rows, cols] = torch.where(mine[..., None, None], tl.to(cl.dtype),
                                     cl[rows, cols])
    return ck, cv


def _out_proj(out, wo, compute_dtype):
    """out (B, S, H, hd) @ wo (H, hd, D) -> (B, S, D), the heads and the
    head dim contracted.  On DTensors it runs on each rank's shards
    (Megatron's row-parallel product): wo is gathered where ``out``
    shards the batch and cut where it shards the heads or the head dim,
    and the result is partial over the latter.  (Flattened, a sharded
    head dim is strided-sharded, which DTensor's product turns into a
    plain shard that the backward cannot unflatten.)"""
    B, S, H, hd = out.shape
    if not isinstance(out, DTensor):
        return _mm(out.reshape(B, S, H * hd), wo.reshape(H * hd, -1),
                   compute_dtype)
    mesh, pls = out.device_mesh, out.placements
    contracted = {Shard(2): Shard(0), Shard(3): Shard(1)}
    w_pl = [contracted.get(p, Replicate()) for p in pls]
    w_grad = [contracted[p] if p in contracted
              else Partial() if isinstance(p, Shard) else Replicate()
              for p in pls]
    wl = wo.redistribute(mesh, w_pl).to_local(grad_placements=w_grad)
    ol = out.to_local()
    y = _mm(ol.reshape(*ol.shape[:2], -1),
            wl.reshape(-1, wl.shape[-1]), compute_dtype)
    y_pl = [Partial() if p in contracted else p for p in pls]
    return DTensor.from_local(y, mesh, y_pl, run_check=False,
                              shape=(B, S, wo.shape[-1]),
                              stride=(S * wo.shape[-1], wo.shape[-1], 1))


def _group_heads(q, K: int):
    """q (B, S, H, hd) -> (B, S, K, G, hd).  A DTensor whose heads a mesh
    dim shards more finely than K divides is gathered on that dim first
    (DTensor cannot split such a dim in two)."""
    B, S, H, hd = q.shape
    if isinstance(q, DTensor):
        mesh = q.device_mesh
        pl = [Replicate() if p == Shard(2) and K % mesh.size(i) else p
              for i, p in enumerate(q.placements)]
        if tuple(pl) != tuple(q.placements):
            q = q.redistribute(mesh, pl)
    return q.reshape(B, S, K, H // K, hd)


def _einsum(eq: str, a, b, dtype=None):
    """``torch.einsum(eq, a, b)`` of the operands cast to ``dtype`` (if
    given); two DTensors' on each rank's shards.
    Per mesh dim the split letter is b's (else a's; b is the cache,
    which should not move): an operand that has it is split on it, the
    other taken whole, and the output is split on it, or holds a partial
    sum where the output lacks it.  DTensor's own
    einsum flattens the batch letters for ``bmm``, which PyTorch 2.11's
    DTensor refuses when an inner one (the kv heads) is split."""
    def cast(t):
        return t if dtype is None else t.to(dtype)
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)):
        return torch.einsum(eq, cast(a), cast(b))
    (la, lb), lo = eq.split("->")[0].split(","), eq.split("->")[1]
    pa, pb, po = [], [], []
    for qa, qb in zip(a.placements, b.placements):
        c = (lb[qb.dim] if qb.is_shard() else
             la[qa.dim] if qa.is_shard() else None)
        for letters, out in ((la, pa), (lb, pb)):
            out.append(Shard(letters.index(c)) if c and c in letters
                       else Replicate())
        po.append(Replicate() if c is None else
                  Shard(lo.index(c)) if c in lo else Partial())
    return on_shards(lambda u, v: torch.einsum(eq, cast(u), cast(v)), a, b,
                     ins=(pa, pb), outs=po)


def _f32_scores(qg, k):
    """qg (B,S,K,G,hd), k (B,T,K,hd) in one dtype -> q.k^T (B,K,G,S,T)
    float32: the products of that dtype summed in float32.  On the card
    a bf16 k goes into ``bmm`` with a float32 output (products of bf16
    are exact in float32): its (B*K, T, hd) layout is a bf16 copy of the
    cache when T > 1, never a float32 one."""
    B, S, K, G, hd = qg.shape
    T = k.shape[1]
    if qg.dtype == torch.float32 or qg.device.type != "cuda":
        return _einsum("bskgh,btkh->bkgst", qg, k, torch.float32)
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

    if cache_k is None:
        out = attn_ops.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(),
            causal=causal and kv_x is None, scale=scale,
            softcap=cfg.attn_logit_softcap, window=window, impl=impl)
        out = _out_proj(out.to(compute_dtype), p["wo"], compute_dtype)
        return out, ((k, v) if return_kv else (None, None))

    if not static:
        cache_k, cache_v = _update_cache(cache_k, cache_v, k, v,
                                         pos_offset)
    ck, cv = cache_k.to(compute_dtype), cache_v.to(compute_dtype)
    T = ck.shape[1]
    qg = constrain(_group_heads(q, K),
                   ("batch", "q_seq", "kv_heads", "q_per_kv", "head_dim"))
    scores = constrain(_f32_scores(qg, ck) * scale,
                       ("batch", "kv_heads", "q_per_kv", "q_seq", "kv_seq"))
    scores = softcap(scores, cfg.attn_logit_softcap)
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
    out = _einsum("bkgst,btkh->bskgh", w, cv)
    return (_out_proj(out.reshape(B, S, H, hd), p["wo"], compute_dtype),
            (cache_k, cache_v))
