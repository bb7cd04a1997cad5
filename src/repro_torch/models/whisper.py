"""Whisper-style encoder-decoder backbone, as the JAX package's.

The audio front end (log-mel + conv stem) is a stub, as in the JAX
package: the inputs are precomputed frame embeddings (B, enc_seq, D).
Encoder: learned positions, a non-causal self-attention stack.
Decoder: learned positions, causal self-attention, then cross-attention
to the encoder states, then a GELU MLP, and a tied unembedding.  The
attention goes through ``models.attention``: the flash op in the
encoder and in the decoder's prefill (cross-attention with S != T), the
plain softmax over the caches in decode.

The JAX package's ``lax.scan`` over the stacked layers is a Python loop
over each layer's slice, as in ``models.transformer``.  The decoder
cache is the reference's ``{"k", "v"}`` (self-attention, written in
place at ``pos_offset``) and ``{"ck", "cv"}`` (the encoder's keys and
values, static in decode), each (L, B, T, K, hd).  The encoder's input,
the decoder's embedded input and the logits are annotated with
``dist.api.constrain`` at the JAX package's places.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.api import constrain
from repro_torch.models import layers as ll
from repro_torch.models.attention import attention, attn_param_defs
from repro_torch.models.transformer import (_maybe_remat, _positions_for,
                                            _unstack, apply_norm,
                                            mlp_param_defs, norm_def)

__all__ = ["whisper_param_defs", "whisper_encode", "whisper_forward",
           "whisper_loss"]


def _enc_block_defs(mk, prefix: str, cfg: ArchConfig, *, layers: int):
    return {
        "ln1": norm_def(mk, f"{prefix}.ln1", cfg, layers=layers),
        "attn": attn_param_defs(mk, f"{prefix}.attn", cfg, layers=layers),
        "ln2": norm_def(mk, f"{prefix}.ln2", cfg, layers=layers),
        "mlp": mlp_param_defs(mk, f"{prefix}.mlp", cfg, layers=layers),
    }


def _dec_block_defs(mk, prefix: str, cfg: ArchConfig, *, layers: int):
    p = _enc_block_defs(mk, prefix, cfg, layers=layers)
    p["ln_x"] = norm_def(mk, f"{prefix}.ln_x", cfg, layers=layers)
    p["xattn"] = attn_param_defs(mk, f"{prefix}.xattn", cfg, layers=layers)
    return p


def whisper_param_defs(cfg: ArchConfig, mk):
    V, D = cfg.padded_vocab, cfg.d_model
    return {
        "embed": mk("embed", (V, D), ("vocab", "d_model"), D),
        "dec_pos": mk("dec_pos", (cfg.learned_positions, D),
                      ("seq", "d_model"), D),
        "enc_pos": mk("enc_pos", (cfg.encoder_seq, D),
                      ("enc_seq", "d_model"), D),
        "enc_blocks": _enc_block_defs(mk, "enc_blocks", cfg,
                                      layers=cfg.encoder_layers),
        "enc_norm": norm_def(mk, "enc_norm", cfg),
        "dec_blocks": _dec_block_defs(mk, "dec_blocks", cfg,
                                      layers=cfg.n_layers),
        "final_norm": norm_def(mk, "final_norm", cfg),
    }


def _enc_layer(cfg, x, bp, positions, compute_dtype, kernel_impl):
    h = apply_norm(x, bp["ln1"], cfg)
    a, _ = attention(bp["attn"], h, positions, cfg, causal=False,
                     compute_dtype=compute_dtype, impl=kernel_impl)
    x = x + a
    h = apply_norm(x, bp["ln2"], cfg)
    return x + ll.gelu_mlp(h, bp["mlp"], compute_dtype)


def whisper_encode(params, cfg: ArchConfig, frames,
                   compute_dtype=torch.bfloat16, remat_policy=None,
                   kernel_impl: str = "kernel"):
    """frames: (B, enc_seq, D) stub embeddings -> encoder states, each
    layer rematerialised in the backward as ``remat_policy`` says."""
    x = (frames.to(compute_dtype)
         + params["enc_pos"].to(compute_dtype)[None])
    x = constrain(x, ("batch", "enc_seq", "d_model"))
    B, S, _ = x.shape
    positions = _positions_for(cfg, B, S, None, x.device)
    layer = _maybe_remat(functools.partial(_enc_layer, cfg), remat_policy)
    for bp in _unstack(params["enc_blocks"], cfg.encoder_layers):
        x = layer(x, bp, positions, compute_dtype, kernel_impl)
    return apply_norm(x, params["enc_norm"], cfg)


def _dec_layer(cfg, x, bp, positions, enc_out, ck, cv, cxk, cxv,
               pos_offset, want_cache, compute_dtype, kernel_impl):
    h = apply_norm(x, bp["ln1"], cfg)
    a, new_kv = attention(bp["attn"], h, positions, cfg, cache_k=ck,
                          cache_v=cv, pos_offset=pos_offset,
                          compute_dtype=compute_dtype,
                          return_kv=want_cache, impl=kernel_impl)
    x = x + a
    h = apply_norm(x, bp["ln_x"], cfg)
    if cxk is not None:       # decode: the static cross cache
        a, new_xkv = attention(bp["xattn"], h, positions, cfg,
                               cache_k=cxk, cache_v=cxv, causal=False,
                               compute_dtype=compute_dtype,
                               impl=kernel_impl)
    else:
        a, new_xkv = attention(bp["xattn"], h, positions, cfg,
                               kv_x=enc_out, causal=False,
                               compute_dtype=compute_dtype,
                               return_kv=want_cache, impl=kernel_impl)
    x = x + a
    h = apply_norm(x, bp["ln2"], cfg)
    return x + ll.gelu_mlp(h, bp["mlp"], compute_dtype), new_kv, new_xkv


def whisper_forward(params, cfg: ArchConfig, *, tokens, enc_out=None,
                    cache=None, pos_offset=None, mode: str = "train",
                    compute_dtype=torch.bfloat16, remat_policy=None,
                    logits_mode: str = "full", kernel_impl: str = "kernel"):
    """Decoder.  train/prefill: ``enc_out`` required; decode: ``cache``
    carries the encoder's cross K/V ("ck", "cv") and its self-attention
    K/V are written in place at ``pos_offset``.  Returns (logits,
    new_cache); prefill stacks every layer's fresh K/V and cross K/V.

    The decoder's learned positions are gathered by absolute position;
    a position past ``cfg.learned_positions`` raises (an index error),
    where the JAX package's ``jnp.take`` fills NaN."""
    B, S = tokens.shape
    positions = _positions_for(cfg, B, S, pos_offset, tokens.device)
    x = ll.take_embedding(params["embed"], tokens, False, compute_dtype)
    x = x + params["dec_pos"][positions.long()].to(compute_dtype)
    x = constrain(x, ("batch", "seq", "d_model"))
    want_cache = mode in ("prefill", "decode")
    layer = _maybe_remat(functools.partial(_dec_layer, cfg),
                         remat_policy if mode == "train" else None)
    cache = cache or {}
    fresh = {n: [] for n in ("k", "v", "ck", "cv")}
    for i, bp in enumerate(_unstack(params["dec_blocks"], cfg.n_layers)):
        ck, cv, cxk, cxv = (cache[n][i] if n in cache else None
                            for n in ("k", "v", "ck", "cv"))
        x, (k_i, v_i), (xk_i, xv_i) = layer(
            x, bp, positions, enc_out, ck, cv, cxk, cxv, pos_offset,
            want_cache, compute_dtype, kernel_impl)
        for n, t in zip(("k", "v", "ck", "cv"), (k_i, v_i, xk_i, xv_i)):
            if want_cache and n not in cache:
                fresh[n].append(t)

    new_cache = None
    if want_cache:
        new_cache = {n: (cache[n] if n in cache else torch.stack(fresh[n]))
                     for n in ("k", "v", "ck", "cv")}

    x = apply_norm(x, params["final_norm"], cfg)
    if logits_mode == "last":
        x = x[:, -1:]
    logits = ll._mm(x, params["embed"].T, compute_dtype)
    logits = constrain(logits.float(), ("batch", "seq", "vocab"))
    return logits, new_cache


def whisper_loss(params, cfg: ArchConfig, batch, *,
                 compute_dtype=torch.bfloat16, remat_policy=None,
                 aux_weight: float = 0.0, kernel_impl: str = "kernel"):
    """Next-token cross entropy of the decoder on ``batch`` ({"frames",
    "tokens", "targets"}).  Returns (loss, {"ce", "aux"}); aux is zero
    (no router), and ``aux_weight`` is unused, as in the JAX package."""
    del aux_weight
    enc = whisper_encode(params, cfg, batch["frames"], compute_dtype,
                         remat_policy, kernel_impl)
    logits, _ = whisper_forward(
        params, cfg, tokens=batch["tokens"], enc_out=enc, mode="train",
        compute_dtype=compute_dtype, remat_policy=remat_policy,
        kernel_impl=kernel_impl)
    lse = ll.logsumexp_last(logits)
    tgt = ll.target_logits(logits, batch["targets"])
    # a site of the port's own: the batch stays sharded in the backward
    ce = torch.mean(constrain(lse - tgt, ("batch", "seq")))
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=ce.device)}
