"""Decoder-only LM assembly, dense family.

Layers are stacked on a leading 'layers' axis, as in the JAX package, so
the parameter trees carry across unchanged; the JAX package's
``lax.scan`` over that axis is a Python loop here.  The KV cache rides
the same loop, one layer slice at a time.

Ported: the dense family.  Not yet: MoE blocks, the SSM and hybrid
stacks, the vlm and encoder-decoder families (ROADMAP.md, Queue 1
item 9), and training with ``lm_loss`` (Queue 1 item 10).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as ll
from repro_torch.models.attention import attention, attn_param_defs

__all__ = ["lm_param_defs", "lm_forward", "norm_def", "apply_norm",
           "mlp_param_defs", "check_family"]


def check_family(cfg: ArchConfig) -> None:
    """Raise for model families the port does not run yet."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            "(ROADMAP.md, Queue 1 item 9)")
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE blocks are not ported yet (ROADMAP.md, "
            "Queue 1 item 9)")
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} stack waits for the SSD kernel "
            "(ROADMAP.md, Queue 1 item 9 and Queue 2 item 4)")
    if cfg.family == "vlm":
        raise NotImplementedError(
            f"{cfg.name}: M-RoPE and embedding inputs are not ported yet "
            "(ROADMAP.md, Queue 1 item 9)")
    if cfg.family != "dense":
        raise ValueError(cfg.family)


def norm_def(mk, name: str, cfg: ArchConfig, *, layers: int = 0):
    L = (layers,) if layers else ()
    lax_ = ("layers",) if layers else ()
    d = {"w": mk(f"{name}.w", L + (cfg.d_model,), lax_ + ("d_model",),
                 kind="zeros" if cfg.norm == "rmsnorm" else "ones")}
    if cfg.norm == "layernorm":
        d["b"] = mk(f"{name}.b", L + (cfg.d_model,), lax_ + ("d_model",),
                    kind="zeros")
    return d


def apply_norm(x, p, cfg: ArchConfig):
    if cfg.norm == "rmsnorm":
        return ll.rmsnorm(x, p["w"])
    return ll.layernorm(x, p["w"], p["b"])


def mlp_param_defs(mk, prefix: str, cfg: ArchConfig, *, layers: int = 0):
    L = (layers,) if layers else ()
    lax_ = ("layers",) if layers else ()
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_act in ("swiglu", "geglu"):
        return {
            "w_gate": mk(f"{prefix}.w_gate", L + (d, f),
                         lax_ + ("d_model", "d_ff"), d),
            "w_up": mk(f"{prefix}.w_up", L + (d, f),
                       lax_ + ("d_model", "d_ff"), d),
            "w_down": mk(f"{prefix}.w_down", L + (f, d),
                         lax_ + ("d_ff", "d_model"), f),
        }
    return {
        "w_up": mk(f"{prefix}.w_up", L + (d, f), lax_ + ("d_model", "d_ff"),
                   d),
        "w_down": mk(f"{prefix}.w_down", L + (f, d),
                     lax_ + ("d_ff", "d_model"), f),
    }


def _attn_mlp_block_defs(mk, prefix: str, cfg: ArchConfig, *,
                         layers: int = 0):
    p = {
        "ln1": norm_def(mk, f"{prefix}.ln1", cfg, layers=layers),
        "attn": attn_param_defs(mk, f"{prefix}.attn", cfg, layers=layers),
        "ln2": norm_def(mk, f"{prefix}.ln2", cfg, layers=layers),
    }
    if cfg.post_block_norm:
        p["ln1_post"] = norm_def(mk, f"{prefix}.ln1_post", cfg,
                                 layers=layers)
        p["ln2_post"] = norm_def(mk, f"{prefix}.ln2_post", cfg,
                                 layers=layers)
    p["mlp"] = mlp_param_defs(mk, f"{prefix}.mlp", cfg, layers=layers)
    return p


def lm_param_defs(cfg: ArchConfig, mk):
    check_family(cfg)
    V, D = cfg.padded_vocab, cfg.d_model
    p: dict[str, Any] = {
        "embed": mk("embed", (V, D), ("vocab", "d_model"), D),
        "final_norm": norm_def(mk, "final_norm", cfg),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = mk("unembed", (D, V), ("d_model", "vocab"), D)
    p["blocks"] = _attn_mlp_block_defs(mk, "blocks", cfg,
                                       layers=cfg.n_layers)
    return p


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------

def _attn_mlp_layer(cfg: ArchConfig, x, bp, positions, cache_k, cache_v,
                    pos_offset, want_cache, compute_dtype, attn_impl):
    h = apply_norm(x, bp["ln1"], cfg)
    a_out, new_kv = attention(
        bp["attn"], h, positions, cfg, cache_k=cache_k, cache_v=cache_v,
        pos_offset=pos_offset, compute_dtype=compute_dtype,
        return_kv=want_cache, impl=attn_impl)
    if cfg.post_block_norm:
        a_out = apply_norm(a_out, bp["ln1_post"], cfg)
    x = x + a_out
    h = apply_norm(x, bp["ln2"], cfg)
    if cfg.mlp_act in ("swiglu", "geglu"):
        m_out = ll.glu_mlp(h, bp["mlp"], cfg.mlp_act, compute_dtype)
    else:
        m_out = ll.gelu_mlp(h, bp["mlp"], compute_dtype)
    if cfg.post_block_norm:
        m_out = apply_norm(m_out, bp["ln2_post"], cfg)
    return x + m_out, new_kv


def _layer_slice(tree, i: int):
    return {k: (_layer_slice(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _run_attn_stack(params, cfg, x, positions, cache, pos_offset, mode,
                    compute_dtype, attn_impl):
    """The layers in order (the JAX package scans them).  Prefill stacks
    the fresh k/v of every layer into the cache; decode writes each
    layer's slice of ``cache`` in place."""
    want_cache = mode in ("prefill", "decode")
    ks, vs = [], []
    for i in range(cfg.n_layers):
        bp = _layer_slice(params["blocks"], i)
        ck = cv = None
        if cache is not None:
            ck, cv = cache["k"][i], cache["v"][i]
        x, (k_i, v_i) = _attn_mlp_layer(
            cfg, x, bp, positions, ck, cv, pos_offset, want_cache,
            compute_dtype, attn_impl)
        if want_cache and cache is None:
            ks.append(k_i)
            vs.append(v_i)
    if not want_cache:
        return x, None
    if cache is not None:
        return x, cache
    return x, {"k": torch.stack(ks), "v": torch.stack(vs)}


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------

def _positions_for(B: int, S: int, pos_offset, device):
    ar = torch.arange(S, dtype=torch.int32, device=device)[None]
    if pos_offset is None:
        return ar.expand(B, S)
    return pos_offset.to(torch.int32)[:, None] + ar


def lm_forward(params, cfg: ArchConfig, *, tokens=None, embeds=None,
               cache=None, pos_offset=None, mode: str = "train",
               compute_dtype=torch.bfloat16, logits_mode: str = "full",
               attn_impl: str = "kernel"):
    """Run the LM.  Returns (logits, new_cache, aux_loss); aux_loss is
    the MoE router loss, zero for the dense family.

    logits_mode: 'full' (B,S,V) | 'last' (B,1,V) | 'none' (hidden only).
    mode: 'prefill' (returns the fresh cache), 'decode' (writes ``cache``
    in place at ``pos_offset``) or 'train' (no cache; a forward pass —
    the training step itself is not ported yet).  ``attn_impl`` selects
    the prefill attention (``kernels.attention.ops``).
    """
    check_family(cfg)
    if embeds is not None:
        x = embeds.to(compute_dtype)
    else:
        x = ll.take_embedding(params["embed"], tokens, cfg.embed_scale,
                              compute_dtype)
    B, S = x.shape[:2]
    positions = _positions_for(B, S, pos_offset, x.device)
    x, new_cache = _run_attn_stack(params, cfg, x, positions, cache,
                                   pos_offset, mode, compute_dtype,
                                   attn_impl)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = apply_norm(x, params["final_norm"], cfg)
    if logits_mode == "none":
        return x, new_cache, aux
    if logits_mode == "last":
        x = x[:, -1:]
    unembed = (params["embed"].T if cfg.tie_embeddings
               else params["unembed"])
    logits = ll._mm(x, unembed, compute_dtype)
    logits = ll.softcap(logits.float(), cfg.final_logit_softcap)
    return logits, new_cache, aux
