"""Decoder-only LM assembly: the dense, MoE, SSM and hybrid families.

Layers are stacked on a leading 'layers' axis, as in the JAX package, so
the parameter trees carry across unchanged; the JAX package's
``lax.scan`` over that axis is a Python loop here.  The KV cache (dense)
or the conv and SSM states (ssm) ride the same loop, one layer slice at
a time.  The hybrid (zamba2) runs G groups of ``hybrid_group`` mamba
layers, each group followed by one application of a single shared
attention+MLP block, with one KV cache slice per group and the conv and
SSM states regrouped as (G, per, ...).  A sliding-window config marks
its layers local (every layer, or every other one from layer 0 with
``local_global_alternate``); the hybrid's shared block never is.

An MoE layer (``models.moe``) takes the MLP's place and adds its
router's load-balance loss to the stack's aux, which ``lm_loss`` adds at
``aux_weight`` (0.01).  Under a sharding context whose mesh has an
``expert`` axis it runs the expert-parallel ``moe_block_ep`` (decode
form when a ``pos_offset`` is given), as the JAX package does.

Sharding: the activations are annotated with ``dist.api.constrain`` at
the JAX package's places (the normed input of each layer, its output,
the embedded input and the logits), the identity with no context, and
at one place of the port's own: the residual stream after the
attention.  There the output projection leaves a partial sum over the
model axis, and DTensor reduces lazily: without the site the partial
sum reaches the second norm and the MLP, whose products DTensor then
runs on whole gathered weights rather than reduce the activations (its
placement search weighs communication only), 16 times the FLOPs on a
256-rank pod.

Training: ``lm_loss`` is the next-token cross entropy of ``lm_forward``
in mode "train", whose layers may be rematerialised in the backward
(``_maybe_remat``).  On the card the attention differentiates through
the hand-written backward kernel (``kernels.attention.ops``) and the
SSD through its own (``kernels.ssd.ops.SSDChunkFn``), so every LM family
trains there.  Where the float32 logits of a batch would pass
``LOSS_CHUNK_LOGITS`` elements (gemma2's 256 000-token vocabulary at
8192 rows: 8.4 GB a copy, ~55 GB with the softcap, the logsumexp and
their gradients), ``lm_loss`` runs the cross entropy over row chunks,
each chunk's logits rematerialised in the backward: the same arithmetic
a row, summed chunk by chunk.  Under a sharding context it keeps the
whole logits, which the vocab's shards already split.

The vlm family (qwen2-vl) is the dense stack fed precomputed patch
embeddings (``embeds``) or tokens, its q and k rotated by M-RoPE: the
positions are (3, B, S) streams (t, h, w), which ``_positions_for``
gives as the text positions broadcast (t = h = w), as the JAX package
does; a caller with a vision layout passes its own streams to
``attention``.

Ported: every family of the JAX package here, and the audio
encoder-decoder in ``models.whisper``.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.api import active_context, constrain
from repro_torch.models import layers as ll
from repro_torch.models.attention import attention, attn_param_defs
from repro_torch.models.moe import (moe_block, moe_block_ep,
                                    moe_param_defs, router_aux_loss)
from repro_torch.models.ssm import (mamba_block, mamba_decode_step,
                                    mamba_param_defs)

__all__ = ["lm_param_defs", "lm_forward", "lm_loss", "norm_def",
           "apply_norm", "mlp_param_defs", "check_family"]

# float32 logits (B x S x vocab elements) past which ``lm_loss`` runs the
# cross entropy in row chunks of a quarter of this each (1 GiB)
LOSS_CHUNK_LOGITS = 1 << 30


def check_family(cfg: ArchConfig) -> None:
    """Raise for a family the JAX package does not have."""
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid", "audio"):
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
    if cfg.is_moe:
        p["moe"] = moe_param_defs(mk, f"{prefix}.moe", cfg, layers=layers)
    else:
        p["mlp"] = mlp_param_defs(mk, f"{prefix}.mlp", cfg, layers=layers)
    return p


def _mamba_defs_with_ln(mk, prefix: str, cfg: ArchConfig, *, layers: int):
    p = mamba_param_defs(mk, prefix, cfg, layers=layers)
    p["ln"] = norm_def(mk, f"{prefix}.ln", cfg, layers=layers)
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
    if cfg.family == "ssm":
        p["blocks"] = _mamba_defs_with_ln(mk, "blocks", cfg,
                                          layers=cfg.n_layers)
    elif cfg.family == "hybrid":
        G, per = _hybrid_groups(cfg)
        p["mamba"] = _mamba_defs_with_ln(mk, "mamba", cfg, layers=G * per)
        p["shared"] = _attn_mlp_block_defs(mk, "shared", cfg, layers=0)
    else:
        p["blocks"] = _attn_mlp_block_defs(mk, "blocks", cfg,
                                           layers=cfg.n_layers)
    return p


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------

def _hybrid_groups(cfg: ArchConfig):
    """(G, per): G groups of ``per`` mamba layers, each followed by the
    shared block, n_layers = G (per + 1)."""
    per = cfg.hybrid_group
    G = cfg.n_layers // (per + 1)
    if G * (per + 1) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not groups "
                         f"of {per} mamba layers and the shared block")
    return G, per


def _is_local(cfg: ArchConfig, i: int) -> bool:
    """Layer i of an attention stack takes the sliding window: every
    other layer from layer 0 (``local_global_alternate``), every layer
    (a window alone), or none."""
    if cfg.local_global_alternate:
        return i % 2 == 0
    return bool(cfg.sliding_window)


def _attn_mlp_layer(cfg: ArchConfig, x, bp, positions, is_local, cache_k,
                    cache_v, pos_offset, want_cache, compute_dtype,
                    attn_impl):
    h = apply_norm(x, bp["ln1"], cfg)
    h = constrain(h, ("batch", "seq", "d_model"))
    a_out, new_kv = attention(
        bp["attn"], h, positions, cfg, is_local=is_local, cache_k=cache_k,
        cache_v=cache_v, pos_offset=pos_offset, compute_dtype=compute_dtype,
        return_kv=want_cache, impl=attn_impl)
    if cfg.post_block_norm:
        a_out = apply_norm(a_out, bp["ln1_post"], cfg)
    # a site of the port's own (see the module's note on sharding)
    x = constrain(x + a_out, ("batch", "seq", "d_model"))
    h = apply_norm(x, bp["ln2"], cfg)
    aux = None                 # the router loss of an MoE layer
    if "moe" in bp:
        ctx = active_context()
        if ctx is not None and "expert" in ctx.mesh.mesh_dim_names:
            m_out, probs = moe_block_ep(h, bp["moe"], cfg, ctx.mesh,
                                        compute_dtype=compute_dtype,
                                        decode=pos_offset is not None)
        else:
            m_out, probs = moe_block(h, bp["moe"], cfg,
                                     compute_dtype=compute_dtype)
        aux = router_aux_loss(probs)
    elif cfg.mlp_act in ("swiglu", "geglu"):
        m_out = ll.glu_mlp(h, bp["mlp"], cfg.mlp_act, compute_dtype)
    else:
        m_out = ll.gelu_mlp(h, bp["mlp"], compute_dtype)
    if cfg.post_block_norm:
        m_out = apply_norm(m_out, bp["ln2_post"], cfg)
    x = constrain(x + m_out, ("batch", "seq", "d_model"))
    return x, new_kv, aux


def _mamba_layer(cfg: ArchConfig, x, bp, conv_state, ssm_state, decode,
                 compute_dtype, ssd_impl):
    h = apply_norm(x, bp["ln"], cfg)
    if decode:
        out, states = mamba_decode_step(h, bp, cfg, conv_state, ssm_state,
                                        compute_dtype)
    else:
        out, states = mamba_block(h, bp, cfg, compute_dtype,
                                  conv_state=conv_state,
                                  ssm_state=ssm_state, ssd_impl=ssd_impl)
    # the JAX package scans these layers, and a scan's carry keeps one
    # sharding: pinned here, every layer takes its input as the first
    # does (see the module's note on sharding)
    return constrain(x + out, ("batch", "seq", "d_model")), states


# the operators whose outputs the "dots" policies keep for the backward:
# the matrix products (with and without batch dims) and the flash forward
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.repro_torch.flash_attention_fwd.default)
_BATCH_DOTS = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _save_policy(saved):
    def policy(ctx, op, *args, **kwargs):
        del ctx, args, kwargs
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def _maybe_remat(fn, policy: Optional[str]):
    """``fn`` as is (None), or recomputed in the backward: "full" keeps
    only its inputs (``jax.checkpoint``); "dots" also keeps the outputs of
    every matrix product and of the flash forward (``checkpoint_dots``),
    "dots_no_batch" those of the products without batch dims and of the
    flash forward (``checkpoint_dots_with_no_batch_dims``)."""
    if policy is None:
        return fn
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy in ("dots", "dots_no_batch"):
        saved = _DOTS + (_BATCH_DOTS if policy == "dots" else ())
        contexts = functools.partial(create_selective_checkpoint_contexts,
                                     _save_policy(saved))
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=contexts)
    raise ValueError(policy)


def _unstack(tree, n: int) -> list:
    """A tree of leaves stacked on a leading layer axis -> one tree per
    layer.  One ``unbind`` per leaf, so the backward stacks the layers'
    gradients once rather than adding n full-size scatters."""
    per = {k: (_unstack(v, n) if isinstance(v, dict) else v.unbind(0))
           for k, v in tree.items()}
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def _run_attn_stack(params, cfg, x, positions, cache, pos_offset, mode,
                    compute_dtype, attn_impl, remat_policy=None):
    """The layers in order (the JAX package scans them).  Prefill stacks
    the fresh k/v of every layer into the cache; decode writes each
    layer's slice of ``cache`` in place; train may rematerialise each
    layer in the backward (``_maybe_remat``).  Returns (x, cache, the
    sum of the MoE layers' router losses or None)."""
    want_cache = mode in ("prefill", "decode")
    layer = _maybe_remat(functools.partial(_attn_mlp_layer, cfg),
                         remat_policy if mode == "train" else None)
    ks, vs, aux = [], [], None
    for i, bp in enumerate(_unstack(params["blocks"], cfg.n_layers)):
        ck = cv = None
        if cache is not None:
            ck, cv = cache["k"][i], cache["v"][i]
        x, (k_i, v_i), aux_i = layer(x, bp, positions, _is_local(cfg, i), ck,
                                     cv, pos_offset, want_cache,
                                     compute_dtype, attn_impl)
        if aux_i is not None:
            aux = aux_i if aux is None else aux + aux_i
        if want_cache and cache is None:
            ks.append(k_i)
            vs.append(v_i)
    if not want_cache:
        return x, None, aux
    if cache is not None:
        return x, cache, aux
    return x, {"k": torch.stack(ks), "v": torch.stack(vs)}, aux


def _run_ssm_stack(params, cfg, x, cache, mode, compute_dtype, ssd_impl,
                   remat_policy=None):
    """The mamba layers in order.  Prefill stacks every layer's fresh
    conv and SSM states into the cache; decode reads each layer's slice
    of ``cache`` and writes the new states back in place.  A prefill
    given a cache continues from its states and returns new ones; train
    may rematerialise each layer in the backward."""
    decode = mode == "decode"
    layer = _maybe_remat(functools.partial(_mamba_layer, cfg),
                         remat_policy if mode == "train" else None)
    convs, ssms = [], []
    for i, bp in enumerate(_unstack(params["blocks"], cfg.n_layers)):
        conv_s = ssm_s = None
        if cache is not None:
            conv_s, ssm_s = cache["conv"][i], cache["ssm"][i]
        x, (conv_new, ssm_new) = layer(x, bp, conv_s, ssm_s, decode,
                                       compute_dtype, ssd_impl)
        if decode:
            cache["conv"][i] = conv_new
            cache["ssm"][i] = ssm_new
        else:
            convs.append(conv_new)
            ssms.append(ssm_new)
    if mode not in ("prefill", "decode"):
        return x, None
    if decode:
        return x, cache
    return x, {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}


def _hybrid_group(cfg, x, mps, shared, positions, conv_g, ssm_g, ck, cv,
                  pos_offset, mode, compute_dtype, kernel_impl):
    """One group of the hybrid: its mamba layers ``mps`` in order, then
    the shared block (no window).  Decode writes the group's conv and SSM
    states (``conv_g``, ``ssm_g``: (per, ...)) and its KV slice in place;
    otherwise the fresh states come back stacked (per, ...).  Returns (x,
    (conv, ssm), (k, v), aux)."""
    decode = mode == "decode"
    convs, ssms = [], []
    for i, bp in enumerate(mps):
        cs = ss = None
        if conv_g is not None:
            cs, ss = conv_g[i], ssm_g[i]
        x, (c_new, s_new) = _mamba_layer(cfg, x, bp, cs, ss, decode,
                                         compute_dtype, kernel_impl)
        if decode:
            conv_g[i] = c_new
            ssm_g[i] = s_new
        else:
            convs.append(c_new)
            ssms.append(s_new)
    x, new_kv, aux = _attn_mlp_layer(
        cfg, x, shared, positions, None, ck, cv, pos_offset,
        mode in ("prefill", "decode"), compute_dtype, kernel_impl)
    states = (None, None) if decode else (torch.stack(convs),
                                          torch.stack(ssms))
    return x, states, new_kv, aux


def _run_hybrid_stack(params, cfg, x, positions, cache, pos_offset, mode,
                      compute_dtype, kernel_impl, remat_policy=None):
    """The hybrid's G groups in order (the JAX package scans them), each
    rematerialised as a whole in train when ``remat_policy`` says so.
    Prefill returns the cache {"conv": (G, per, B, K-1, d_inner + 2N),
    "ssm": (G, per, B, H, P, N), "k"/"v": (G, B, S, K, hd)}; decode
    writes ``cache`` in place.  Returns (x, cache or None, the router
    losses' sum or None)."""
    G, per = _hybrid_groups(cfg)
    group = _maybe_remat(functools.partial(_hybrid_group, cfg),
                         remat_policy if mode == "train" else None)
    layers = _unstack(params["mamba"], G * per)
    convs, ssms, ks, vs, aux = [], [], [], [], None
    for g in range(G):
        conv_g = ssm_g = ck = cv = None
        if cache is not None:
            conv_g, ssm_g = cache["conv"][g], cache["ssm"][g]
            ck, cv = cache["k"][g], cache["v"][g]
        x, (c_new, s_new), (k_g, v_g), aux_g = group(
            x, layers[g * per:(g + 1) * per], params["shared"], positions,
            conv_g, ssm_g, ck, cv, pos_offset, mode, compute_dtype,
            kernel_impl)
        if aux_g is not None:
            aux = aux_g if aux is None else aux + aux_g
        convs.append(c_new)
        ssms.append(s_new)
        ks.append(k_g)
        vs.append(v_g)
    if mode == "train":
        return x, None, aux
    if mode == "decode":
        return x, cache, aux
    return x, {"conv": torch.stack(convs), "ssm": torch.stack(ssms),
               "k": torch.stack(ks), "v": torch.stack(vs)}, aux


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------

def _positions_for(cfg: ArchConfig, B: int, S: int, pos_offset, device):
    """(B, S) int32 positions from ``pos_offset`` (B,) or from 0; under
    M-RoPE the (3, B, S) streams of text, t = h = w."""
    ar = torch.arange(S, dtype=torch.int32, device=device)[None]
    if pos_offset is None:
        pos = ar.expand(B, S)
    else:
        pos = pos_offset.to(torch.int32)[:, None] + ar
    if cfg.rope_mode == "mrope":
        return pos[None].expand(3, B, S)
    return pos


def lm_forward(params, cfg: ArchConfig, *, tokens=None, embeds=None,
               cache=None, pos_offset=None, mode: str = "train",
               compute_dtype=torch.bfloat16, remat_policy=None,
               logits_mode: str = "full", kernel_impl: str = "kernel"):
    """Run the LM.  Returns (logits, new_cache, aux_loss); aux_loss is
    the MoE router loss summed over the layers, zero for the dense, ssm
    and hybrid families.

    logits_mode: 'full' (B,S,V) | 'last' (B,1,V) | 'none' (hidden only).
    mode: 'prefill' (returns the fresh cache), 'decode' (writes ``cache``
    in place at ``pos_offset``) or 'train' (no cache; each layer
    rematerialised in the backward as ``remat_policy`` says: None,
    "full", "dots" or "dots_no_batch", see ``_maybe_remat``).
    ``kernel_impl`` ("kernel" | "plain") selects the family's prefill op:
    the attention (``kernels.attention.ops``) or the SSD
    (``kernels.ssd.ops``).
    """
    check_family(cfg)
    aux = None
    if embeds is not None:
        x = embeds.to(compute_dtype)
    else:
        x = ll.take_embedding(params["embed"], tokens, cfg.embed_scale,
                              compute_dtype)
    x = constrain(x, ("batch", "seq", "d_model"))
    if cfg.family == "ssm":
        x, new_cache = _run_ssm_stack(params, cfg, x, cache, mode,
                                      compute_dtype, kernel_impl,
                                      remat_policy)
    else:
        B, S = x.shape[:2]
        positions = _positions_for(cfg, B, S, pos_offset, x.device)
        stack = (_run_hybrid_stack if cfg.family == "hybrid"
                 else _run_attn_stack)
        x, new_cache, aux = stack(
            params, cfg, x, positions, cache, pos_offset, mode,
            compute_dtype, kernel_impl, remat_policy)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = apply_norm(x, params["final_norm"], cfg)
    if logits_mode == "none":
        return x, new_cache, aux
    if logits_mode == "last":
        x = x[:, -1:]
    logits = _logits(x, params, cfg, compute_dtype)
    logits = constrain(logits, ("batch", "seq", "vocab"))
    return logits, new_cache, aux


def _logits(x, params, cfg: ArchConfig, compute_dtype):
    """The final norm's output ``x`` times the unembedding, soft-capped,
    in float32."""
    unembed = (params["embed"].T if cfg.tie_embeddings
               else params["unembed"])
    logits = ll._mm(x, unembed, compute_dtype)
    return ll.softcap(logits.float(), cfg.final_logit_softcap)


def _ce_sum(x, params, cfg: ArchConfig, targets, compute_dtype):
    """The sum over rows of logsumexp(logits) - logits[target]."""
    logits = _logits(x, params, cfg, compute_dtype)
    return torch.sum(ll.logsumexp_last(logits)
                     - ll.target_logits(logits, targets))


def _chunked_ce(x, params, cfg: ArchConfig, targets, compute_dtype):
    """The mean cross entropy over the rows of ``x`` (B, S, d), in chunks
    of rows whose float32 logits hold a quarter of ``LOSS_CHUNK_LOGITS``,
    each chunk rematerialised in the backward, so that one chunk's
    logits and their gradient are live at a time."""
    xf, tf = x.reshape(-1, x.shape[-1]), targets.reshape(-1)
    rows = max(1, LOSS_CHUNK_LOGITS // 4 // cfg.vocab_size)
    total = sum(checkpoint(_ce_sum, xf[i:i + rows], params, cfg,
                           tf[i:i + rows], compute_dtype,
                           use_reentrant=False)
                for i in range(0, xf.shape[0], rows))
    return total / xf.shape[0]


def lm_loss(params, cfg: ArchConfig, batch, *, compute_dtype=torch.bfloat16,
            remat_policy=None, aux_weight: float = 0.01,
            kernel_impl: str = "kernel"):
    """Next-token cross entropy (+ ``aux_weight`` times the MoE
    load-balance aux, zero for the dense and ssm families): the mean
    over (B, S) of logsumexp(logits) - logits[target], the logits in
    float32, whole or, past ``LOSS_CHUNK_LOGITS`` with no sharding
    context, in row chunks (``_chunked_ce``).  Returns (loss, {"ce",
    "aux"})."""
    x, _, aux = lm_forward(
        params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
        mode="train", compute_dtype=compute_dtype,
        remat_policy=remat_policy, logits_mode="none",
        kernel_impl=kernel_impl)
    B, S = x.shape[:2]
    if (active_context() is None
            and B * S * cfg.vocab_size > LOSS_CHUNK_LOGITS):
        ce = _chunked_ce(x, params, cfg, batch["targets"], compute_dtype)
    else:
        logits = constrain(_logits(x, params, cfg, compute_dtype),
                           ("batch", "seq", "vocab"))
        lse = ll.logsumexp_last(logits)
        tgt = ll.target_logits(logits, batch["targets"])
        # a site of the port's own: the batch stays sharded in the backward
        ce = torch.mean(constrain(lse - tgt, ("batch", "seq")))
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}
