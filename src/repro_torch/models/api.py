"""Model facade: one object per architecture exposing init, loss,
prefill, decode_step, the cache and the input specs — what the
trainer, the serving engine and the sharding tools need.

Parameters are a nested dict of tensors in the JAX package's layout
(layers stacked on a leading axis, e.g. ``wq`` (L, d, H, hd)), so the
JAX package's parameter tree carries across with ``params_from_numpy``
and no transposes.  Weight matrices are held once in the compute dtype
(the JAX package casts its float32 parameters at every use, which gives
the same values); norm weights and the mamba leaves the JAX package
reads in float32 (``A_log``, ``dt_bias``, ``D_skip``, ``gnorm``) stay
float32.  Entry points run on the card unless given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.monitor import resolve_device
from repro_torch.models import layers as ll
from repro_torch.models import transformer, whisper
from repro_torch.models.attention import init_cache_spec
from repro_torch.models.ssm import F32_LEAVES, init_ssm_cache_spec

__all__ = ["Model", "build_model", "params_from_numpy"]

_NORMS = ("ln1", "ln2", "ln1_post", "ln2_post", "final_norm", "ln",
          "ln_x", "enc_norm")


def _leaf_dtype(path: tuple, compute_dtype):
    """Norm weights stay float32 (the norms add 1 + w in float32), and so
    do the mamba leaves read in float32; every other leaf is held in the
    compute dtype."""
    if any(k in _NORMS for k in path) or path[-1] in F32_LEAVES:
        return torch.float32
    return compute_dtype


def _map_tree(tree, fn, path=()):
    return {k: (_map_tree(v, fn, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v)) for k, v in tree.items()}


def params_from_numpy(cfg: ArchConfig, tree: dict, device="cuda",
                      compute_dtype=torch.bfloat16,
                      param_dtype=None) -> dict:
    """The JAX package's parameter tree (numpy arrays, same nesting and
    layout) as the port's tensors on ``device``: weight matrices in
    ``param_dtype`` (default: the compute dtype; float32 for the JAX
    package's float32 training parameters as master weights), norm
    weights and the float32 mamba leaves in float32."""
    dev = resolve_device(device)
    pdt = param_dtype or compute_dtype
    want = Model(cfg, compute_dtype).param_shapes()

    def conv(path, a):
        node = want
        for k in path:
            node = node[k]
        a = np.asarray(a)
        if tuple(a.shape) != tuple(node):
            raise ValueError(f"{'/'.join(path)}: shape {a.shape}, "
                             f"expected {node}")
        t = torch.from_numpy(np.array(a, dtype=np.float32))   # a copy
        return t.to(device=dev, dtype=_leaf_dtype(path, pdt))
    return _map_tree(tree, conv)


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    compute_dtype: Any = torch.bfloat16
    # the prefill op of the family (attention or SSD): "kernel" (the
    # Hopper kernel on the card, its plain version on the CPU) or
    # "plain" (tests and chip_smoke.py)
    kernel_impl: str = "kernel"

    def __post_init__(self):
        transformer.check_family(self.cfg)

    # ---------------- parameters -----------------------------------------
    def _defs(self, mk):
        if self.cfg.is_encdec:
            return whisper.whisper_param_defs(self.cfg, mk)
        return transformer.lm_param_defs(self.cfg, mk)

    def param_shapes(self) -> dict:
        return self._defs(ll.shape_creator())

    def abstract_params(self, param_dtype=torch.float32) -> dict:
        """Every leaf as a ``meta`` tensor of ``param_dtype`` (the JAX
        package's ``ShapeDtypeStruct`` tree): nothing is allocated."""
        return self._defs(ll.abstract_creator(param_dtype))

    def param_axes(self) -> dict:
        """Every leaf's logical-axis tuple, for ``dist.sharding``."""
        return self._defs(ll.axes_creator())

    def init_params(self, generator: torch.Generator,
                    param_dtype=torch.float32, *, device="cuda") -> dict:
        """Random weights from ``generator`` (which must live on
        ``device``'s type); matrices in ``param_dtype`` (float32 master
        weights by default, as the reference's; serving passes the
        compute dtype), norm weights float32."""
        dev = resolve_device(device)
        mats = self._defs(ll.init_creator(generator, dev, param_dtype))
        return _map_tree(mats, lambda path, t: t.to(
            _leaf_dtype(path, param_dtype)))

    # ---------------- training -------------------------------------------
    def loss(self, params, batch, *, remat_policy=None):
        """(loss, {"ce", "aux"}) of ``transformer.lm_loss`` on ``batch``
        ({"tokens" or "embeds", "targets"}), or of
        ``whisper.whisper_loss`` ({"frames", "tokens", "targets"})."""
        if self.cfg.is_encdec:
            return whisper.whisper_loss(
                params, self.cfg, batch, compute_dtype=self.compute_dtype,
                remat_policy=remat_policy, kernel_impl=self.kernel_impl)
        return transformer.lm_loss(
            params, self.cfg, batch, compute_dtype=self.compute_dtype,
            remat_policy=remat_policy, kernel_impl=self.kernel_impl)

    # ---------------- serving ---------------------------------------------
    def prefill(self, params, batch):
        """Full-sequence pass; returns (last_logits (B,1,V), cache) with
        cache {"k", "v"}: (L, B, S, K, hd) in the compute dtype (dense,
        moe; enc-dec adds the encoder's "ck", "cv": (L, B, enc_seq, K,
        hd), and takes ``batch["frames"]``), or {"conv": (L, B, K-1,
        d_inner + 2N) in the compute dtype, "ssm": (L, B, H, P, N)
        float32} (ssm), or both regrouped by the hybrid's G groups of
        ``per`` mamba layers, {"conv": (G, per, B, K-1, d_inner + 2N),
        "ssm": (G, per, B, H, P, N), "k"/"v": (G, B, S, K, hd)}."""
        cfg, kw = self.cfg, dict(compute_dtype=self.compute_dtype,
                                 kernel_impl=self.kernel_impl)
        if cfg.is_encdec:
            enc = whisper.whisper_encode(params, cfg, batch["frames"], **kw)
            return whisper.whisper_forward(
                params, cfg, tokens=batch["tokens"], enc_out=enc,
                mode="prefill", logits_mode="last", **kw)
        logits, cache, _ = transformer.lm_forward(
            params, cfg, tokens=batch.get("tokens"),
            embeds=batch.get("embeds"), mode="prefill", logits_mode="last",
            **kw)
        return logits, cache

    def decode_step(self, params, cache, tokens, pos):
        """One decode step.  tokens: (B,) int; pos: (B,) int — write
        offset into the cache.  Returns (next_tokens, cache); the cache
        is updated in place (the JAX package donates it).  Sharded
        logits are gathered over the vocab before the argmax (DTensor's
        argmax over a sharded dim fails at batch 1)."""
        kw = dict(tokens=tokens[:, None], cache=cache, pos_offset=pos,
                  mode="decode", compute_dtype=self.compute_dtype,
                  logits_mode="last", kernel_impl=self.kernel_impl)
        if self.cfg.is_encdec:
            logits, new_cache = whisper.whisper_forward(params, self.cfg,
                                                        **kw)
        else:
            logits, new_cache, _ = transformer.lm_forward(params, self.cfg,
                                                          **kw)
        last = logits[:, -1]
        if isinstance(last, DTensor):   # DTensor's argmax over a shard
            last = last.redistribute(last.device_mesh, [
                Replicate() if p == Shard(1) else p
                for p in last.placements])
        next_tokens = torch.argmax(last, dim=-1).to(torch.int32)
        return next_tokens, new_cache

    # ---------------- caches -----------------------------------------------
    def cache_spec(self, batch: int, max_seq: int):
        """Cache leaves as (shape, dtype), and their logical axes.  The
        ssm cache does not grow with ``max_seq``; the hybrid's holds the
        ssm states of its G x per mamba layers regrouped (G, per, ...)
        and one KV slice per group."""
        cfg, cdt = self.cfg, self.compute_dtype
        ssm_axes = {"conv": ("layers", "batch", "conv", "ssm_inner"),
                    "ssm": ("layers", "batch", "ssm_heads", "ssm_headdim",
                            "ssm_state")}
        if cfg.family == "ssm":
            return (init_ssm_cache_spec(cfg, batch, cfg.n_layers,
                                        conv_dtype=cdt), ssm_axes)
        kv_axes = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
        if cfg.family == "hybrid":
            G, per = transformer._hybrid_groups(cfg)
            base = init_ssm_cache_spec(cfg, batch, G * per, conv_dtype=cdt)
            kv = init_cache_spec(cfg, batch, max_seq, cdt, layers=G)
            spec = {n: ((G, per) + shape[1:], dt)
                    for n, (shape, dt) in base.items()}
            spec.update(k=kv.k, v=kv.v)
            axes = {n: ("layers",) + a for n, a in ssm_axes.items()}
            axes.update(k=kv_axes, v=kv_axes)
            return spec, axes
        kv = init_cache_spec(cfg, batch, max_seq, cdt)
        spec, axes = {"k": kv.k, "v": kv.v}, {"k": kv_axes, "v": kv_axes}
        if cfg.is_encdec:       # the encoder's keys and values
            x = init_cache_spec(cfg, batch, cfg.encoder_seq, cdt)
            x_axes = ("layers", "batch", "enc_seq", "kv_heads", "head_dim")
            spec.update(ck=x.k, cv=x.v)
            axes.update(ck=x_axes, cv=x_axes)
        return spec, axes

    def init_cache(self, batch: int, max_seq: int, *, device="cuda"):
        dev = resolve_device(device)
        spec, _ = self.cache_spec(batch, max_seq)
        return {n: torch.zeros(shape, dtype=dt, device=dev)
                for n, (shape, dt) in spec.items()}

    # ---------------- input specs -------------------------------------------
    def input_specs(self, shape: ShapeConfig):
        """(batch of ``meta`` tensors, logical axes) for an assigned
        shape: train {inputs, "targets"}, prefill {inputs}, decode
        {"tokens", "pos"} (one new token against the cache).  The
        inputs follow ``cfg.input_kind``: "tokens" (B, S) int32,
        "embeds" (B, S, d_model) bf16, or "frames" (B, enc_seq, d_model)
        bf16 and "tokens"."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        tok = ("batch", "seq")

        def spec(shape_, dtype):
            return torch.empty(shape_, dtype=dtype, device="meta")

        if shape.kind == "decode":
            return ({"tokens": spec((B,), torch.int32),
                     "pos": spec((B,), torch.int32)},
                    {"tokens": ("batch",), "pos": ("batch",)})
        if cfg.input_kind == "embeds":
            batch = {"embeds": spec((B, S, cfg.d_model), torch.bfloat16)}
            axes = {"embeds": ("batch", "seq", "d_model")}
        elif cfg.input_kind == "frames+tokens":
            batch = {"frames": spec((B, cfg.encoder_seq, cfg.d_model),
                                    torch.bfloat16),
                     "tokens": spec((B, S), torch.int32)}
            axes = {"frames": ("batch", "enc_seq", "d_model"),
                    "tokens": tok}
        else:
            batch = {"tokens": spec((B, S), torch.int32)}
            axes = {"tokens": tok}
        if shape.kind == "train":
            batch["targets"] = spec((B, S), torch.int32)
            axes["targets"] = tok
        return batch, axes


def build_model(cfg: ArchConfig, compute_dtype=torch.bfloat16, *,
                kernel_impl: str = "kernel") -> Model:
    return Model(cfg=cfg, compute_dtype=compute_dtype,
                 kernel_impl=kernel_impl)
