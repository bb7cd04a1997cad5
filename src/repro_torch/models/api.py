"""Model facade: one object per architecture exposing init, prefill,
decode_step and the cache — what the serving engine needs.

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

from repro_torch.configs.base import ArchConfig
from repro_torch.core.monitor import resolve_device
from repro_torch.models import layers as ll
from repro_torch.models import transformer
from repro_torch.models.attention import check_supported, init_cache_spec
from repro_torch.models.ssm import F32_LEAVES, init_ssm_cache_spec

__all__ = ["Model", "build_model", "params_from_numpy"]

_NORMS = ("ln1", "ln2", "ln1_post", "ln2_post", "final_norm", "ln")


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
                      compute_dtype=torch.bfloat16) -> dict:
    """The JAX package's parameter tree (numpy arrays, same nesting and
    layout) as the port's tensors on ``device``."""
    dev = resolve_device(device)
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
        return t.to(device=dev, dtype=_leaf_dtype(path, compute_dtype))
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
        if self.cfg.family == "dense":
            check_supported(self.cfg)

    # ---------------- parameters -----------------------------------------
    def _defs(self, mk):
        return transformer.lm_param_defs(self.cfg, mk)

    def param_shapes(self) -> dict:
        return self._defs(ll.shape_creator())

    def init_params(self, generator: torch.Generator, device="cuda",
                    param_dtype=None) -> dict:
        """Random weights from ``generator`` (which must live on
        ``device``'s type); matrices in ``param_dtype`` (default: the
        compute dtype), norm weights float32."""
        dev = resolve_device(device)
        pdt = param_dtype or self.compute_dtype
        mats = self._defs(ll.init_creator(generator, dev, pdt))
        return _map_tree(mats, lambda path, t: t.to(
            _leaf_dtype(path, pdt)))

    # ---------------- serving ---------------------------------------------
    def prefill(self, params, batch):
        """Full-sequence pass; returns (last_logits (B,1,V), cache) with
        cache {"k", "v"}: (L, B, S, K, hd) in the compute dtype (dense),
        or {"conv": (L, B, K-1, d_inner + 2N) in the compute dtype,
        "ssm": (L, B, H, P, N) float32} (ssm)."""
        logits, cache, _ = transformer.lm_forward(
            params, self.cfg, tokens=batch.get("tokens"),
            embeds=batch.get("embeds"), mode="prefill",
            compute_dtype=self.compute_dtype, logits_mode="last",
            kernel_impl=self.kernel_impl)
        return logits, cache

    def decode_step(self, params, cache, tokens, pos):
        """One decode step.  tokens: (B,) int; pos: (B,) int — write
        offset into the cache.  Returns (next_tokens, cache); the cache
        is updated in place (the JAX package donates it)."""
        logits, new_cache, _ = transformer.lm_forward(
            params, self.cfg, tokens=tokens[:, None], cache=cache,
            pos_offset=pos, mode="decode",
            compute_dtype=self.compute_dtype, logits_mode="last",
            kernel_impl=self.kernel_impl)
        next_tokens = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tokens, new_cache

    # ---------------- caches -----------------------------------------------
    def cache_spec(self, batch: int, max_seq: int):
        """Cache leaves as (shape, dtype), and their logical axes.  The
        ssm cache does not grow with ``max_seq``."""
        cfg, cdt = self.cfg, self.compute_dtype
        if cfg.family == "ssm":
            spec = init_ssm_cache_spec(cfg, batch, cfg.n_layers,
                                       conv_dtype=cdt)
            axes = {"conv": ("layers", "batch", "conv", "ssm_inner"),
                    "ssm": ("layers", "batch", "ssm_heads", "ssm_headdim",
                            "ssm_state")}
            return spec, axes
        kv = init_cache_spec(cfg, batch, max_seq, cdt)
        kv_axes = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
        return ({"k": kv.k, "v": kv.v},
                {"k": kv_axes, "v": kv_axes})

    def init_cache(self, batch: int, max_seq: int, device="cuda"):
        dev = resolve_device(device)
        spec, _ = self.cache_spec(batch, max_seq)
        return {n: torch.zeros(shape, dtype=dt, device=dev)
                for n, (shape, dt) in spec.items()}


def build_model(cfg: ArchConfig, compute_dtype=torch.bfloat16, *,
                kernel_impl: str = "kernel") -> Model:
    return Model(cfg=cfg, compute_dtype=compute_dtype,
                 kernel_impl=kernel_impl)
