"""Architecture + shape configuration system.

Every assigned architecture is a frozen ``ArchConfig``; the four assigned
input shapes are ``ShapeConfig``s.  ``applicable(arch, shape)`` encodes the
assignment's skip rules (long_500k only for sub-quadratic archs, decode only
for archs with a decoder).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "applicable",
           "pad_vocab"]


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Pad vocab to a TPU-friendly multiple (also guarantees /16 for TP)."""
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                # 0 => attention-free
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- attention features -------------------------------------------------
    rope_mode: str = "rope"         # none | rope | mrope
    rope_theta: float = 10_000.0
    sliding_window: int = 0         # >0: window size for *local* layers
    local_global_alternate: bool = False   # gemma2: [local, global]*
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    qk_scale: Optional[float] = None       # default 1/sqrt(head_dim)
    # --- block structure ----------------------------------------------------
    mlp_act: str = "swiglu"         # swiglu | geglu | gelu
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    post_block_norm: bool = False   # gemma2 sandwich norms
    embed_scale: bool = False       # gemma2 multiplies embed by sqrt(d)
    tie_embeddings: bool = False
    # --- MoE ------------------------------------------------------------------
    n_experts: int = 0
    n_experts_active: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2) ----------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid (zamba2): one *shared* attention block applied every N layers
    hybrid_group: int = 0           # 0 = not hybrid; else mamba per group
    # --- enc-dec (whisper) ------------------------------------------------------
    encoder_layers: int = 0         # >0 => encoder-decoder
    encoder_seq: int = 0            # fixed encoder frames (whisper: 1500)
    learned_positions: int = 0      # >0: learned decoder position table
    # --- frontend stubs -----------------------------------------------------
    input_kind: str = "tokens"      # tokens | embeds(+targets) | frames+tokens
    max_seq: int = 524_288
    dtype: str = "bfloat16"
    source: str = ""                # provenance note

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def d_inner(self) -> int:       # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def subquadratic(self) -> bool:
        """True if a 500k-token decode is in contract (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks), for roofline
        MODEL_FLOPS = 6*N*D accounting."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_attn = (self.n_heads + 2 * self.n_kv_heads) * self.head_dim * d \
            + self.n_heads * self.head_dim * d
        if self.mlp_act in ("swiglu", "geglu"):
            per_mlp = 3 * d * f
        else:
            per_mlp = 2 * d * f
        if self.family == "ssm":
            di, n, h = self.d_inner, self.ssm_state, self.ssm_nheads
            g = 1
            per_blk = d * (2 * di + 2 * g * n + h) + di * d \
                + self.ssm_conv * (di + 2 * g * n) + 2 * h + di
            return emb + self.n_layers * per_blk
        if self.family == "hybrid":
            di, n, h = self.d_inner, self.ssm_state, self.ssm_nheads
            g = 1
            per_mamba = d * (2 * di + 2 * g * n + h) + di * d \
                + self.ssm_conv * (di + 2 * g * n) + 2 * h + di
            n_groups = self.n_layers // (self.hybrid_group + 1)
            n_mamba = self.n_layers - n_groups
            shared = per_attn + per_mlp          # one shared block
            return emb + n_mamba * per_mamba + shared
        if self.is_moe:
            per_mlp = per_mlp * self.n_experts + d * self.n_experts
        layers = self.n_layers + self.encoder_layers
        return emb + layers * (per_attn + per_mlp) \
            + (self.encoder_layers * per_attn if self.is_encdec else 0)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.is_moe:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        per_mlp = (3 if self.mlp_act in ("swiglu", "geglu") else 2) * d * f
        dense_total = self.n_params() - self.n_layers * (
            per_mlp * self.n_experts + d * self.n_experts)
        return dense_total + self.n_layers * (
            per_mlp * self.n_experts_active + d * self.n_experts)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment skip rules. Returns (runnable, reason-if-not)."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, ("full quadratic attention - 500k decode out of "
                       "contract (DESIGN.md section 7)")
    return True, ""
