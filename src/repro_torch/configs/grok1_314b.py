"""grok-1-314b [moe]: 8 experts top-2, GeGLU experts.
[hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32_768,
    vocab_size=131_072,
    rope_mode="rope",
    rope_theta=10_000.0,
    attn_logit_softcap=30.0,      # grok caps attention logits
    final_logit_softcap=30.0,
    mlp_act="geglu",
    norm="rmsnorm",
    n_experts=8,
    n_experts_active=2,
    source="hf:xai-org/grok-1",
)

SMOKE = ArchConfig(
    name="grok1-smoke",
    family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, rope_mode="rope",
    attn_logit_softcap=30.0, final_logit_softcap=30.0,
    mlp_act="geglu", norm="rmsnorm",
    n_experts=4, n_experts_active=2,
)
