"""phi3.5-moe-42b-a6.6b [moe]: 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32_064,
    rope_mode="rope",
    rope_theta=10_000.0,
    mlp_act="swiglu",
    norm="rmsnorm",
    n_experts=16,
    n_experts_active=2,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)

SMOKE = ArchConfig(
    name="phi3p5-moe-smoke",
    family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=512, rope_mode="rope",
    mlp_act="swiglu", norm="rmsnorm",
    n_experts=4, n_experts_active=2,
)
