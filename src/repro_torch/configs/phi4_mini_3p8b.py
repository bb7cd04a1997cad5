"""phi4-mini-3.8b [dense]: RoPE SwiGLU GQA. [arXiv:2412.08905; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200_064,
    rope_mode="rope",
    rope_theta=10_000.0,
    mlp_act="swiglu",
    norm="rmsnorm",
    source="arXiv:2412.08905",
)

SMOKE = ArchConfig(
    name="phi4-mini-smoke",
    family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, rope_mode="rope",
    mlp_act="swiglu", norm="rmsnorm",
)
