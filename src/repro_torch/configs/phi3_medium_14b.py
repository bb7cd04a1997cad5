"""phi3-medium-14b [dense]: RoPE SwiGLU GQA. [arXiv:2404.14219; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    head_dim=128,
    d_ff=17_920,
    vocab_size=100_352,
    rope_mode="rope",
    rope_theta=10_000.0,
    mlp_act="swiglu",
    norm="rmsnorm",
    source="arXiv:2404.14219",
)

SMOKE = ArchConfig(
    name="phi3-medium-smoke",
    family="dense",
    n_layers=2, d_model=80, n_heads=5, n_kv_heads=5, head_dim=16,
    d_ff=160, vocab_size=512, rope_mode="rope",
    mlp_act="swiglu", norm="rmsnorm",
)
