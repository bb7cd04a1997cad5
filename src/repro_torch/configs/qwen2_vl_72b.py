"""qwen2-vl-72b [vlm]: M-RoPE, dynamic resolution; vision frontend stubbed
to precomputed patch embeddings. [arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29_568,
    vocab_size=152_064,
    rope_mode="mrope",           # 3-section rotary over (t, h, w)
    rope_theta=1_000_000.0,
    mlp_act="swiglu",
    norm="rmsnorm",
    input_kind="embeds",         # frontend stub: precomputed patch embeds
    source="arXiv:2409.12191",
)

SMOKE = ArchConfig(
    name="qwen2-vl-smoke",
    family="vlm",
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=2, head_dim=24,
    d_ff=192, vocab_size=512, rope_mode="mrope",
    mlp_act="swiglu", norm="rmsnorm", input_kind="embeds",
)
