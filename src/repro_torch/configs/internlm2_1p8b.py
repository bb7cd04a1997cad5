"""internlm2-1.8b [dense]: GQA. [arXiv:2403.17297; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92_544,
    rope_mode="rope",
    rope_theta=1_000_000.0,
    mlp_act="swiglu",
    norm="rmsnorm",
    source="arXiv:2403.17297",
)

SMOKE = ArchConfig(
    name="internlm2-smoke",
    family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, rope_mode="rope",
    mlp_act="swiglu", norm="rmsnorm",
)
