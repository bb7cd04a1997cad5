"""mamba2-2.7b [ssm]: attention-free, SSD (state-space duality).
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,                   # attention-free
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,                      # no separate MLP; mamba block only
    vocab_size=50_280,
    rope_mode="none",
    mlp_act="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,              # d_inner 5120 -> 80 SSD heads
    ssm_conv=4,
    ssm_chunk=256,
    source="arXiv:2405.21060",
)

SMOKE = ArchConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=512, rope_mode="none", norm="rmsnorm",
    tie_embeddings=True,
    ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_conv=4, ssm_chunk=8,
)
