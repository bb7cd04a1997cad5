"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; unverified]

81 layers; we regularize the interleave to groups of 8 mamba blocks followed
by one application of the single *shared* attention+MLP block (9 groups =>
72 mamba + 9 shared-attn applications = 81 layers). Exact Zamba2 scheduling
differs slightly; dims/counts match. Noted in DESIGN.md section 7.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14_336,
    vocab_size=32_000,
    rope_mode="rope",
    mlp_act="swiglu",
    norm="rmsnorm",
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=256,
    hybrid_group=8,              # 8 mamba blocks per shared-attn application
    source="arXiv:2411.15242",
)

SMOKE = ArchConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=9, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, rope_mode="rope",
    mlp_act="swiglu", norm="rmsnorm",
    ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_conv=4, ssm_chunk=8,
    hybrid_group=2,
)
