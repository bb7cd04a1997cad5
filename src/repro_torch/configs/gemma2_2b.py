"""gemma2-2b [dense]: local+global alternating attention, logit softcaps,
GeGLU, sandwich norms, tied + scaled embedding. [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    rope_mode="rope",
    rope_theta=10_000.0,
    sliding_window=4096,
    local_global_alternate=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_act="geglu",
    norm="rmsnorm",
    post_block_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    source="arXiv:2408.00118",
)

SMOKE = ArchConfig(
    name="gemma2-smoke",
    family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, rope_mode="rope",
    sliding_window=8, local_global_alternate=True,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    mlp_act="geglu", norm="rmsnorm", post_block_norm=True,
    embed_scale=True, tie_embeddings=True,
)
