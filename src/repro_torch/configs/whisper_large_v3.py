"""whisper-large-v3 [audio]: enc-dec, conv frontend stubbed to precomputed
frame embeddings (1500 frames). [arXiv:2212.04356; unverified]

Assignment line: 32L d_model=1280 20H (GQA kv=20) d_ff=5120 vocab=51866.
Whisper-large has 32 encoder + 32 decoder layers; we honor 32L as 32+32
(true whisper-large-v3 structure) — noted in DESIGN.md.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,                 # decoder layers
    encoder_layers=32,
    encoder_seq=1536,            # 30 s = 1500 frames after the conv stem
                                 # (stub), padded to 1536 so the cross-KV
                                 # cache can shard 16-way (DESIGN.md sec 7)
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,               # MHA (GQA kv=20)
    head_dim=64,
    d_ff=5120,
    vocab_size=51_866,
    rope_mode="none",            # whisper uses learned/sinusoidal positions
    mlp_act="gelu",
    norm="layernorm",
    tie_embeddings=True,
    input_kind="frames+tokens",
    learned_positions=32_768,    # covers the largest assigned decode shape
    source="arXiv:2212.04356",
)

SMOKE = ArchConfig(
    name="whisper-smoke",
    family="audio",
    n_layers=2, encoder_layers=2, encoder_seq=16,
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512,
    rope_mode="none", mlp_act="gelu", norm="layernorm",
    tie_embeddings=True, input_kind="frames+tokens",
    learned_positions=64,
)
