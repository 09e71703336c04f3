"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144 — 5:1 local(1024):global, 128k context, dual rope bases,
qk-norm. [hf:google/gemma-3-1b-pt; unverified]"""
from dataclasses import replace

from repro_torch.models.lm import ModelConfig

# global layers keep a full 500k KV -> long_500k skipped (DESIGN.md)
SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b", family="dense",
        n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_ff=21504,
        vocab_size=262144, head_dim=128,
        layer_pattern="LLLLLG", window=1024,
        rope_theta=1_000_000.0, rope_theta_local=10_000.0,
        qk_norm=True, activation="gelu", post_norms=True, embed_scale=True,
        tie_embeddings=True, norm_eps=1e-6,
    )


def smoke_config() -> ModelConfig:
    return replace(config(), n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
                   head_dim=16, d_ff=128, vocab_size=256, window=8,
                   loss_chunk=16, chunk_kv=32, chunk_q=16)
