"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064 — RoPE SwiGLU MHA. [arXiv:2404.14219; unverified]"""
from dataclasses import replace

from repro_torch.models.lm import ModelConfig

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
        vocab_size=32064, rope_theta=10000.0,
        tie_embeddings=False, norm_eps=1e-5,
    )


def smoke_config() -> ModelConfig:
    return replace(config(), n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                   d_ff=128, vocab_size=256, loss_chunk=16, chunk_kv=32,
                   chunk_q=16)
