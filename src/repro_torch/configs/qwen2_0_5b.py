"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936 — GQA, QKV bias. [arXiv:2407.10671; hf]"""
from dataclasses import replace

from repro_torch.models.lm import ModelConfig

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]  # pure full attention


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", family="dense",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
        vocab_size=151936, qkv_bias=True, rope_theta=1e6,
        tie_embeddings=True, norm_eps=1e-6,
    )


def smoke_config() -> ModelConfig:
    return replace(config(), n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                   head_dim=16, d_ff=128, vocab_size=256, loss_chunk=16,
                   chunk_kv=32, chunk_q=16)
