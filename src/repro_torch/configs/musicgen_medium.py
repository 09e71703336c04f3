"""musicgen-medium [audio]: 48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens, 4 codebooks with delay
pattern (handled by the data layout; the EnCodec frontend is a stub:
input_specs supplies the 4 codebook token streams). Text cross-attention
omitted per the backbone-only assignment. [arXiv:2306.05284; hf]"""
from dataclasses import replace

from repro_torch.models.lm import ModelConfig

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="audio",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
        vocab_size=2048, n_codebooks=4, tie_embeddings=False,
        rope_theta=10000.0, norm_eps=1e-5,
    )


def smoke_config() -> ModelConfig:
    return replace(config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                   d_ff=128, vocab_size=64, loss_chunk=16, chunk_kv=32,
                   chunk_q=16)
