"""rwkv6-7b [ssm]: 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536 —
Finch: data-dependent decay. [arXiv:2404.05892; hf]"""
from dataclasses import replace

from repro_torch.models.lm import ModelConfig

# attention-free, O(1) state decode -> long_500k applicable
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", family="ssm",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, d_ff=14336,
        vocab_size=65536, tie_embeddings=False, norm_eps=1e-5,
    )


def smoke_config() -> ModelConfig:
    return replace(config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                   d_ff=224, vocab_size=256, rwkv_chunk=8, loss_chunk=16)
