"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 — early-fusion, VQ image tokens in the unified vocab,
qk-norm. Modality frontend is a stub: input_specs supplies token ids
(text + pre-tokenized VQ image codes). [arXiv:2405.09818; unverified]"""
from dataclasses import replace

from repro_torch.models.lm import ModelConfig

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", family="vlm",
        n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
        vocab_size=65536, qk_norm=True, rope_theta=10000.0,
        tie_embeddings=False, norm_eps=1e-5,
    )


def smoke_config() -> ModelConfig:
    return replace(config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=128, vocab_size=256, loss_chunk=16, chunk_kv=32,
                   chunk_q=16)
