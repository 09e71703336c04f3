"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64e top-8 (no gate renorm). [arXiv:2409.02060; hf]"""
from dataclasses import replace

from repro_torch.models.lm import ModelConfig

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
        vocab_size=50304, rope_theta=10000.0, qk_norm=True,
        n_experts=64, n_experts_per_token=8, moe_d_ff=1024,
        renorm_gates=False, tie_embeddings=False, norm_eps=1e-5,
    )


def smoke_config() -> ModelConfig:
    # capacity_factor=8 -> no token dropping, so prefill/decode agree exactly
    return replace(config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                   d_ff=64, vocab_size=256, n_experts=8,
                   n_experts_per_token=2, moe_d_ff=64, capacity_factor=8.0,
                   loss_chunk=16, chunk_kv=32, chunk_q=16)
