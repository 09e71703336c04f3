"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128e top-8 (renormalized gates), qk-norm.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from dataclasses import replace

from repro_torch.models.lm import ModelConfig

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=1536,
        vocab_size=151936, head_dim=128, rope_theta=1e6, qk_norm=True,
        n_experts=128, n_experts_per_token=8, moe_d_ff=1536,
        renorm_gates=True, tie_embeddings=False, norm_eps=1e-6,
    )


def smoke_config() -> ModelConfig:
    # capacity_factor=8 -> no token dropping, so prefill/decode agree exactly
    return replace(config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   head_dim=16, d_ff=64, vocab_size=256, n_experts=8,
                   n_experts_per_token=2, moe_d_ff=64, capacity_factor=8.0,
                   loss_chunk=16, chunk_kv=32, chunk_q=16)
