"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention block
(every 6 layers, per-invocation LoRA). [arXiv:2411.15242; hf]"""
from dataclasses import replace

from repro_torch.models.lm import ModelConfig

# hybrid SSM: O(1) state decode -> long_500k applicable
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
        vocab_size=32000, ssm_state=64, shared_attn_every=6, lora_rank=128,
        tie_embeddings=True, norm_eps=1e-5,
    )


def smoke_config() -> ModelConfig:
    return replace(config(), n_layers=8, d_model=64, n_heads=4, n_kv_heads=4,
                   d_ff=128, vocab_size=256, ssm_state=16,
                   shared_attn_every=3, lora_rank=8, ssm_chunk=8,
                   loss_chunk=16, chunk_kv=32, chunk_q=16)
