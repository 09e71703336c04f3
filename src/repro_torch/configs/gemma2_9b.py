"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 — local(4096)+global alternating, logit softcap.
[arXiv:2408.00118; hf]"""
from dataclasses import replace

from repro_torch.models.lm import ModelConfig

# local layers are sub-quadratic but global layers keep full 500k KV;
# not sub-quadratic end-to-end -> long_500k skipped (DESIGN.md).
SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b", family="dense",
        n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_ff=14336,
        vocab_size=256000, head_dim=256,
        layer_pattern="LG", window=4096,
        attn_softcap=50.0, logit_softcap=30.0,
        activation="gelu", post_norms=True, embed_scale=True,
        query_scale=256 ** -0.5,
        tie_embeddings=True, norm_eps=1e-6,
    )


def smoke_config() -> ModelConfig:
    return replace(config(), n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                   head_dim=16, d_ff=128, vocab_size=256, window=8,
                   query_scale=16 ** -0.5, loss_chunk=16, chunk_kv=32,
                   chunk_q=16)
