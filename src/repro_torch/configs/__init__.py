"""Assigned architecture configs (exact) + reduced smoke variants.

``get_config(arch_id)`` returns the full assignment config;
``get_smoke_config(arch_id)`` a same-family reduced config runnable on one
CPU device. ``ARCHS`` lists all assigned ids.

Counterpart of ``repro.configs``: every config's values are the
reference's, built on the port's ``ModelConfig``; the port runs the
dense, vlm and audio families (MoE, hybrid and SSM are ROADMAP A.13.2).
"""
from __future__ import annotations

import importlib

ARCHS = [
    "qwen2_0_5b", "gemma2_9b", "phi3_mini_3_8b", "gemma3_27b",
    "olmoe_1b_7b", "qwen3_moe_235b_a22b", "zamba2_1_2b", "chameleon_34b",
    "musicgen_medium", "rwkv6_7b",
]

# canonical assignment ids -> module names
ALIASES = {
    "qwen2-0.5b": "qwen2_0_5b",
    "gemma2-9b": "gemma2_9b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "gemma3-27b": "gemma3_27b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "zamba2-1.2b": "zamba2_1_2b",
    "chameleon-34b": "chameleon_34b",
    "musicgen-medium": "musicgen_medium",
    "rwkv6-7b": "rwkv6_7b",
}


def _module(arch: str):
    name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _module(arch).config()


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()


def shapes_for(arch: str):
    """Applicable (shape_name, kind) cells for this arch (long_500k only
    for sub-quadratic archs; see DESIGN.md)."""
    mod = _module(arch)
    return getattr(mod, "SHAPES", ["train_4k", "prefill_32k", "decode_32k"])
