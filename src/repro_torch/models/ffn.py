"""Gated-linear-unit FFNs (SwiGLU / GeGLU), counterpart of
``repro/models/ffn.py``."""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models.nn import ParamSpec

__all__ = ["FFNConfig", "ffn_param_specs", "ffn"]


@dataclass(frozen=True)
class FFNConfig:
    d_model: int
    d_ff: int
    activation: str = "silu"   # silu (SwiGLU) | gelu (GeGLU, gemma)
    dtype: str = "bfloat16"


def ffn_param_specs(c: FFNConfig) -> dict:
    return {
        "w_gate": ParamSpec((c.d_model, c.d_ff), ("embed", "mlp"), c.dtype),
        "w_up": ParamSpec((c.d_model, c.d_ff), ("embed", "mlp"), c.dtype),
        "w_down": ParamSpec((c.d_ff, c.d_model), ("mlp", "embed"), c.dtype),
    }


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":     # jax.nn.gelu(approximate=True): the tanh form
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)


def ffn(params: dict, x: torch.Tensor, c: FFNConfig) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]: w_down(act(x w_gate) * x w_up)."""
    h = _act(x @ params["w_gate"], c.activation) * (x @ params["w_up"])
    return h @ params["w_down"]
