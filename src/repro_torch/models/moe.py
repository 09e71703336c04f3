"""Mixture-of-Experts FFN, counterpart of ``repro/models/moe.py``.

The reference's single-device path (``n_model = 1``), in plain PyTorch
doing its arithmetic: top-k routing in float32 -> each assignment's slot
within its expert, in token-major order, dropped past the capacity
(GShard-style) -> the experts' GLU as one batched product over
[E, capacity, d] -> a gated combine in float32. The expert-parallel
``shard_map`` path over a ``model`` mesh axis is ROADMAP A.13.3.

Nothing here waits on the host: dispatch writes every assignment into a
buffer with one spare slot an expert, where the dropped ones land and
are cut off, instead of selecting the kept ones by a boolean mask
(whose size the host would have to read).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.ffn import _act
from repro_torch.models.nn import ParamSpec

__all__ = ["MoEConfig", "moe_param_specs", "moe"]


@dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    n_per_token: int
    d_ff: int                      # per-expert hidden width
    capacity_factor: float = 1.25
    renorm_gates: bool = True      # qwen3 renormalizes top-k probs; olmoe not
    activation: str = "silu"
    dtype: str = "bfloat16"


def moe_param_specs(c: MoEConfig) -> dict:
    e, d, f = c.n_experts, c.d_model, c.d_ff
    return {
        "w_router": ParamSpec((d, e), ("embed", None), "float32"),
        "w_gate": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp"),
                            c.dtype),
        "w_up": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp"),
                          c.dtype),
        "w_down": ParamSpec((e, f, d), ("experts", "expert_mlp", "embed"),
                            c.dtype),
    }


def capacity(t: int, c: MoEConfig) -> int:
    """Slots an expert for ``t`` tokens (the reference's float
    expression)."""
    return int(max(4, math.ceil(t * c.n_per_token / c.n_experts
                                * c.capacity_factor)))


def _route(x: torch.Tensor, w_router: torch.Tensor, c: MoEConfig) -> tuple:
    """x [T, d] -> (gates [T*k], experts [T*k], tokens [T*k], probs [T, E]),
    token-major. Ties in the top-k go to the lowest expert id, as
    ``lax.top_k`` gives them (a stable sort; ``torch.topk`` does not)."""
    t, k = x.shape[0], c.n_per_token
    probs = torch.softmax(x.to(torch.float32) @ w_router, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    if c.renorm_gates:
        vals = vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-9)
    tok = torch.arange(t * k, device=x.device) // k
    return vals.reshape(-1), idx.reshape(-1), tok, probs


def _slots(expert: torch.Tensor, n_experts: int, cap: int) -> tuple:
    """(one-hot [A, E] int32, each assignment's slot within its expert: its
    rank among the earlier assignments to that expert, whether it is
    kept: slot < ``cap``)."""
    one_hot = (expert[:, None] == torch.arange(
        n_experts, device=expert.device)).to(torch.int32)
    pos = torch.cumsum(one_hot, dim=0).gather(1, expert[:, None])[:, 0] - 1
    return one_hot, pos, pos < cap


def _moe_inner(x: torch.Tensor, params: dict, c: MoEConfig) -> tuple:
    """x [T, d] -> (out [T, d], aux loss), all E experts on this device."""
    t, d = x.shape
    e, k = c.n_experts, c.n_per_token
    cap = capacity(t, c)
    gate, expert, _, probs = _route(x, params["w_router"], c)
    one_hot, pos, keep = _slots(expert, e, cap)
    pos_c = torch.where(keep, pos, cap)     # the spare slot: dropped

    # dispatch: [E, cap + 1, d], each kept assignment in its own slot
    slot = expert * (cap + 1) + pos_c
    xa = x[:, None, :].expand(t, k, d).reshape(t * k, d)    # x[tok]
    sb = x.new_zeros((e * (cap + 1), d)).index_put((slot,), xa)
    xin = sb.view(e, cap + 1, d)[:, :cap]
    g = torch.bmm(xin, params["w_gate"])
    u = torch.bmm(xin, params["w_up"])
    y = torch.bmm(_act(g, c.activation) * u, params["w_down"])   # [E,cap,d]

    # combine: each token's k assignments added in order onto zero, in f32
    flat = torch.clamp(expert * cap + pos_c, max=e * cap - 1)
    vals = y.reshape(e * cap, d)[flat].view(t, k, d)
    wts = (gate * keep.to(gate.dtype)).to(torch.float32).view(t, k)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        out = out + vals[:, j].to(torch.float32) * wts[:, j, None]

    # load-balancing auxiliary loss (Switch/OLMoE style)
    me = probs.mean(dim=0)                  # mean router prob an expert
    ce = one_hot.view(t, k, e).sum(dim=1).to(torch.float32).mean(dim=0)
    aux = e * torch.sum(me * ce) / k
    return out.to(x.dtype), aux


def moe(params: dict, x: torch.Tensor, c: MoEConfig) -> tuple:
    """x [B, S, d] -> (out [B, S, d], aux loss scalar)."""
    b, s, d = x.shape
    out, aux = _moe_inner(x.reshape(b * s, d), params, c)
    return out.reshape(b, s, d), aux
