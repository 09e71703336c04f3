"""AdamW with decoupled weight decay and global-norm clipping.

Counterpart of ``repro/optim/adamw.py``, as pure math on parameter trees.
Moments are float32 whatever the parameters' dtype; a float32 master copy
is kept when ``master_fp32`` is set. ``adamw_update`` updates the
parameters, moments and master copy in place (under ``no_grad``), as the
reference's donated buffers allow, and returns them.

The step counter is an int32 tensor on the host: the schedule and the
bias corrections are float32 scalars computed there and enter the
device's arithmetic as arguments, so a step never waits on the host.
Under ``jit`` XLA contracts the moment updates into fused multiply-adds;
the port multiplies, then adds (the parity contract's FMA clause).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.models.nn import tree_leaves, tree_map

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "global_norm",
           "schedule"]


@dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    master_fp32: bool = True


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``lr_min``: float32 of the
    step (an int or a host tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order) of their float32 sums
    of squares."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    """{"step": host int32 0, "m", "v": float32 zeros like the
    parameters[, "master": their float32 copy]}."""
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    state = {"step": torch.zeros((), dtype=torch.int32),
             "m": tree_map(zeros32, params), "v": tree_map(zeros32, params)}
    if cfg.master_fp32:
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32).clone(), params)
    return state


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig) -> tuple:
    """One AdamW step, in place. Returns (params, state, metrics), the
    metrics {"lr" (host), "grad_norm" (device)}."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - _f32(b1) ** step.to(torch.float32)
    bc2 = 1 - _f32(b2) ** step.to(torch.float32)
    base = state.get("master", params)
    for p, g, m, v, pf in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]), tree_leaves(state["v"]),
                              tree_leaves(base)):
        g = g.to(torch.float32)
        if scale is not None:
            g = g * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        new = pf.to(torch.float32)
        new = new - lr * (u + cfg.weight_decay * new)
        if pf is not p:
            pf.copy_(new)
        p.copy_(new)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
