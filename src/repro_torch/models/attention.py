"""Attention: GQA + RoPE + sliding window + softcap, memory-bounded.

Counterpart of ``repro/models/attention.py``, in plain PyTorch doing the
reference's arithmetic (scores in float32, masked with -2e38, an online
softmax; no ``scaled_dot_product_attention``, which has no softcap):

* ``flash_attention``  -- an online softmax over KV chunks of
  ``chunk_kv``: O(S * chunk) live memory instead of O(S^2);
* ``banded_attention`` -- sliding-window layers attend, a query chunk of
  ``chunk_q`` at a time, to the fixed band [start - window, start + cq);
* ``decode_attention`` -- one position against a KV cache, which for a
  windowed layer is a ring of ``window`` slots.

GQA keeps queries as [B, S, KV, G, D] and never repeats KV heads. Under
autograd each KV step of ``flash_attention`` and each query chunk of
``banded_attention`` is recomputed in the backward pass
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` does:
at qwen2-0.5B, batch 8 and sequence 4,096, one step's float32 scores are
1.9 GB, and keeping every step of every layer would take about 180 GB.
KV caches are updated in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.nn import ParamSpec, rms_norm, torch_dtype

__all__ = ["AttnConfig", "attn_param_specs", "apply_rope", "attention",
           "init_kv_cache", "flash_attention", "banded_attention",
           "decode_attention", "remat"]

_NEG_INF = -2.0e38
_PAD_POS = -10 ** 9      # position of padded KV rows: masked everywhere


@dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: Optional[int] = None        # sliding window (None = global)
    attn_softcap: Optional[float] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    query_scale: Optional[float] = None  # default head_dim**-0.5
    norm_eps: float = 1e-6
    chunk_kv: int = 1024                # flash KV chunk
    chunk_q: int = 512                  # banded query chunk
    probs_bf16: bool = False            # PV product in bf16
    dtype: str = "bfloat16"

    @property
    def groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def scale(self) -> float:
        return (self.query_scale if self.query_scale is not None
                else self.head_dim ** -0.5)


def attn_param_specs(c: AttnConfig) -> dict:
    d, h, k, hd = c.d_model, c.n_heads, c.n_kv_heads, c.head_dim
    specs = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim"), c.dtype),
        "wk": ParamSpec((d, k, hd), ("embed", "kv_heads", "head_dim"), c.dtype),
        "wv": ParamSpec((d, k, hd), ("embed", "kv_heads", "head_dim"), c.dtype),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed"), c.dtype),
    }
    if c.qkv_bias:
        specs["bq"] = ParamSpec((h, hd), ("heads", "head_dim"), c.dtype,
                                init="zeros")
        specs["bk"] = ParamSpec((k, hd), ("kv_heads", "head_dim"), c.dtype,
                                init="zeros")
        specs["bv"] = ParamSpec((k, hd), ("kv_heads", "head_dim"), c.dtype,
                                init="zeros")
    if c.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), ("head_dim",), c.dtype, init="ones")
        specs["k_norm"] = ParamSpec((hd,), ("head_dim",), c.dtype, init="ones")
    return specs


def remat(fn, *args):
    """``fn(*args)``, recomputed in the backward pass when autograd
    records (the counterpart of ``jax.checkpoint``)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [..., S, H, D] rotated by positions [S], in float32."""
    half = x.shape[-1] // 2
    freq = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freq        # [S, half]
    cos = torch.cos(ang)[..., None, :]                         # [S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _softcap(s: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return s if cap is None else cap * torch.tanh(s / cap)


def _project_qkv(params: dict, x: torch.Tensor, c: AttnConfig,
                 positions: torch.Tensor) -> tuple:
    b, s, d = x.shape

    def proj(w):   # "bsd,dhk->bshk"
        return (x @ w.reshape(d, -1)).reshape(b, s, w.shape[1], w.shape[2])

    q, k, v = proj(params["wq"]), proj(params["wk"]), proj(params["wv"])
    if c.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if c.qk_norm:
        q = rms_norm(q, params["q_norm"], c.norm_eps)
        k = rms_norm(k, params["k_norm"], c.norm_eps)
    return (apply_rope(q, positions, c.rope_theta),
            apply_rope(k, positions, c.rope_theta), v)


def _pv(p: torch.Tensor, v: torch.Tensor, c: AttnConfig,
        eq: str) -> torch.Tensor:
    """The probabilities times V (in bf16 when ``probs_bf16``)."""
    if c.probs_bf16:
        p = p.to(torch.bfloat16)
    return torch.einsum(eq, p, v.to(p.dtype))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    c: AttnConfig, q_positions: torch.Tensor,
                    kv_positions: torch.Tensor) -> torch.Tensor:
    """Blockwise causal attention. q [B,S,H,D]; k/v [B,T,KV,D]."""
    b, s, h, d = q.shape
    t = k.shape[1]
    kv, g = c.n_kv_heads, c.groups
    ck = min(c.chunk_kv, t)
    pad = (-t) % ck
    if pad:    # padded KV positions are masked out everywhere
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=_PAD_POS)
        t += pad
    qg = q.reshape(b, s, kv, g, d).to(torch.float32) * c.scale

    def step(m, l, acc, kb, vb, pb):
        sc = torch.einsum("bskgd,btkd->bkgst", qg, kb.to(torch.float32))
        sc = _softcap(sc, c.attn_softcap)
        # a padded key's position precedes every query's, so the causal
        # test alone would keep it (as the reference's does: ROADMAP C)
        mask = (q_positions[:, None] >= pb[None, :]) & (pb != _PAD_POS)
        if c.window is not None:
            mask = mask & ((q_positions[:, None] - pb[None, :]) < c.window)
        sc = torch.where(mask, sc, _NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _pv(p, vb, c, "bkgst,btkd->bkgsd").to(
            torch.float32)
        return m_new, l, acc

    m = torch.full((b, kv, g, s), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kv, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kv, g, s, d), dtype=torch.float32, device=q.device)
    for i in range(t // ck):
        sl = slice(i * ck, (i + 1) * ck)
        m, l, acc = remat(step, m, l, acc, k[:, sl], v[:, sl],
                          kv_positions[sl])
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
    return out.to(q.dtype)


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     c: AttnConfig, positions: torch.Tensor) -> torch.Tensor:
    """Sliding-window attention with O(S * (window + chunk)) work: KV padded
    left by ``window`` (and right by the query padding); query chunk i
    attends to the slab [i*cq - window, i*cq + cq)."""
    b, s, h, d = q.shape
    kv, g = c.n_kv_heads, c.groups
    win = c.window
    cq = min(c.chunk_q, s)
    s_orig = s
    qpad = (-s) % cq
    if qpad:   # padded queries are garbage rows, sliced off at the end
        q = F.pad(q, (0, 0, 0, 0, 0, qpad))
        positions = F.pad(positions, (0, qpad))
        s += qpad
    nq = s // cq
    kp = F.pad(k, (0, 0, 0, 0, win, qpad))
    vp = F.pad(v, (0, 0, 0, 0, win, qpad))
    pos_p = F.pad(positions[:s - qpad], (win, qpad), value=_PAD_POS)
    width = win + cq
    qg = q.reshape(b, nq, cq, kv, g, d).to(torch.float32) * c.scale
    qpos = positions.reshape(nq, cq)

    def one_chunk(qb, pq, kb, vb, pb):
        sc = torch.einsum("bskgd,btkd->bkgst", qb, kb.to(torch.float32))
        sc = _softcap(sc, c.attn_softcap)
        mask = (pq[:, None] >= pb[None, :]) & ((pq[:, None] - pb[None, :])
                                               < win)
        sc = torch.where(mask, sc, _NEG_INF)
        p = torch.softmax(sc, dim=-1)
        return _pv(p, vb, c, "bkgst,btkd->bskgd")      # [b, cq, kv, g, d]

    outs = []
    for i in range(nq):
        sl = slice(i * cq, i * cq + width)
        outs.append(remat(one_chunk, qg[:, i], qpos[i], kp[:, sl], vp[:, sl],
                          pos_p[sl]))
    out = torch.cat(outs, dim=1).reshape(b, s, h, d)[:, :s_orig]
    return out.to(q.dtype)


def init_kv_cache(batch: int, length: int, c: AttnConfig,
                  device=None) -> dict:
    """KV cache [B, L, KV, D]; local layers pass length=window (ring)."""
    shape = (batch, length, c.n_kv_heads, c.head_dim)
    dt = torch_dtype(c.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _cache_write(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: int, ring: Optional[int]) -> dict:
    """Write [B, S_new, KV, D] in place at position ``pos`` (an int; a
    ring's slot is ``pos % ring``). As ``lax.dynamic_update_slice``, a
    write that would run past the end starts earlier."""
    length = cache["k"].shape[1]
    idx = pos % ring if ring else pos
    idx = max(0, min(idx, length - k_new.shape[1]))
    cache["k"][:, idx:idx + k_new.shape[1]] = k_new
    cache["v"][:, idx:idx + v_new.shape[1]] = v_new
    return cache


def decode_attention(q: torch.Tensor, cache: dict, c: AttnConfig, pos: int,
                     ring: Optional[int]) -> torch.Tensor:
    """q [B,1,H,D] against cache [B,L,KV,D]; ``pos`` the current
    position."""
    b, _, h, d = q.shape
    kv, g = c.n_kv_heads, c.groups
    length = cache["k"].shape[1]
    qg = q.reshape(b, 1, kv, g, d).to(torch.float32) * c.scale
    sc = torch.einsum("bskgd,btkd->bkgst", qg,
                      cache["k"].to(torch.float32))
    sc = _softcap(sc, c.attn_softcap)
    slots = torch.arange(length, device=q.device)
    if ring:
        # slot holds absolute position p iff p = pos - ((idx_now - slot) mod ring)
        age = ((pos % ring) - slots) % ring
        abs_pos = pos - age
        mask = (abs_pos >= 0) & (abs_pos <= pos) & ((pos - abs_pos)
                                                     < c.window)
    else:
        mask = slots <= pos
    sc = torch.where(mask, sc, _NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, cache["v"].to(torch.float32))
    return out.reshape(b, 1, h, d).to(q.dtype)


def attention(params: dict, x: torch.Tensor, c: AttnConfig,
              positions: torch.Tensor, cache: dict = None, pos: int = None,
              mode: str = "train") -> tuple:
    """Full attention block: qkv projection -> core -> output projection.

    mode: 'train' (no cache) | 'prefill' (write the cache) | 'decode' (one
    token at position ``pos``). Returns (out [B,S,d], the cache, updated in
    place, or None)."""
    q, k, v = _project_qkv(params, x, c, positions)
    ring = c.window if (c.window is not None and cache is not None
                        and cache["k"].shape[1] == c.window) else None
    if mode == "decode":
        cache = _cache_write(cache, k, v, pos, ring)
        ctx = decode_attention(q, cache, c, pos, ring)
    else:
        if mode == "prefill":
            # positions start at 0. A ring keeps the last `window` tokens
            # at slots p % window: roll so that slot j holds position
            # S - window + ((j - S) mod window).
            kk, vv = k, v
            if ring and k.shape[1] >= ring:
                shift = k.shape[1] % ring
                kk = torch.roll(k[:, -ring:], shift, dims=1)
                vv = torch.roll(v[:, -ring:], shift, dims=1)
            cache = _cache_write(cache, kk, vv, 0, None)
        if c.window is not None and x.shape[1] > c.window:
            ctx = banded_attention(q, k, v, c, positions)
        else:
            ctx = flash_attention(q, k, v, c, positions, positions)
    b, s, h, hd = ctx.shape
    out = ctx.reshape(b, s, h * hd) @ params["wo"].reshape(h * hd, -1)
    return out, (cache if mode != "train" else None)
