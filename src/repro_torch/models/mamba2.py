"""Mamba2 (SSD) block, counterpart of ``repro/models/mamba2.py``: a
chunked parallel scan for training and prefill, an O(1) recurrent state
for decode.

State-space recurrence per head (head_dim P, state N, scalar A per head):
    S_t = exp(dt_t * A) * S_t-1 + dt_t * B_t x_t^T     (S in R^{N x P})
    y_t = C_t^T S_t + D * x_t

Chunked form (chunk Q): intra-chunk pairwise decays exp(cum_t - cum_s)
for s <= t; the states between chunks are carried by a Python loop over
the chunks (the reference's ``lax.scan``). B/C are group-shared (G=1).

The pairwise exponent is masked to -inf above the diagonal *before* the
``exp``. The reference takes ``exp`` of every (t, s) pair and masks the
product after, so for s > t it evaluates exp(cum_t - cum_s) > 1, which
overflows to inf once the chunk's decay passes about 88.7: its forward
stays finite, but its backward multiplies the masked zero by inf and
gives NaN (ROADMAP C). Where the reference's values are finite the two
forms agree.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models.nn import ParamSpec, rms_norm, torch_dtype

__all__ = ["Mamba2Config", "mamba2_param_specs", "mamba2", "init_mamba_cache",
           "mamba2_decode"]


@dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64           # N
    head_dim: int = 64          # P
    expand: int = 2
    conv_width: int = 4
    chunk: int = 64
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def mamba2_param_specs(c: Mamba2Config) -> dict:
    d, h, p, n, cw = c.d_model, c.n_heads, c.head_dim, c.d_state, c.conv_width
    return {
        "w_z": ParamSpec((d, h, p), ("embed", "heads", "head_dim"), c.dtype),
        "w_x": ParamSpec((d, h, p), ("embed", "heads", "head_dim"), c.dtype),
        "w_b": ParamSpec((d, n), ("embed", "state"), c.dtype),
        "w_c": ParamSpec((d, n), ("embed", "state"), c.dtype),
        "w_dt": ParamSpec((d, h), ("embed", "heads"), c.dtype),
        "dt_bias": ParamSpec((h,), ("heads",), "float32", init="zeros"),
        "a_log": ParamSpec((h,), ("heads",), "float32", init="zeros"),
        "d_skip": ParamSpec((h,), ("heads",), "float32", init="ones"),
        "conv_x": ParamSpec((cw, h, p), ("conv", "heads", "head_dim"), c.dtype,
                            init="normal", scale=0.5),
        "conv_b": ParamSpec((cw, n), ("conv", "state"), c.dtype,
                            init="normal", scale=0.5),
        "conv_c": ParamSpec((cw, n), ("conv", "state"), c.dtype,
                            init="normal", scale=0.5),
        "norm_w": ParamSpec((h, p), ("heads", "head_dim"), c.dtype, init="ones"),
        "w_out": ParamSpec((h, p, d), ("heads", "head_dim", "embed"), c.dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state=None) -> tuple:
    """Depthwise causal conv along axis 1. x [B,S,...]; w [CW, ...];
    ``state`` [B, CW-1, ...] the previous segment's tail (zeros when None).
    Returns (silu(y), the new tail)."""
    cw, s = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], cw - 1) + tuple(x.shape[2:]))
    xp = torch.cat([state, x], dim=1)
    y = 0
    for i in range(cw):           # the reference's sum(), from 0 in order
        y = y + xp[:, i:i + s] * w[i]
    return F.silu(y), xp[:, s:]


def _ssd_chunked(xdt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 cmat: torch.Tensor, s0: torch.Tensor, chunk: int) -> tuple:
    """Chunked SSD core. xdt [B,S,H,P] (x * dt), a [B,S,H] (dt*A,
    negative), b/cmat [B,S,N], s0 [B,H,N,P] initial state. Returns
    (y [B,S,H,P], the final state [B,H,N,P]), in float32."""
    bsz, s, h, p = xdt.shape
    n = b.shape[-1]
    q = min(chunk, s)
    s_orig = s
    pad = (-s) % q
    if pad:  # padded steps: decay a=0 (identity) and zero inputs -> no-op
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
        s += pad
    nc = s // q
    xdt = xdt.to(torch.float32).reshape(bsz, nc, q, h, p)
    a = a.to(torch.float32).reshape(bsz, nc, q, h)
    b = b.to(torch.float32).reshape(bsz, nc, q, n)
    cmat = cmat.to(torch.float32).reshape(bsz, nc, q, n)

    cum = torch.cumsum(a, dim=2)                        # [B,nc,Q,H] inclusive
    # intra-chunk: scores[t,s] = (C_t . B_s) * exp(cum_t - cum_s), s <= t,
    # the exponent masked before the exp
    cb = cmat @ b.transpose(-1, -2)                     # [B,nc,t,s]
    tri = torch.ones((q, q), dtype=torch.bool, device=xdt.device).tril()
    expo = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).masked_fill(
        ~tri[:, :, None], float("-inf"))                # [B,nc,t,s,H]
    scores = cb[..., None] * torch.exp(expo)
    y_intra = torch.einsum("bctsh,bcshp->bcthp", scores, xdt)

    # chunk summaries: state contribution of chunk c (before inter decay)
    dec_end = torch.exp(cum[:, :, -1:, :] - cum)        # [B,nc,Q,H]
    s_loc = torch.einsum("bcqn,bcqhp->bchnp", b, xdt * dec_end[..., None])
    dec_chunk = torch.exp(cum[:, :, -1, :])             # [B,nc,H]
    s_prev, prevs = s0.to(torch.float32), []
    for ci in range(nc):
        prevs.append(s_prev)
        s_prev = dec_chunk[:, ci, :, None, None] * s_prev + s_loc[:, ci]
    s_prevs = torch.stack(prevs, dim=1)                 # [B,nc,H,N,P]

    # inter-chunk: y_t += exp(cum_t) * C_t . S_prev
    y_inter = torch.einsum("bcqn,bchnp->bcqhp", cmat, s_prevs) * \
        torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bsz, s, h, p)[:, :s_orig]
    return y, s_prev


def mamba2(params: dict, x: torch.Tensor, c: Mamba2Config, state=None,
           conv_state=None, mode: str = "train") -> tuple:
    """x [B,S,d] -> (y [B,S,d], None in training, else the new cache
    {"ssm", "conv": {"x", "b", "c"}})."""
    bsz, s, d = x.shape
    h, p, n = c.n_heads, c.head_dim, c.d_state

    def heads(w):               # "bsd,dhp->bshp"
        return (x @ w.reshape(d, -1)).reshape(bsz, s, h, p)

    z = heads(params["w_z"])
    xs = heads(params["w_x"])
    bmat = x @ params["w_b"]
    cmat = x @ params["w_c"]
    dt = (x @ params["w_dt"]).to(torch.float32)

    cs = conv_state or {}
    xs, cs_x = _causal_conv(xs, params["conv_x"], cs.get("x"))
    bmat, cs_b = _causal_conv(bmat, params["conv_b"], cs.get("b"))
    cmat, cs_c = _causal_conv(cmat, params["conv_c"], cs.get("c"))

    dt = F.softplus(dt + params["dt_bias"])
    a = -torch.exp(params["a_log"]) * dt                # [B,S,H]
    xdt = xs.to(torch.float32) * dt[..., None]

    if state is None:
        state = torch.zeros((bsz, h, n, p), dtype=torch.float32,
                            device=x.device)
    y, s_final = _ssd_chunked(xdt, a, bmat, cmat, state, c.chunk)
    y = y + params["d_skip"][None, None, :, None] * xs.to(torch.float32)

    # gated per-head RMSNorm
    y = y * F.silu(z.to(torch.float32))
    y = rms_norm(y.to(torch_dtype(c.dtype)), params["norm_w"], c.norm_eps)
    out = y.reshape(bsz, s, h * p) @ params["w_out"].reshape(h * p, d)
    if mode == "train":
        return out, None
    return out, {"ssm": s_final, "conv": {"x": cs_x, "b": cs_b, "c": cs_c}}


def init_mamba_cache(batch: int, c: Mamba2Config, device=None) -> dict:
    h, p, n, cw = c.n_heads, c.head_dim, c.d_state, c.conv_width
    dt = torch_dtype(c.dtype)
    return {
        "ssm": torch.zeros((batch, h, n, p), dtype=torch.float32,
                           device=device),
        "conv": {
            "x": torch.zeros((batch, cw - 1, h, p), dtype=dt, device=device),
            "b": torch.zeros((batch, cw - 1, n), dtype=dt, device=device),
            "c": torch.zeros((batch, cw - 1, n), dtype=dt, device=device),
        },
    }


def mamba2_decode(params: dict, x: torch.Tensor, c: Mamba2Config,
                  cache: dict) -> tuple:
    """Single-token decode. x [B,1,d]. Returns (y [B,1,d], the new
    cache)."""
    return mamba2(params, x, c, state=cache["ssm"],
                  conv_state=cache["conv"], mode="decode")
