"""RWKV6 ("Finch"), counterpart of ``repro/models/rwkv6.py``:
attention-free time-mix with data-dependent decay.

Recurrence per head (key dim K, value dim V), per channel k:
    S_t = diag(w_t) S_{t-1} + k_t v_t^T          w_t = exp(-exp(w0 + lora(x)))
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
The decay's LoRA reads the token-shifted input; token-shift mixing for
r/k/v/g uses static lerp weights, as in the reference.

Training and prefill use the chunked form: intra-chunk pairwise decays
exp(cum_{t-1} - cum_s) for s < t, the states between chunks carried by a
Python loop over the chunks (the reference's ``lax.scan``). As in
``mamba2``, the exponent is masked to -inf off the strict lower triangle
*before* the ``exp``: the reference's ``exp`` of the masked pairs
overflows once a chunk's decay passes about 88.7, and its backward then
gives NaN (ROADMAP C).

The pairwise tensor is [B, nc, Q, Q, H, K] in float32: 8.6 GB a layer at
rwkv6-7b's width with 8 x 4,096 tokens. The intra-chunk term is
therefore evaluated over blocks of chunks of at most ``BLOCK_BYTES`` of
it, each recomputed in the backward pass under autograd; the formula and
its reduction order are the same for any blocking.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.models.attention import remat
from repro_torch.models.nn import ParamSpec, rms_norm, torch_dtype

__all__ = ["RWKV6Config", "rwkv6_param_specs", "rwkv6_timemix",
           "rwkv6_channelmix", "init_rwkv_cache"]

BLOCK_BYTES = 1 << 30      # the pairwise decays of one block of chunks


@dataclass(frozen=True)
class RWKV6Config:
    d_model: int
    head_dim: int = 64           # K = V = head_dim
    d_ff: int = 0                # channel-mix hidden (3.5x d_model)
    decay_lora: int = 64
    chunk: int = 16
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


def rwkv6_param_specs(c: RWKV6Config) -> dict:
    d, h, k, r = c.d_model, c.n_heads, c.head_dim, c.decay_lora
    f = c.d_ff
    return {
        "time": {
            "mu_r": ParamSpec((d,), ("embed",), c.dtype, init="zeros"),
            "mu_k": ParamSpec((d,), ("embed",), c.dtype, init="zeros"),
            "mu_v": ParamSpec((d,), ("embed",), c.dtype, init="zeros"),
            "mu_g": ParamSpec((d,), ("embed",), c.dtype, init="zeros"),
            "mu_w": ParamSpec((d,), ("embed",), c.dtype, init="zeros"),
            "w_r": ParamSpec((d, h, k), ("embed", "heads", "head_dim"), c.dtype),
            "w_k": ParamSpec((d, h, k), ("embed", "heads", "head_dim"), c.dtype),
            "w_v": ParamSpec((d, h, k), ("embed", "heads", "head_dim"), c.dtype),
            "w_g": ParamSpec((d, h, k), ("embed", "heads", "head_dim"), c.dtype),
            "w0": ParamSpec((h, k), ("heads", "head_dim"), "float32",
                            init="normal", scale=0.5),
            "w_lora_a": ParamSpec((d, r), ("embed", None), c.dtype),
            "w_lora_b": ParamSpec((r, h, k), (None, "heads", "head_dim"),
                                  c.dtype, init="zeros"),
            "u": ParamSpec((h, k), ("heads", "head_dim"), "float32",
                           init="normal", scale=0.5),
            "ln_w": ParamSpec((h, k), ("heads", "head_dim"), c.dtype,
                              init="ones"),
            "w_out": ParamSpec((h, k, d), ("heads", "head_dim", "embed"),
                               c.dtype),
        },
        "channel": {
            "mu_k": ParamSpec((d,), ("embed",), c.dtype, init="zeros"),
            "mu_r": ParamSpec((d,), ("embed",), c.dtype, init="zeros"),
            "w_k": ParamSpec((d, f), ("embed", "mlp"), c.dtype),
            "w_v": ParamSpec((f, d), ("mlp", "embed"), c.dtype),
            "w_r": ParamSpec((d, d), ("embed", None), c.dtype),
        },
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> tuple:
    """x [B,S,d]; last [B,1,d] the previous token (zeros at the start).
    Returns (shifted x, the new last)."""
    return torch.cat([last, x[:, :-1]], dim=1), x[:, -1:]


def _lerp(x: torch.Tensor, xs: torch.Tensor, mu: torch.Tensor):
    return x + (xs - x) * mu


def _intra(r, k, v, cum_ex, cum, u):
    """The intra-chunk output of a block of chunks, each [B, c, Q, H, K]:
    the strictly causal pairs through A[t,s] = sum_k r_t k_s
    exp(cumex_t - cum_s), plus the diagonal's ``u`` bonus."""
    q = r.shape[2]
    strict = torch.ones((q, q), dtype=torch.bool, device=r.device).tril(-1)
    expo = (cum_ex[:, :, :, None] - cum[:, :, None]).masked_fill(
        ~strict[:, :, None, None], float("-inf"))       # [B,c,t,s,H,K]
    amat = torch.einsum("bctshk,bcthk,bcshk->bctsh", torch.exp(expo), r, k)
    diag = torch.einsum("bcthk,hk,bcthk->bcth", r, u, k)
    return torch.einsum("bctsh,bcshk->bcthk", amat, v) + diag[..., None] * v


def _wkv_chunked(r, k, v, lw, u, s0, chunk: int) -> tuple:
    """r,k,v [B,S,H,K] f32; lw [B,S,H,K] (log decay, negative); u [H,K];
    s0 [B,H,K,K]. Returns (o [B,S,H,K], the final state)."""
    bsz, s, h, kk = r.shape
    q = min(chunk, s)
    s_orig = s
    pad = (-s) % q
    if pad:  # padded steps: decay lw=0 (identity), zero r/k/v -> no-op
        r, k, v, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, lw))
        s += pad
    nc = s // q
    rs, ks, vs, lws = (t.reshape(bsz, nc, q, h, kk) for t in (r, k, v, lw))
    cum = torch.cumsum(lws, dim=2)                   # inclusive [B,nc,Q,H,K]
    cum_ex = cum - lws                               # exclusive = cum_{t-1}

    per_chunk = bsz * q * q * h * kk * 4
    nb = max(1, BLOCK_BYTES // per_chunk)
    o_intra = torch.cat([
        remat(_intra, rs[:, i:i + nb], ks[:, i:i + nb], vs[:, i:i + nb],
              cum_ex[:, i:i + nb], cum[:, i:i + nb], u)
        for i in range(0, nc, nb)], dim=1)

    # inter-chunk: o_t += (r_t * exp(cumex_t))^T S_prev
    dec_end = torch.exp(cum[:, :, -1:] - cum)        # decay s -> chunk end
    s_locs = torch.einsum("bcqhk,bcqhv->bchkv", ks * dec_end, vs)
    dec_tot = torch.exp(cum[:, :, -1])               # [B,nc,H,K]
    s_prev, prevs = s0, []
    for ci in range(nc):
        prevs.append(s_prev)
        s_prev = dec_tot[:, ci, ..., None] * s_prev + s_locs[:, ci]
    s_prevs = torch.stack(prevs, dim=1)              # [B,nc,H,K,V]
    o_inter = torch.einsum("bcqhk,bchkv->bcqhv", rs * torch.exp(cum_ex),
                           s_prevs)
    o = (o_intra + o_inter).reshape(bsz, s, h, kk)[:, :s_orig]
    return o, s_prev


def rwkv6_timemix(params: dict, x: torch.Tensor, c: RWKV6Config, state=None,
                  shift=None, mode: str = "train") -> tuple:
    """x [B,S,d] -> (out, None in training, else {"state" [B,H,K,V],
    "shift" [B,1,d]})."""
    p = params
    bsz, s, d = x.shape
    h, kk = c.n_heads, c.head_dim
    if shift is None:
        shift = x.new_zeros((bsz, 1, d))
    xs, new_shift = _token_shift(x, shift)

    def heads(mu, w):           # "bsd,dhk->bshk" of the lerped input
        return (_lerp(x, xs, mu) @ w.reshape(d, -1)).reshape(bsz, s, h, kk)

    r = heads(p["mu_r"], p["w_r"])
    k = heads(p["mu_k"], p["w_k"])
    v = heads(p["mu_v"], p["w_v"])
    g = heads(p["mu_g"], p["w_g"])

    # data-dependent decay (the RWKV6 contribution)
    wx = _lerp(x, xs, p["mu_w"])
    lora = (torch.tanh(wx @ p["w_lora_a"]) @ p["w_lora_b"].reshape(
        p["w_lora_b"].shape[0], -1)).reshape(bsz, s, h, kk)
    lw = -torch.exp(torch.clamp(p["w0"] + lora.to(torch.float32), -8.0, 4.0))

    if state is None:
        state = torch.zeros((bsz, h, kk, kk), dtype=torch.float32,
                            device=x.device)
    o, s_final = _wkv_chunked(r.to(torch.float32), k.to(torch.float32),
                              v.to(torch.float32), lw, p["u"], state,
                              c.chunk)
    o = rms_norm(o.to(x.dtype), p["ln_w"], c.norm_eps)
    o = o * F.silu(g)
    out = o.reshape(bsz, s, h * kk) @ p["w_out"].reshape(h * kk, d)
    if mode == "train":
        return out, None
    return out, {"state": s_final, "shift": new_shift}


def rwkv6_channelmix(params: dict, x: torch.Tensor, c: RWKV6Config,
                     shift=None, mode: str = "train") -> tuple:
    p = params
    if shift is None:
        shift = x.new_zeros((x.shape[0], 1, x.shape[-1]))
    xs, new_shift = _token_shift(x, shift)
    k = torch.square(F.relu(_lerp(x, xs, p["mu_k"]) @ p["w_k"]))
    kv = k @ p["w_v"]
    rgate = torch.sigmoid(_lerp(x, xs, p["mu_r"]) @ p["w_r"])
    out = rgate * kv
    if mode == "train":
        return out, None
    return out, {"shift": new_shift}


def init_rwkv_cache(batch: int, c: RWKV6Config, device=None) -> dict:
    h, kk, d = c.n_heads, c.head_dim, c.d_model
    dt = torch_dtype(c.dtype)
    return {
        "state": torch.zeros((batch, h, kk, kk), dtype=torch.float32,
                             device=device),
        "shift_t": torch.zeros((batch, 1, d), dtype=dt, device=device),
        "shift_c": torch.zeros((batch, 1, d), dtype=dt, device=device),
    }
