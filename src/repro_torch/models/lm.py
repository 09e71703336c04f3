"""LM assembly for every family, counterpart of ``repro/models/lm.py``.

One ``ModelConfig`` (every field of the reference's) drives the dense,
MoE, hybrid (Mamba2 + shared attention), SSM (RWKV6), vlm and audio
decoders. Layer kinds: ``G`` (global attention) and ``L`` (sliding
window), each with a dense GLU or, with experts, an MoE FFN; ``M``
(Mamba2); ``R`` (RWKV6 time-mix and channel-mix); ``A`` (zamba2's shared
attention: one weight copy, ``shared_attn``, and a LoRA on W_q for each
invocation). Also several codebooks, tied and untied heads, gemma's
sandwich norms, embedding scale and logit softcap, qk-norm and a local
rope base.

Parameters keep the reference's tree: the layer pattern's blocks stacked
``[n_groups, ...]`` under ``blocks`` and the unscanned ``tail``, with the
same leaf paths, shapes and dtypes, so ``convert.lm_params_from_numpy``
is a copy and checkpoints and the gradient compressor see the same
leaves. Where the reference runs ``lax.scan`` over the groups, ``forward``
runs a Python loop over ``unbind`` of the stacked leaves (whose backward
is one ``stack``); with ``cfg.remat`` each block is recomputed in the
backward pass from its input (the reference recomputes each group; the
gradients are the same), and ``lm_loss``'s cross-entropy chunks always
are. The shared attention block's weights go to every group and to the
tail as they are (the reference broadcasts a copy a group into its
scan).

Caches are updated in place: a group's cache is a view into the stacked
[n_groups, ...] tensors, so a block's new KV entries, SSM, conv and
token-shift state are written into it with ``copy_``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import attention as A
from repro_torch.models import ffn as FF
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R
from repro_torch.models.nn import (ParamSpec, rms_norm, tree_leaves, tree_map,
                                   tree_unflatten)

__all__ = ["ModelConfig", "model_param_specs", "forward", "lm_logits",
           "lm_loss", "init_caches", "decode_step", "prefill", "layer_kinds"]


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: Optional[int] = None
    # attention
    qkv_bias: bool = False
    qk_norm: bool = False
    logit_softcap: Optional[float] = None
    attn_softcap: Optional[float] = None
    rope_theta: float = 10000.0
    rope_theta_local: Optional[float] = None
    window: Optional[int] = None
    layer_pattern: str = "G"     # cycled over layers; tail unscanned
    query_scale: Optional[float] = None
    # ffn
    activation: str = "silu"
    # moe
    n_experts: int = 0
    n_experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    renorm_gates: bool = True
    aux_loss_coef: float = 0.01
    # ssm / hybrid
    ssm_state: int = 64
    ssm_chunk: int = 64
    shared_attn_every: int = 6   # zamba2: shared block every N mamba layers
    lora_rank: int = 64
    rwkv_chunk: int = 16
    # embeddings / output
    n_codebooks: int = 1
    tie_embeddings: bool = True
    embed_scale: bool = False    # gemma: x *= sqrt(d)
    post_norms: bool = False     # gemma2/3 sandwich norms
    norm_eps: float = 1e-6
    # execution
    dtype: str = "bfloat16"
    remat: bool = True
    probs_bf16: bool = False
    chunk_kv: int = 1024
    chunk_q: int = 512
    loss_chunk: int = 512

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def attn_cfg(self, local: bool) -> A.AttnConfig:
        return A.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.hd,
            rope_theta=(self.rope_theta_local
                        if (local and self.rope_theta_local)
                        else self.rope_theta),
            window=self.window if local else None,
            attn_softcap=self.attn_softcap, qk_norm=self.qk_norm,
            qkv_bias=self.qkv_bias, query_scale=self.query_scale,
            norm_eps=self.norm_eps, chunk_kv=self.chunk_kv,
            chunk_q=self.chunk_q, probs_bf16=self.probs_bf16,
            dtype=self.dtype)

    def mamba_cfg(self) -> M.Mamba2Config:
        return M.Mamba2Config(d_model=self.d_model, d_state=self.ssm_state,
                              chunk=self.ssm_chunk, norm_eps=self.norm_eps,
                              dtype=self.dtype)

    def rwkv_cfg(self) -> R.RWKV6Config:
        return R.RWKV6Config(d_model=self.d_model, d_ff=self.d_ff,
                             chunk=self.rwkv_chunk, norm_eps=self.norm_eps,
                             dtype=self.dtype)

    def moe_cfg(self) -> MOE.MoEConfig:
        return MOE.MoEConfig(d_model=self.d_model, n_experts=self.n_experts,
                             n_per_token=self.n_experts_per_token,
                             d_ff=self.moe_d_ff,
                             capacity_factor=self.capacity_factor,
                             renorm_gates=self.renorm_gates,
                             activation=self.activation, dtype=self.dtype)

    def ffn_cfg(self) -> FF.FFNConfig:
        return FF.FFNConfig(d_model=self.d_model, d_ff=self.d_ff,
                            activation=self.activation, dtype=self.dtype)


# -- layer layout --------------------------------------------------------------
def layer_kinds(cfg: ModelConfig) -> tuple:
    """(pattern, number of pattern groups, unscanned tail)."""
    if cfg.family == "hybrid":
        # groups of (A + every*M); 'A' is an insertion, not a counted layer
        pat = "A" + "M" * cfg.shared_attn_every
        n_groups = cfg.n_layers // cfg.shared_attn_every
        tail = cfg.n_layers - n_groups * cfg.shared_attn_every
        return pat, n_groups, "M" * tail
    if cfg.family == "ssm":
        return "R", cfg.n_layers, ""
    pat = cfg.layer_pattern
    n_groups = cfg.n_layers // len(pat)
    return pat, n_groups, pat[:cfg.n_layers - n_groups * len(pat)]


def _norm_spec(cfg: ModelConfig) -> ParamSpec:
    return ParamSpec((cfg.d_model,), ("embed",), cfg.dtype,
                     init="zeros" if cfg.post_norms else "ones")


def _block_param_specs(cfg: ModelConfig, kind: str) -> dict:
    if kind in ("G", "L"):
        specs = {"ln1": _norm_spec(cfg),
                 "attn": A.attn_param_specs(cfg.attn_cfg(kind == "L")),
                 "ln2": _norm_spec(cfg)}
        if cfg.post_norms:
            specs["ln1_post"] = _norm_spec(cfg)
            specs["ln2_post"] = _norm_spec(cfg)
        if cfg.family == "moe" or cfg.n_experts > 0:
            specs["moe"] = MOE.moe_param_specs(cfg.moe_cfg())
        else:
            specs["ffn"] = FF.ffn_param_specs(cfg.ffn_cfg())
        return specs
    if kind == "M":
        return {"ln": _norm_spec(cfg),
                "mamba": M.mamba2_param_specs(cfg.mamba_cfg())}
    if kind == "R":
        rs = R.rwkv6_param_specs(cfg.rwkv_cfg())
        return {"ln1": _norm_spec(cfg), "time": rs["time"],
                "ln2": _norm_spec(cfg), "channel": rs["channel"]}
    if kind == "A":
        # this invocation's LoRA on W_q; the shared weights are
        # ``shared_attn``, outside the stacked groups
        h, hd, r = cfg.n_heads, cfg.hd, cfg.lora_rank
        return {
            "lora_a": ParamSpec((cfg.d_model, r), ("embed", None), cfg.dtype),
            "lora_b": ParamSpec((r, h * hd), (None, "heads"), cfg.dtype,
                                init="zeros"),
        }
    raise ValueError(kind)


def model_param_specs(cfg: ModelConfig) -> dict:
    pat, n_groups, tail = layer_kinds(cfg)
    group = {f"p{i}": _block_param_specs(cfg, k) for i, k in enumerate(pat)}
    cb = cfg.n_codebooks > 1
    specs = {
        "embed": ParamSpec(
            ((cfg.n_codebooks,) if cb else ()) + (cfg.vocab_size, cfg.d_model),
            (("codebooks",) if cb else ()) + ("vocab", "embed"),
            cfg.dtype, init="embed", scale=cfg.d_model ** -0.5),
        "blocks": tree_map(lambda s: ParamSpec(
            (n_groups,) + s.shape, ("layers",) + s.axes, s.dtype, s.init,
            s.scale), group),
        "ln_f": _norm_spec(cfg),
    }
    if tail:
        specs["tail"] = {f"t{i}": _block_param_specs(cfg, k)
                         for i, k in enumerate(tail)}
    if cfg.family == "hybrid":
        specs["shared_attn"] = {
            "ln": _norm_spec(cfg),
            "attn": A.attn_param_specs(cfg.attn_cfg(False)),
        }
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec(
            ((cfg.n_codebooks,) if cb else ()) + (cfg.d_model, cfg.vocab_size),
            (("codebooks",) if cb else ()) + ("embed", "vocab"), cfg.dtype)
    return specs


# -- blocks --------------------------------------------------------------------
def _write(cache: dict, new: dict) -> None:
    """Copy ``new``'s leaves into ``cache``'s (views into the stacked
    group caches) in place."""
    for key, t in new.items():
        if isinstance(t, dict):
            _write(cache[key], t)
        else:
            cache[key].copy_(t)


def _apply_block(kind: str, bp: dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, mode: str, cache, pos,
                 shared=None) -> tuple:
    """One block: returns (x, its aux loss). ``cache`` (None in training)
    is updated in place; ``shared`` is ``shared_attn`` (an A block)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ("G", "L"):
        ac = cfg.attn_cfg(kind == "L")
        h = rms_norm(x, bp["ln1"], cfg.norm_eps, plus_one=cfg.post_norms)
        attn_out, _ = A.attention(bp["attn"], h, ac, positions,
                                  cache=None if cache is None
                                  else cache["kv"], pos=pos, mode=mode)
        if cfg.post_norms:
            attn_out = rms_norm(attn_out, bp["ln1_post"], cfg.norm_eps,
                                plus_one=True)
        x = x + attn_out
        h = rms_norm(x, bp["ln2"], cfg.norm_eps, plus_one=cfg.post_norms)
        if "moe" in bp:
            f_out, aux = MOE.moe(bp["moe"], h, cfg.moe_cfg())
        else:
            f_out = FF.ffn(bp["ffn"], h, cfg.ffn_cfg())
        if cfg.post_norms:
            f_out = rms_norm(f_out, bp["ln2_post"], cfg.norm_eps,
                             plus_one=True)
        return x + f_out, aux
    if kind == "M":
        h = rms_norm(x, bp["ln"], cfg.norm_eps)
        if mode == "train":
            return x + M.mamba2(bp["mamba"], h, cfg.mamba_cfg())[0], aux
        out, new = M.mamba2(bp["mamba"], h, cfg.mamba_cfg(),
                            state=cache["ssm"], conv_state=cache["conv"],
                            mode=mode)
        _write(cache, new)
        return x + out, aux
    if kind == "R":
        rc = cfg.rwkv_cfg()
        h = rms_norm(x, bp["ln1"], cfg.norm_eps)
        if mode == "train":
            x = x + R.rwkv6_timemix(bp["time"], h, rc)[0]
            h = rms_norm(x, bp["ln2"], cfg.norm_eps)
            return x + R.rwkv6_channelmix(bp["channel"], h, rc)[0], aux
        out, tnew = R.rwkv6_timemix(bp["time"], h, rc, state=cache["state"],
                                    shift=cache["shift_t"], mode=mode)
        x = x + out
        h = rms_norm(x, bp["ln2"], cfg.norm_eps)
        out, cnew = R.rwkv6_channelmix(bp["channel"], h, rc,
                                       shift=cache["shift_c"], mode=mode)
        _write(cache, {"state": tnew["state"], "shift_t": tnew["shift"],
                       "shift_c": cnew["shift"]})
        return x + out, aux
    if kind == "A":
        # zamba2's shared attention: the shared weights plus this
        # invocation's LoRA on W_q
        sp = dict(shared["attn"])
        delta = (bp["lora_a"] @ bp["lora_b"]).reshape(
            cfg.d_model, cfg.n_heads, cfg.hd)
        sp["wq"] = sp["wq"] + delta
        h = rms_norm(x, shared["ln"], cfg.norm_eps)
        out, _ = A.attention(sp, h, cfg.attn_cfg(False), positions,
                             cache=None if cache is None else cache["kv"],
                             pos=pos, mode=mode)
        return x + out, aux
    raise ValueError(kind)


def _unstack(tree, n: int) -> list:
    """[tree of the i-th slices] of a tree of stacked [n, ...] leaves."""
    slices = [t.unbind(0) for t in tree_leaves(tree)]
    return [tree_unflatten(tree, [s[i] for s in slices]) for i in range(n)]


def _embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig):
    emb = params["embed"]
    if cfg.n_codebooks > 1:
        x = F.embedding(tokens[..., 0], emb[0])
        for cb in range(1, cfg.n_codebooks):
            x = x + F.embedding(tokens[..., cb], emb[cb])
    else:
        x = F.embedding(tokens, emb)
    if cfg.embed_scale:    # sqrt(d) rounded to the model's dtype first
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype,
                           device=x.device)
    return x


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            mode: str = "train", caches: dict = None, pos: int = None):
    """tokens [B,S] (or [B,S,C] with several codebooks) -> (hidden [B,S,d],
    the caches updated in place or None, aux). ``pos`` (an int) is the
    decode position. Call ``lm_logits``/``lm_loss`` on the hidden
    states."""
    pat, n_groups, tail = layer_kinds(cfg)
    dev = tokens.device
    if pos is None:
        positions = torch.arange(tokens.shape[1], device=dev)
    else:
        positions = torch.full((1,), int(pos), dtype=torch.int64, device=dev)
    x = _embed(params, tokens, cfg)

    group_caches = None if caches is None else caches["groups"]
    shared = params.get("shared_attn")

    def block(kind, bp, x, cache):
        args = (kind, bp, x, cfg, positions, mode, cache, pos, shared)
        return A.remat(_apply_block, *args) if cfg.remat else \
            _apply_block(*args)

    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for gi, gp in enumerate(_unstack(params["blocks"], n_groups)):
        for i, kind in enumerate(pat):
            x, a = block(kind, gp[f"p{i}"], x, None if group_caches is None
                         else tree_map(lambda t: t[gi],
                                       group_caches[f"p{i}"]))
            aux = aux + a
    for i, kind in enumerate(tail):
        x, a = block(kind, params["tail"][f"t{i}"], x,
                     None if caches is None else caches["tail"][f"t{i}"])
        aux = aux + a
    x = rms_norm(x, params["ln_f"], cfg.norm_eps, plus_one=cfg.post_norms)
    return x, caches, aux


# -- heads and loss ------------------------------------------------------------
def _head_weight(params: dict, cfg: ModelConfig) -> torch.Tensor:
    if not cfg.tie_embeddings:
        return params["head"]
    return params["embed"].transpose(-1, -2)


def _logits(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig):
    if cfg.n_codebooks > 1:
        logits = torch.einsum("bsd,cdv->bscv", x, w)
    else:
        logits = x @ w
    logits = logits.to(torch.float32)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def lm_logits(x: torch.Tensor, params: dict, cfg: ModelConfig):
    """x [B,S,d] -> float32 logits [B,S,(C,)V] (decode-sized inputs)."""
    return _logits(x, _head_weight(params, cfg), cfg)


def lm_loss(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> tuple:
    """Causal LM loss, the cross-entropy in sequence chunks of
    ``loss_chunk`` recomputed in the backward pass (the full [B,S,V]
    logits never live), plus ``aux_loss_coef`` times the experts'
    load-balancing loss a layer where the model has experts. Returns
    (loss, metrics: "ce" and, with experts, "aux" summed over layers)."""
    x, _, aux = forward(params, tokens, cfg, mode="train")
    b, s = tokens.shape[:2]
    x_in = x[:, :-1]                   # predict token t+1 from position t
    labels = tokens[:, 1:].to(torch.int64)
    w = _head_weight(params, cfg)

    def chunk_loss(xc, lc):
        logits = _logits(xc, w, cfg)
        lse = torch.logsumexp(logits, dim=-1)
        # the reference's masked sum adds zeros: the gathered gold logit
        gold = logits.gather(-1, lc[..., None]).squeeze(-1)
        return (lse - gold).sum()

    chunk = min(cfg.loss_chunk, s - 1)
    n_full = (s - 1) // chunk
    total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(n_full):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + A.remat(chunk_loss, x_in[:, sl], labels[:, sl])
    rem = (s - 1) - n_full * chunk
    if rem:
        total = total + A.remat(chunk_loss, x_in[:, -rem:], labels[:, -rem:])
    n_tok = b * (s - 1) * (cfg.n_codebooks if cfg.n_codebooks > 1 else 1)
    loss = total / n_tok
    metrics = {"ce": loss}
    if cfg.n_experts:
        loss = loss + cfg.aux_loss_coef * aux / max(cfg.n_layers, 1)
        metrics["aux"] = aux
    return loss, metrics


# -- caches and decode ---------------------------------------------------------
def _block_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                 device) -> dict:
    if kind in ("G", "L", "A"):
        length = min(cfg.window, max_len) if kind == "L" else max_len
        return {"kv": A.init_kv_cache(batch, length,
                                      cfg.attn_cfg(kind == "L"), device)}
    if kind == "M":
        return M.init_mamba_cache(batch, cfg.mamba_cfg(), device)
    if kind == "R":
        return R.init_rwkv_cache(batch, cfg.rwkv_cfg(), device)
    raise ValueError(kind)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device=None) -> dict:
    """Zero caches, each group's stacked [n_groups, ...], the tail's
    unstacked: KV [B, L, KV, D] for G, L and A blocks (L = ``max_len``, or
    ``min(window, max_len)`` for an L layer), the SSM state and conv tails
    for M, the WKV state and the two token shifts for R."""
    pat, n_groups, tail = layer_kinds(cfg)
    groups = {f"p{i}": tree_map(
        lambda c: c.unsqueeze(0).repeat((n_groups,) + (1,) * c.dim()),
        _block_cache(k, cfg, batch, max_len, device))
        for i, k in enumerate(pat)}
    caches = {"groups": groups}
    if tail:
        caches["tail"] = {f"t{i}": _block_cache(k, cfg, batch, max_len,
                                                device)
                          for i, k in enumerate(tail)}
    return caches


def decode_step(params: dict, caches: dict, tokens: torch.Tensor, pos: int,
                cfg: ModelConfig) -> tuple:
    """One decode step: tokens [B,1(,C)] at position ``pos`` (an int).
    Returns (logits [B,1,(C,)V], the caches, updated in place)."""
    x, caches, _ = forward(params, tokens, cfg, mode="decode", caches=caches,
                           pos=pos)
    return lm_logits(x, params, cfg), caches


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int = None) -> tuple:
    """Run the whole prompt: returns (the last position's logits, caches
    of length ``max_len``, the prompt's length by default)."""
    b, s = tokens.shape[:2]
    caches = init_caches(cfg, b, max_len or s, tokens.device)
    x, caches, _ = forward(params, tokens, cfg, mode="prefill", caches=caches)
    return lm_logits(x[:, -1:], params, cfg), caches
