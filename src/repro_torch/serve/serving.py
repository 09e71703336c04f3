"""Batched LM serving: prefill, then greedy or temperature decoding.

Counterpart of ``repro/serve/serving.py``. ``make_serve_step`` returns
the one-token step, which updates the KV caches in place (the reference
donates them); ``generate`` is the loop. Sampling at a temperature draws
``prng.categorical`` under the keys the reference splits (``key, k =
split(key)`` a token), so with equal logits both packages pick the same
tokens.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.models import lm as L

__all__ = ["make_serve_step", "generate"]


def make_serve_step(cfg):
    """(params, caches, tokens [B,1(,C)], pos) -> (logits, caches): one
    decode step without autograd, the caches updated in place."""

    @torch.no_grad()
    def step(params, caches, tokens, pos: int):
        return L.decode_step(params, caches, tokens, pos, cfg)

    return step


@torch.no_grad()
def generate(params, prompt: torch.Tensor, cfg, n_tokens: int,
             temperature: float = 0.0, seed: int = 0,
             max_len: int = 0) -> torch.Tensor:
    """prompt [B, S(,C)] -> int32 tokens [B, S + n_tokens(, C)], greedy
    when ``temperature`` is 0, on the prompt's device."""
    b, s = prompt.shape[:2]
    max_len = max_len or (s + n_tokens)
    logits, caches = L.prefill(params, prompt, cfg, max_len=max_len)
    serve_step = make_serve_step(cfg)
    key = prng.PRNGKey(seed)
    out = [prompt.to(torch.int32)]
    shape = (b, 1) + ((cfg.n_codebooks,) if cfg.n_codebooks > 1 else ())
    for i in range(n_tokens):
        key, k = prng.split(key)
        last = logits[:, -1]
        if temperature <= 0.0:
            nxt = torch.argmax(last, dim=-1).to(torch.int32)
        else:
            nxt = prng.categorical(k, last / temperature)
        nxt = nxt.reshape(shape)
        out.append(nxt)
        if i + 1 < n_tokens:
            logits, caches = serve_step(params, caches, nxt, s + i)
    return torch.cat(out, dim=1)
