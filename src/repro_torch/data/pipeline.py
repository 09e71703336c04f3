"""Deterministic, resumable synthetic token pipeline.

Counterpart of ``repro/data/pipeline.py``. Batches are a pure function of
(seed, step): a hidden Markov walk over ``n_states`` states, each state
emitting a token from its own logits, so the loss can fall. Resuming at
step N needs nothing but N, and every rank computes its batch locally.

The walk is the reference's draw for draw, on the port's threefry
generator (``core.prng``): the batch key ``fold_in(PRNGKey(seed ^
0x5EED), step)``, one key a row from ``split``, a start state from
``randint``, then a step's transition and emission each from
``categorical`` under the keys of ``split`` of that step's key. Given the
same tables, a batch equals the reference's bit for bit. The emission
table is the reference's (``normal(k2, (n_states, vocab)) * 2``); the
transition rows are drawn by numpy's ``Generator.dirichlet`` (alpha 0.5),
not by ``jax.random.dirichlet`` (gamma rejection sampling), so the default
tables differ from the reference's (ROADMAP C);
``convert.token_pipeline_from_numpy`` takes the reference's tables.

On the card the walk is a loop over the sequence, vectorised over the
batch. The emission's categorical over the vocabulary runs in bulk: its
Gumbel noise does not depend on the walk. Each row's argmax is found
among the ``_TOP`` best of an estimate made with ``torch.log``, whose
scores lie within 1e-5 of XLA's; those candidates are then scored with
XLA's log (``prng.log_xla``), exactly as the reference scores them. An
asynchronous device check fails the call if a row has more than ``_TOP``
candidates within ``_EPS`` of its best estimate (where the exact argmax
could lie outside them); nothing synchronises with the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device

__all__ = ["DataConfig", "TokenPipeline"]

_TOP = 8                     # exact candidates a row
_EPS = 1e-3                  # the estimate's margin (its error is < 1e-5)
_TINY = float(np.finfo(np.float32).tiny)
_BULK = 1 << 25              # Gumbel values a pass of the emission


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 1024
    seq_len: int = 256
    global_batch: int = 8
    n_codebooks: int = 1
    seed: int = 1234
    n_states: int = 32          # hidden Markov states (learnable structure)


def _bits(k1, k2, n: int) -> torch.Tensor:
    """int32 bits of flat indices 0..n-1 under per-row keys k1, k2 [...]:
    [..., n]."""
    counts = torch.arange(n, dtype=torch.int64, device=k1.device)
    return prng.random_bits_of(k1[..., None], k2[..., None], counts)


def _key_of(k1, k2, i: int) -> tuple:
    """``split(key)[i]`` of per-row keys (int64 tensors)."""
    return prng.threefry2x32(k1, k2, 0, i)


def _uniform_tiny(bits: torch.Tensor) -> torch.Tensor:
    """``uniform(key, shape, tiny, 1.0)`` of the bits: XLA's f * (1 -
    tiny) + tiny is one rounding of f + tiny, which is f for every f > 0
    (a multiple of 2^-23) and tiny for f = 0."""
    return torch.clamp_min(prng._unit_floats(bits), _TINY)


def _gumbel_exact(u: torch.Tensor) -> torch.Tensor:
    return -prng.log_xla(-prng.log_xla(u))


class TokenPipeline:
    """Batches of ``cfg`` on ``device`` (the card by default);
    ``tables`` = (transition [S, S], emission logits [S, V]) float32,
    else drawn from ``cfg.seed``."""

    def __init__(self, cfg: DataConfig, device=None, tables=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if tables is None:
            rng = np.random.default_rng(cfg.seed)
            trans = torch.from_numpy(rng.dirichlet(
                np.full(cfg.n_states, 0.5), size=cfg.n_states).astype(
                    np.float32))
            _, k2 = prng.split(prng.PRNGKey(cfg.seed))
            emit = prng.normal(k2, (cfg.n_states, cfg.vocab_size),
                               device=self.device) * 2.0
        else:
            trans, emit = tables
        self.trans = torch.as_tensor(trans, dtype=torch.float32).to(
            self.device)
        self.emit_logits = torch.as_tensor(emit, dtype=torch.float32).to(
            self.device)
        if self.trans.shape != (cfg.n_states, cfg.n_states) or \
                self.emit_logits.shape != (cfg.n_states, cfg.vocab_size):
            raise ValueError(f"tables {tuple(self.trans.shape)}, "
                             f"{tuple(self.emit_logits.shape)} do not fit "
                             f"{cfg}")
        # the walk's logits of each state: log(trans[state] + 1e-9)
        self._log_trans = prng.log_xla(self.trans + 1e-9)

    def batch_at(self, step: int) -> torch.Tensor:
        """[B, S] (or [B, S, C]) int32 tokens for global step ``step``."""
        cfg, dev = self.cfg, self.device
        b, s, ns, v = (cfg.global_batch, cfg.seq_len, cfg.n_states,
                       cfg.vocab_size)
        nc = cfg.n_codebooks if cfg.n_codebooks > 1 else 1
        key = prng.fold_in(prng.PRNGKey(cfg.seed ^ 0x5EED), step)
        rows = torch.arange(b, dtype=torch.int64, device=dev)
        kb = prng.threefry2x32(key[0], key[1], 0, rows)        # split(key, B)
        ks, ke = _key_of(*kb, 0), _key_of(*kb, 1)
        # the start state: randint(ks, (C,) or (), 0, n_states)
        hi = _bits(*_key_of(*ks, 0), nc).to(torch.int64) & 0xFFFFFFFF
        lo = _bits(*_key_of(*ks, 1), nc).to(torch.int64) & 0xFFFFFFFF
        mult = (((1 << 16) % ns) ** 2) % ns
        state = ((hi % ns) * mult + lo % ns) % ns               # [B, nc]
        # a step's keys: split(ke, S)[t], then its two subkeys
        steps = torch.arange(s, dtype=torch.int64, device=dev)
        kk = prng.threefry2x32(ke[0][:, None], ke[1][:, None], 0,
                               steps[None, :])                  # [B, S]
        k_walk, k_emit = _key_of(*kk, 0), _key_of(*kk, 1)
        g_walk = _gumbel_exact(_uniform_tiny(_bits(*k_walk, nc * ns))).view(
            b, s, nc, ns)
        nxt = torch.empty((b, s, nc), dtype=torch.int64, device=dev)
        for t in range(s):
            state = torch.argmax(g_walk[:, t] + self._log_trans[state], dim=-1)
            nxt[:, t] = state
        tok = self._emit(k_emit[0].reshape(-1), k_emit[1].reshape(-1),
                         nxt.reshape(b * s, nc))
        tok = tok.view(b, s, nc).to(torch.int32)
        return tok if cfg.n_codebooks > 1 else tok[..., 0]

    def _emit(self, k1, k2, states) -> torch.Tensor:
        """argmax over the vocabulary of Gumbel noise under keys (k1, k2)
        [R] plus the emission logits of ``states`` [R, nc]: [R, nc]."""
        nc, v = states.shape[1], self.cfg.vocab_size
        top = min(_TOP, v)
        per = max(1, _BULK // (nc * v))
        out = []
        for a in range(0, states.shape[0], per):
            sl = slice(a, a + per)
            f = prng._unit_floats(_bits(k1[sl], k2[sl], nc * v)).view(
                -1, nc, v)
            logits = self.emit_logits[states[sl]]              # [r, nc, v]
            est = -torch.log(-torch.log(torch.clamp_min(f, _TINY))) + logits
            best = est.topk(min(top + 1, v), dim=-1)
            if v > top:
                torch._assert_async(
                    (best.values[..., top]
                     < best.values[..., 0] - _EPS).all())
            cand = best.indices[..., :top]
            exact = _gumbel_exact(torch.clamp_min(f.gather(-1, cand), _TINY)) \
                + logits.gather(-1, cand)
            top_exact = exact.amax(dim=-1, keepdim=True)
            # the first index among equal maxima, as argmax takes it
            out.append(torch.where(exact == top_exact, cand, v).amin(dim=-1))
        return torch.cat(out)

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
