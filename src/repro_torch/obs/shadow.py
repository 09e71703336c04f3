"""Shadow ground truth: reservoir-retained raw rows + exact re-scoring.

Counterpart of ``repro/obs/shadow.py``. Coded search drops the raw rows
by design, so a served index cannot measure its own recall. This module
keeps a capped, seeded reservoir of raw rows at ingest (Algorithm R:
every live row is retained with equal probability whatever the arrival
order) and re-scores sampled shadow queries by exact cosine against it,
giving an unbiased online recall@k and a rho-estimation-error series
without keeping the corpus.

The protocol is reservoir-restricted and exactly paired: for one sampled
query the ground truth is the exact-cosine top-k among the reservoir
rows, and the system answer is the coded ranking (collision fraction,
the engines' count-ranked score) over the same rows coded by the
engine's own ``encode_queries``. Per-slot hits are Bernoulli trials,
summarised with Wilson score intervals; the same pairs feed a Welford
series of ``rho_hat - rho_true`` against the estimator's asymptotic std
(the paper's Figs 6-7, audited online).

The reservoir's rows and the ground truth stay in host numpy, as in the
reference (at most ``cap`` x D float32); a batch offered from the card
is read back only at the rows the reservoir keeps. Its codes are made on
the engine's device once per reservoir version and held on the host.

Invariants: at most ``cap`` rows, each with its external id;
tombstone-aware (``remove``, wired to the segment log's delete events,
drops rows at once, so a deleted row never appears in ground truth);
upsert-aware (re-offering an id replaces its row in place); ``version``
moves on any membership change, which invalidates the cached codes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.obs.quality import Welford, _host
from repro_torch.obs.registry import MetricsRegistry, default_registry

__all__ = ["wilson_interval", "ShadowReservoir", "RecallMonitor"]


def wilson_interval(successes: int, trials: int, z: float = 1.96):
    """Wilson score interval for a Bernoulli rate: (lo, hi) at the given
    normal quantile (1.96 = 95%). Returns (nan, nan) with no trials."""
    if trials <= 0:
        return (math.nan, math.nan)
    p = successes / trials
    z2 = z * z
    denom = 1.0 + z2 / trials
    center = (p + z2 / (2 * trials)) / denom
    half = (z / denom) * math.sqrt(
        p * (1 - p) / trials + z2 / (4 * trials * trials))
    return (max(0.0, center - half), min(1.0, center + half))


class ShadowReservoir:
    """Seeded Algorithm-R reservoir of raw f32 rows keyed by external id.

    ``offer`` streams candidate rows in (ingest hook), ``remove`` drops
    deleted ids (segment-log listener), ``rows()``/``ids()`` expose the
    members. Eviction is uniform over everything offered so far, so the
    reservoir is an unbiased sample of the live corpus as long as deletes
    are uncorrelated with membership.
    """

    def __init__(self, cap: int = 1024, seed: int = 0,
                 registry: MetricsRegistry = None):
        self.cap = int(cap)
        self.rng = np.random.default_rng(seed)
        self.registry = registry if registry is not None \
            else default_registry()
        self.n_seen = 0
        self.version = 0
        self._ids: list[int] = []
        self._rows: list[np.ndarray] = []
        self._slot: dict[int, int] = {}
        self._g_rows = self.registry.gauge("quality.reservoir.rows")
        self._g_seen = self.registry.gauge("quality.reservoir.seen")

    def __len__(self) -> int:
        return len(self._ids)

    def offer(self, ids, rows):
        """Offer a batch of (id, raw row) pairs, rows [m, D] a tensor on
        any device or an array; each survives with probability
        cap/n_seen (Algorithm R), an id already held is replaced in place
        (upsert, no slot draw). The slot draws come first; then only the
        kept rows are read, in one gather."""
        ids = np.asarray(ids, np.int64).ravel()
        writes = []                              # (slot, row index)
        for i, ext in enumerate(ids):
            ext = int(ext)
            slot = self._slot.get(ext)
            if slot is not None:                 # upsert: replace in place
                writes.append((slot, i))
                continue
            self.n_seen += 1
            if len(self._ids) < self.cap:
                self._slot[ext] = len(self._ids)
                self._ids.append(ext)
                self._rows.append(None)
                writes.append((len(self._ids) - 1, i))
            else:
                j = int(self.rng.integers(self.n_seen))
                if j < self.cap:
                    del self._slot[self._ids[j]]
                    self._slot[ext] = j
                    self._ids[j] = ext
                    writes.append((j, i))
        if not writes:
            return
        final = dict(writes)                     # the last write wins
        idx = sorted(set(final.values()))
        if isinstance(rows, torch.Tensor):
            kept = _host(rows[torch.as_tensor(idx, device=rows.device)])
        else:
            kept = np.asarray(rows)[idx]
        kept = kept.astype(np.float32)
        at = {i: r for r, i in enumerate(idx)}
        for slot, i in final.items():
            self._rows[slot] = kept[at[i]].copy()
        self.version += 1
        self._g_rows.set(len(self._ids))
        self._g_seen.set(self.n_seen)

    def remove(self, ids):
        """Drop any of ``ids`` currently retained (tombstone hook; a
        missing id is a no-op). Swap-with-last keeps storage dense."""
        changed = False
        for ext in np.asarray(ids, np.int64).ravel():
            slot = self._slot.pop(int(ext), None)
            if slot is None:
                continue
            last = len(self._ids) - 1
            if slot != last:
                self._ids[slot] = self._ids[last]
                self._rows[slot] = self._rows[last]
                self._slot[self._ids[slot]] = slot
            self._ids.pop()
            self._rows.pop()
            changed = True
        if changed:
            self.version += 1
            self._g_rows.set(len(self._ids))

    def ids(self) -> np.ndarray:
        """Current member ids, int64 [R]."""
        return np.asarray(self._ids, np.int64)

    def rows(self) -> np.ndarray:
        """Current raw rows, f32 [R, d] (empty [0, 0] when empty)."""
        if not self._rows:
            return np.zeros((0, 0), np.float32)
        return np.stack(self._rows)


class RecallMonitor:
    """Online recall@k + rho-error from shadow queries vs the reservoir.

    ``observe_query`` runs the reservoir-restricted protocol (module
    docstring) for one raw query; hits accumulate as Bernoulli trials,
    and ``report()`` gives the running recall with its Wilson 95%
    interval, the moments of ``rho_hat - rho_true`` over the ground-truth
    pairs and the estimator's predicted asymptotic std at the observed
    rho.
    """

    def __init__(self, reservoir: ShadowReservoir, top_k: int = 10,
                 registry: MetricsRegistry = None,
                 name: str = "quality.shadow"):
        self.reservoir = reservoir
        self.top_k = int(top_k)
        self.name = name
        self.registry = registry if registry is not None \
            else default_registry()
        self.successes = 0
        self.trials = 0
        self.queries = 0
        self.rho_err = Welford()
        self._asym_std = Welford()
        self._codes = None
        self._codes_version = -1

    def _reservoir_codes(self, encode_fn) -> np.ndarray:
        """Reservoir rows under the engine's encoder, int32 [R, k] on the
        host, cached until the reservoir version moves."""
        if self._codes_version != self.reservoir.version:
            rows = torch.from_numpy(self.reservoir.rows())
            self._codes = _host(encode_fn(rows)).astype(np.int32)
            self._codes_version = self.reservoir.version
        return self._codes

    def observe_query(self, q_raw, encode_fn, estimator, q_codes=None):
        """One shadow check: exact-cosine top-k vs coded top-k over the
        reservoir for raw query ``q_raw`` [d]. ``encode_fn(x [m, d]) ->
        codes [m, k]`` is the engine's query encoder, ``estimator`` its
        ``CollisionEstimator``. Returns this query's recall@k, or None if
        the reservoir holds fewer than 4 top_k rows."""
        rows = self.reservoir.rows()
        k = self.top_k
        if rows.shape[0] < 4 * k:
            return None
        q = _host(q_raw).astype(np.float32).ravel()
        codes = self._reservoir_codes(encode_fn)
        if q_codes is None:
            q_codes = _host(encode_fn(torch.from_numpy(q[None, :])))[0]
        q_codes = _host(q_codes).astype(np.int32).ravel()

        # ground truth: exact cosine over the reservoir
        qn = q / max(float(np.linalg.norm(q)), 1e-30)
        norms = np.maximum(np.linalg.norm(rows, axis=1), 1e-30)
        cos = (rows @ qn) / norms
        gt = np.argsort(-cos, kind="stable")[:k]

        # system answer: coded collision-fraction ranking, same rows
        frac = np.mean(codes == q_codes[None, :], axis=1)
        got = np.argsort(-frac, kind="stable")[:k]

        hits = len(set(gt.tolist()) & set(got.tolist()))
        self.successes += hits
        self.trials += k
        self.queries += 1

        # rho audit over the ground-truth pairs: coded estimate vs the
        # exact cosine, spread vs the estimator's asymptotic std
        rho_true = np.clip(cos[gt], -1.0, 1.0)
        rho_hat = estimator(torch.from_numpy(
            frac[gt].astype(np.float32))).numpy().astype(np.float64)
        self.rho_err.push_many(rho_hat - rho_true)
        k_proj = codes.shape[1]
        for r in np.clip(rho_true, 0.0, 0.999):
            self._asym_std.push(float(estimator.asymptotic_std(float(r),
                                                               k_proj)))

        reg = self.registry
        recall = self.successes / self.trials
        lo, hi = wilson_interval(self.successes, self.trials)
        reg.gauge(f"{self.name}.recall").set(recall)
        reg.gauge(f"{self.name}.recall_lo").set(lo)
        reg.gauge(f"{self.name}.recall_hi").set(hi)
        reg.gauge(f"{self.name}.trials").set(self.trials)
        reg.gauge(f"{self.name}.rho_err_mean").set(self.rho_err.mean)
        if self.rho_err.n > 1:
            reg.gauge(f"{self.name}.rho_err_std").set(self.rho_err.std)
            reg.gauge(f"{self.name}.rho_std_theory").set(self._asym_std.mean)
        reg.counter(f"{self.name}.queries").inc()
        return hits / k

    def report(self) -> dict:
        """Running shadow health: recall@k with Wilson 95% bounds, trial
        counts, and the rho-error moments vs theory."""
        lo, hi = wilson_interval(self.successes, self.trials)
        return {
            "top_k": self.top_k,
            "queries": self.queries,
            "trials": self.trials,
            "recall": (self.successes / self.trials
                       if self.trials else math.nan),
            "recall_lo": lo, "recall_hi": hi,
            "reservoir_rows": len(self.reservoir),
            "rho_err_mean": self.rho_err.mean if self.rho_err.n else math.nan,
            "rho_err_std": self.rho_err.std,
            "rho_std_theory": (self._asym_std.mean
                               if self._asym_std.n else math.nan),
        }
