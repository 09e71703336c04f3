"""Online statistical-health monitors: empirical vs. theory, live.

Counterpart of ``repro/obs/quality.py``. The paper's argument is
statistical: coded collision rates follow the closed-form curves of
``core.probabilities`` and the contingency-cell model of
``core.estimators``. A served index can stop satisfying those contracts
(input drift, a mis-seeded R, a packing fault, stale rank tables) while
every latency gauge stays green; these monitors watch for it.

``CollisionMonitor``
    Pools sampled query-candidate code pairs: a count vector over the
    scheme's code contingency table and Welford moments of each pair's
    collision fraction. A batch is reduced on the codes' device (one
    ``torch.bincount`` and one mean); only the n_codes^2 counts and the
    [m] fractions cross to the host, where the counts pool in exact
    int64. ``report()`` re-estimates rho by maximum likelihood over the
    pooled counts (grid argmax over the float64 ``cell_probs`` table)
    and compares the empirical cells with the model at that rho: per-cell
    z-scores, a chi-square divergence, the diagonal collision fraction
    against ``collision_prob``, all mirrored into registry gauges. The
    ``offset`` scheme has no shared cell table (its regions are
    per-projection) and falls back to the match/mismatch diagonal.
    Live traffic pools pairs of different rho, so the pooled table is a
    mixture and its divergence has a nonzero baseline: the gauges are
    series whose level ``obs.drift`` tracks.

``MarginMonitor``
    Welford moments of classifier margins (the binary margin, or the
    top-minus-second gap one-vs-rest).

``QualityMonitors``
    The bundle the engines, the trainer and the service share: one
    sampling budget (``QualityConfig.sample_rate``), one seeded
    ``np.random.default_rng(cfg.seed)`` drawn in the reference's order
    (so a replayed workload samples the same requests in both packages),
    a ``CollisionMonitor`` on the engine's scheme, the shadow recall
    monitor (``obs.shadow``), a ``MarginMonitor`` and a
    ``DriftMonitor`` over the monitored series. Everything, sampling
    included, does nothing while the registry is disabled.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.estimators import cell_probs, region_bounds
from repro_torch.core.probabilities import collision_prob
from repro_torch.core.schemes import CodeSpec, collision_fraction, encode
from repro_torch.obs.drift import DriftMonitor, PageHinkley
from repro_torch.obs.registry import MetricsRegistry, default_registry

__all__ = ["QualityConfig", "Welford", "CollisionMonitor", "MarginMonitor",
           "QualityMonitors", "synthetic_code_pairs"]


def _host(x) -> np.ndarray:
    """A tensor (any device) or an array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _int32(x) -> torch.Tensor:
    """Codes as an int32 tensor: a tensor stays on its device, an array
    is copied to the host (it may be a read-only view)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    return torch.from_numpy(np.array(x, np.int32))


@dataclass(frozen=True)
class QualityConfig:
    """Knobs of the quality-monitoring layer (one sampling budget)."""
    sample_rate: float = 0.01      # fraction of requests monitored
    pairs_per_query: int = 8       # code pairs fed per sampled search
    min_pairs: int = 256           # pooled pairs before z/chi2 gauges report
    reservoir_rows: int = 1024     # shadow reservoir cap (raw f32 rows)
    shadow_top_k: int = 10         # recall@k of the shadow ground truth
    margin_sample: int = 512       # margins monitored per observed batch
    grid_size: int = 512           # rho grid of the MLE/cell-prob table
    seed: int = 0                  # one seeded stream for every decision
    drift_delta: float = 0.002     # Page-Hinkley slack of the series
    drift_threshold: float = 0.25  # Page-Hinkley evidence to fire


class Welford:
    """Streaming mean/variance (Welford's online moments), O(1) state."""

    __slots__ = ("n", "mean", "_m2")

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self._m2 = 0.0

    def push(self, x: float):
        """Fold one observation into the moments."""
        x = float(x)
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self._m2 += d * (x - self.mean)

    def push_many(self, xs):
        """Fold an iterable of observations."""
        for x in np.asarray(xs, np.float64).ravel():
            self.push(x)

    @property
    def var(self) -> float:
        """Sample variance (ddof=1); nan below two observations."""
        return self._m2 / (self.n - 1) if self.n > 1 else math.nan

    @property
    def std(self) -> float:
        """Sample standard deviation; nan below two observations."""
        v = self.var
        return math.sqrt(v) if v == v else math.nan


def synthetic_code_pairs(spec: CodeSpec, k: int, rho: float, m: int,
                         seed: int = 0, q=None):
    """``m`` code pairs [m, k] at exact correlation ``rho`` (Lemma 1's
    construction): x = z1, y = rho z1 + sqrt(1 - rho^2) z2 with z1, z2
    iid N(0, 1) drawn by numpy as the reference draws them, both coded
    under ``spec`` (``q``: offsets of the offset scheme). Returns
    (codes_x, codes_y) int32 numpy arrays."""
    rng = np.random.default_rng(seed)
    z1 = rng.standard_normal((m, k)).astype(np.float32)
    z2 = rng.standard_normal((m, k)).astype(np.float32)
    y = rho * z1 + math.sqrt(max(0.0, 1.0 - rho * rho)) * z2
    return (encode(torch.from_numpy(z1), spec, q).numpy(),
            encode(torch.from_numpy(y), spec, q).numpy())


class CollisionMonitor:
    """Empirical collision/cell frequencies vs. theory at the MLE rho.

    Feed sampled code pairs with ``observe_pairs``; read pooled health
    with ``report()`` (also mirrored into registry gauges under
    ``<name>.*``).
    """

    def __init__(self, spec: CodeSpec, k: int, *,
                 registry: MetricsRegistry = None,
                 name: str = "quality.collision", grid_size: int = 512,
                 min_pairs: int = 256, rho_max: float = 0.99995):
        self.spec = spec
        self.k = int(k)
        self.name = name
        self.min_pairs = int(min_pairs)
        self.registry = registry if registry is not None \
            else default_registry()
        self._rho_grid = np.linspace(0.0, rho_max, grid_size)
        rho = torch.from_numpy(self._rho_grid)
        try:
            self.n_codes = len(region_bounds(spec))
            # [G, C] cell-probability table, C = n_codes^2 (row-major)
            self._probs = cell_probs(rho, spec).numpy().reshape(
                grid_size, -1)
            self.diag_only = False
        except ValueError:
            # offset scheme: per-projection regions, so only the
            # match/mismatch diagonal is audited
            self.n_codes = 0
            p = collision_prob(rho, spec.w, spec.scheme).numpy()
            self._probs = np.stack([p, 1.0 - p], axis=1)
            self.diag_only = True
        self._logp = np.log(np.maximum(self._probs, 1e-30))
        self._diag_idx = (None if self.diag_only else
                          np.arange(self.n_codes) * (self.n_codes + 1))
        self.counts = np.zeros(self._probs.shape[1], np.int64)
        self.pairs = 0
        self.frac = Welford()
        reg = self.registry
        self._c_pairs = reg.counter(f"{name}.pairs")
        self._c_batches = reg.counter(f"{name}.batches")

    def _batch(self, a: torch.Tensor, b: torch.Tensor):
        """Device-side reduction of one batch: (cell counts, per-pair
        collision fractions), on the codes' device."""
        frac = collision_fraction(a, b)
        if self.diag_only:
            match = (a == b).sum()
            return torch.stack([match, a.numel() - match]), frac
        n = self.n_codes
        cells = (a.to(torch.int64) * n + b).reshape(-1)
        return torch.bincount(cells, minlength=n * n), frac

    def observe_pairs(self, codes_a, codes_b) -> dict:
        """Fold one batch of code pairs [m, k] (tensors on any device, or
        arrays) into the pooled accumulators; returns the batch-local
        stats {p_batch, rho_batch} (the per-batch drift series; pooled
        stats live in ``report()``)."""
        a = _int32(codes_a)
        b = _int32(codes_b).to(a.device)
        counts, frac = self._batch(a, b)
        counts = _host(counts).astype(np.int64)
        frac = _host(frac).astype(np.float64)
        self.counts += counts
        self.pairs += frac.size
        self.frac.push_many(frac)
        self._c_pairs.inc(frac.size)
        self._c_batches.inc()
        return {"p_batch": float(frac.mean()),
                "rho_batch": self._mle(counts)}

    def _mle(self, counts: np.ndarray) -> float:
        """Grid MLE over a count vector (host matvec on the log table)."""
        return float(self._rho_grid[int(np.argmax(counts @ self._logp.T))])

    def report(self) -> dict:
        """Pooled empirical-vs-theory health, mirrored into gauges.

        Keys: pairs, rho_hat (pooled MLE), p_hat / p_theory (diagonal
        collision fraction, empirical vs. the curve at rho_hat), z_diag,
        z_max (worst cell), chi2 / chi2_per_cell, phat_std /
        phat_std_theory (per-pair collision-fraction spread vs. the
        binomial sqrt(p(1-p)/k)), cell_freq (empirical [C]). Gauges
        update once ``min_pairs`` pairs have pooled.
        """
        n_obs = int(self.counts.sum())
        out = {"pairs": self.pairs, "scheme": self.spec.scheme}
        if n_obs == 0:
            out.update(rho_hat=math.nan, p_hat=math.nan, chi2=math.nan)
            return out
        rho_hat = self._mle(self.counts)
        gi = int(np.searchsorted(self._rho_grid, rho_hat))
        gi = min(gi, len(self._rho_grid) - 1)
        exp_p = self._probs[gi]
        obs_f = self.counts / n_obs
        if self.diag_only:
            p_hat, p_theory = obs_f[0], exp_p[0]
        else:
            p_hat = float(obs_f[self._diag_idx].sum())
            p_theory = float(exp_p[self._diag_idx].sum())
        sd_diag = math.sqrt(max(p_theory * (1 - p_theory), 1e-30) / n_obs)
        live = exp_p > 1e-12
        z = (obs_f[live] - exp_p[live]) / np.sqrt(
            exp_p[live] * (1 - exp_p[live]) / n_obs)
        chi2 = float(np.sum(
            (self.counts[live] - n_obs * exp_p[live]) ** 2
            / (n_obs * exp_p[live])))
        n_cells = int(live.sum())
        out.update(
            rho_hat=rho_hat, p_hat=float(p_hat), p_theory=float(p_theory),
            z_diag=float((p_hat - p_theory) / sd_diag),
            z_max=float(np.abs(z).max()), chi2=chi2,
            chi2_per_cell=chi2 / max(n_cells, 1), n_cells=n_cells,
            phat_std=self.frac.std,
            phat_std_theory=math.sqrt(
                max(p_theory * (1 - p_theory), 0.0) / self.k),
            cell_freq=obs_f)
        if self.pairs >= self.min_pairs:
            reg = self.registry
            for key in ("rho_hat", "p_hat", "p_theory", "z_diag", "z_max",
                        "chi2", "chi2_per_cell", "phat_std",
                        "phat_std_theory"):
                v = out[key]
                if v == v:              # skip nan (empty Welford)
                    reg.gauge(f"{self.name}.{key}").set(v)
        return out

    def reset(self):
        """Drop the pooled accumulators (counts, pairs, moments)."""
        self.counts[:] = 0
        self.pairs = 0
        self.frac = Welford()


class MarginMonitor:
    """Welford moments over classifier decision margins.

    Binary models contribute the signed margin; one-vs-rest models the
    top-minus-second gap. Mirrors ``<name>.mean`` / ``.std`` / ``.n``
    gauges; the per-batch mean is the drift series.
    """

    def __init__(self, registry: MetricsRegistry = None,
                 name: str = "quality.margin", max_rows: int = 512):
        self.registry = registry if registry is not None \
            else default_registry()
        self.name = name
        self.max_rows = int(max_rows)
        self.moments = Welford()

    def observe(self, margins) -> float:
        """Fold one margin batch [C, m] (a tensor on any device, or an
        array); returns the batch mean (nan on an empty batch)."""
        m = _host(margins).astype(np.float64)
        if m.ndim == 1:
            m = m[None, :]
        vals = (m[0] if m.shape[0] == 1
                else np.sort(m, axis=0)[-1] - np.sort(m, axis=0)[-2])
        vals = vals[: self.max_rows]
        if vals.size == 0:
            return math.nan
        self.moments.push_many(vals)
        reg = self.registry
        reg.gauge(f"{self.name}.mean").set(self.moments.mean)
        if self.moments.n > 1:
            reg.gauge(f"{self.name}.std").set(self.moments.std)
        reg.gauge(f"{self.name}.n").set(self.moments.n)
        return float(vals.mean())


class QualityMonitors:
    """The quality bundle the serving layer threads through the system.

    One ``sample()`` budget gates every monitor; the sub-monitors share
    the registry and one seeded RNG. ``observe_search`` is the engines'
    hook, ``maybe_shadow``/``shadow_check`` the serving flush hook,
    ``observe_margins`` the classify and trainer hook, ``offer_rows``
    the ingest hook and ``on_store_event`` the segment-log listener (a
    tombstone-aware reservoir). ``on_drift(cb)`` subscribes a drift-alarm
    callback.
    """

    #: drift series names fed by this bundle
    SERIES = ("collision_p", "collision_chi2", "shadow_recall",
              "margin_mean")

    def __init__(self, sketcher, cfg: QualityConfig = QualityConfig(), *,
                 registry: MetricsRegistry = None,
                 drift: DriftMonitor = None):
        from repro_torch.obs.shadow import RecallMonitor, ShadowReservoir

        self.cfg = cfg
        self.sketcher = sketcher
        self.registry = registry if registry is not None \
            else default_registry()
        self.rng = np.random.default_rng(cfg.seed)
        self.collision = CollisionMonitor(
            sketcher.spec, sketcher.cfg.k, registry=self.registry,
            grid_size=cfg.grid_size, min_pairs=cfg.min_pairs)
        self.reservoir = ShadowReservoir(cap=cfg.reservoir_rows,
                                         seed=cfg.seed,
                                         registry=self.registry)
        self.recall = RecallMonitor(self.reservoir, top_k=cfg.shadow_top_k,
                                    registry=self.registry)
        self.margins = MarginMonitor(registry=self.registry,
                                     max_rows=cfg.margin_sample)
        if drift is None:
            drift = DriftMonitor(
                registry=self.registry,
                detector_factory=lambda: PageHinkley(
                    delta=cfg.drift_delta, threshold=cfg.drift_threshold))
        self.drift = drift
        for series in self.SERIES:
            self.drift.detector(series)
        self._c_sampled = self.registry.counter("quality.sampled")
        self._c_skipped_sparse = self.registry.counter(
            "quality.reservoir_skipped_sparse")

    @property
    def enabled(self) -> bool:
        """Whether the monitors do anything (tracks the registry)."""
        return self.registry.enabled

    def sample(self) -> bool:
        """One budgeted coin flip from the seeded stream; always False
        while the registry is disabled."""
        if not self.registry.enabled:
            return False
        if self.rng.random() >= self.cfg.sample_rate:
            return False
        self._c_sampled.inc()
        return True

    def on_drift(self, callback) -> "QualityMonitors":
        """Subscribe ``callback(series, value, detector)`` to drift
        alarms on any monitored series; returns self."""
        self.drift.subscribe(callback)
        return self

    # -- engine hook ---------------------------------------------------------
    def observe_search(self, q_codes, ids, codes_for_ids):
        """Engine hook: budgeted audit of one search batch.

        Samples one query row, gathers the codes of its top
        ``pairs_per_query`` result ids with ``codes_for_ids(ids) ->
        [m, k]`` and feeds the collision monitor and the drift series.
        When the sample does not fire it costs one RNG draw; only a
        sampled call reads the result row back to the host.
        """
        if not self.sample():
            return
        qi = int(self.rng.integers(q_codes.shape[0]))
        row = _host(ids[qi])
        row = row[row >= 0][: self.cfg.pairs_per_query]
        if row.size == 0:
            return
        q_codes = torch.as_tensor(q_codes)
        cand = torch.as_tensor(codes_for_ids(row), device=q_codes.device)
        qc = q_codes[qi][None, :].expand(cand.shape)
        batch = self.collision.observe_pairs(qc, cand)
        rep = self.collision.report()
        self.drift.update("collision_p", batch["p_batch"])
        if self.collision.pairs >= self.cfg.min_pairs:
            self.drift.update("collision_chi2", rep["chi2_per_cell"])

    # -- serving hooks -------------------------------------------------------
    def shadow_check(self, q_raw, encode_fn, q_codes=None):
        """Ungated shadow ground-truth check of one raw query vector
        (``obs.shadow.RecallMonitor``); feeds the ``shadow_recall`` drift
        series. Hot paths gate with ``sample()`` first (or call
        ``maybe_shadow``). Returns the query's recall@k or None."""
        if not self.registry.enabled:
            return None
        r = self.recall.observe_query(q_raw, encode_fn,
                                      self.sketcher._estimator,
                                      q_codes=q_codes)
        if r is not None:
            self.drift.update("shadow_recall", r)
        return r

    def maybe_shadow(self, q_raw, encode_fn, q_codes=None):
        """Serving flush hook: one budgeted coin flip, then
        ``shadow_check``."""
        if not self.sample():
            return None
        return self.shadow_check(q_raw, encode_fn, q_codes=q_codes)

    def observe_margins(self, margins):
        """Classify/trainer hook (callers gate with ``sample()`` on hot
        paths): fold a margin batch, feed the ``margin_mean`` series."""
        if not self.registry.enabled:
            return
        m = self.margins.observe(margins)
        if m == m:
            self.drift.update("margin_mean", m)

    # -- reservoir upkeep ----------------------------------------------------
    def offer_rows(self, ids, x):
        """Ingest hook: offer raw dense rows [m, D] (a tensor on any
        device, or an array) to the shadow reservoir; sparse inputs are
        skipped and counted, never an error."""
        if not self.registry.enabled:
            return
        if not hasattr(x, "ndim"):
            x = np.asarray(x)
        if getattr(x, "ndim", None) != 2:     # CsrMatrix etc.
            self._c_skipped_sparse.inc()
            return
        self.reservoir.offer(_host(ids), x)

    def on_store_event(self, event: str, ids):
        """Segment-log listener: deletes drop their rows from the
        reservoir; compaction changes nothing (external ids are
        stable)."""
        if event == "delete" and ids is not None:
            self.reservoir.remove(ids)

    # -- one-call view -------------------------------------------------------
    def report(self) -> dict:
        """Pooled health of every monitor as one plain dict."""
        rep = self.collision.report()
        rep.pop("cell_freq", None)
        return {"collision": rep,
                "shadow": self.recall.report(),
                "margin": {"mean": self.margins.moments.mean,
                           "std": self.margins.moments.std,
                           "n": self.margins.moments.n},
                "drift": {s: {"stat": self.drift.detector(s).stat,
                              "alarms": self.drift.alarms(s)}
                          for s in self.SERIES}}
