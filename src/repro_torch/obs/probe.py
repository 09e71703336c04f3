"""Known-answer canary probes: end-to-end correctness, actively tested.

Counterpart of ``repro/obs/probe.py``. The per-layer monitors
(``obs.quality``) audit *passively observed* traffic; they cannot catch
a failure that only shows on the full endpoint path — a stale result
cache serving pre-churn ids, a corrupted rank table that still produces
well-formed scores, a kernel rebuilt on the hot path. A canary probe
closes that gap: take a row whose presence in the index is *known* (it
was ingested, it is live, the shadow reservoir holds its raw vector),
replay it through the real serving endpoint, and assert the known
answer comes back.

Protocol per probe (deterministic: one seeded RNG draws rows from the
``obs.shadow.ShadowReservoir``, whose membership is itself seeded):

* **search** — the probe row's own vector goes through
  ``AnnService.probe_search`` (the real submit→flush path, result
  cache included — a stale cache is exactly what this catches). The
  known answer is the row's own external id in the top-k (self-recall
  ∈ {0, 1}); the **margin** is the returned score of the known answer
  minus the best non-answer score (a corrupted table crushes it toward
  or below 0 long before recall breaks); **latency** is the endpoint
  wall time against the probe budget (default: the service deadline).
* **classify** — when a classifier is attached, the probe row goes
  through ``AnnService.probe_classify``; the verdict is finite margins
  plus (when the caller supplies ``label_fn``) the known label.

Probe traffic is *tagged*: the service's probe endpoints run inside a
probe context that redirects per-request metrics to ``probe.*`` names,
bypasses the tail sampler, and skips quality sampling — so probes never
pollute user-facing SLO series nor perturb the seeded sampling streams
(a replayed user workload still samples identically). Every verdict is
asserted into the ``SloEngine`` quality ledger (``observe_probe``), so
failing canaries burn the quality error budget and trip the same
burn-rate alerts as bad shadow recall.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np

# an endpoint's answer (a tensor on any device, or an array) is judged on
# the host
from repro_torch.obs.quality import _host
from repro_torch.obs.registry import MetricsRegistry, default_registry

__all__ = ["ProbeConfig", "CanaryProber"]


@dataclass(frozen=True)
class ProbeConfig:
    """Knobs of the canary prober (one seeded budget)."""
    n_probes: int = 4              # rows replayed per run_once
    seed: int = 0                  # row draws (reservoir is seeded too)
    min_margin: float = 0.0        # known-answer score - best other
    latency_budget_s: float = math.nan   # default: service deadline
    min_reservoir: int = 8         # rows needed before probing starts
    classify: bool = True          # also probe classify when attached


class CanaryProber:
    """Deterministic known-answer prober over one ``AnnService``.

    ``run_once()`` draws ``n_probes`` seeded rows from the reservoir
    (the service's quality reservoir by default), replays each through
    the probe endpoints, asserts the verdicts into ``slo`` (when
    given), and returns the probe report.
    """

    def __init__(self, service, slo=None, cfg: ProbeConfig = ProbeConfig(),
                 reservoir=None, label_fn=None,
                 registry: MetricsRegistry = None):
        self.service = service
        self.slo = slo
        self.cfg = cfg
        self.label_fn = label_fn
        if reservoir is None:
            quality = getattr(service, "quality", None)
            reservoir = getattr(quality, "reservoir", None)
        if reservoir is None:
            raise ValueError(
                "no ground-truth source: pass reservoir=, or build the "
                "service with quality monitoring (quality=True) so its "
                "ShadowReservoir retains raw rows")
        self.reservoir = reservoir
        self.rng = np.random.default_rng(cfg.seed)
        self.registry = registry if registry is not None \
            else getattr(service, "registry", None) or default_registry()
        reg = self.registry
        self._c_runs = reg.counter("probe.runs")
        self._c_probes = reg.counter("probe.probes")
        self._c_failures = reg.counter("probe.failures")
        self._h_latency = reg.histogram("probe.latency_s")
        self._g_recall = reg.gauge("probe.recall")
        self._g_margin = reg.gauge("probe.margin")
        self.last_report: dict = {}

    def _budget(self) -> float:
        b = self.cfg.latency_budget_s
        if b == b:
            return b
        return float(getattr(self.service.cfg, "deadline_s", math.inf))

    # -- one probe ----------------------------------------------------------
    def _probe_search(self, ext_id: int, row: np.ndarray) -> dict:
        budget = self._budget()
        t0 = time.perf_counter()
        ids, rho = self.service.probe_search(row)
        dur = time.perf_counter() - t0
        ids = _host(ids).ravel()
        rho = _host(rho).astype(np.float64).ravel()
        self._h_latency.observe(dur)
        pos = np.flatnonzero(ids == ext_id)
        hit = pos.size > 0
        if hit:
            others = rho[np.flatnonzero(ids != ext_id)]
            margin = float(rho[pos[0]] - (others.max() if others.size
                                          else -math.inf))
        else:
            margin = -math.inf
        ok = (hit and margin >= self.cfg.min_margin and dur <= budget)
        return {"kind": "search", "id": int(ext_id), "hit": hit,
                "margin": margin, "latency_s": dur,
                "late": dur > budget, "ok": ok}

    def _probe_classify(self, ext_id: int, row: np.ndarray) -> dict:
        t0 = time.perf_counter()
        labels, margins = self.service.probe_classify(row[None, :])
        dur = time.perf_counter() - t0
        self._h_latency.observe(dur)
        finite = bool(np.all(np.isfinite(_host(margins))))
        ok = finite and dur <= self._budget()
        label = int(_host(labels).ravel()[0])
        if self.label_fn is not None:
            ok = ok and label == int(self.label_fn(ext_id))
        return {"kind": "classify", "id": int(ext_id), "label": label,
                "finite": finite, "latency_s": dur, "ok": ok}

    # -- runs ---------------------------------------------------------------
    def run_once(self, n: int = None) -> dict:
        """One probe run: draw seeded rows, replay, assert into the SLO
        engine; returns the report (also kept as ``last_report``).
        Returns ``{"skipped": ...}`` while the reservoir is too small
        to draw meaningful canaries."""
        res = self.reservoir
        if len(res) < self.cfg.min_reservoir:
            return {"skipped": f"reservoir has {len(res)} rows "
                               f"< {self.cfg.min_reservoir}"}
        n = self.cfg.n_probes if n is None else int(n)
        ids, rows = res.ids(), res.rows()
        picks = self.rng.integers(len(ids), size=n)
        probes = []
        do_classify = (self.cfg.classify
                       and getattr(self.service, "classifier", None)
                       is not None)
        for j in picks:
            p = self._probe_search(int(ids[j]), rows[j])
            probes.append(p)
            if self.slo is not None:
                self.slo.observe_probe("search", p["ok"])
            if do_classify:
                pc = self._probe_classify(int(ids[j]), rows[j])
                probes.append(pc)
                if self.slo is not None:
                    self.slo.observe_probe("classify", pc["ok"])
        hits = sum(p.get("hit", False) for p in probes
                   if p["kind"] == "search")
        n_search = sum(p["kind"] == "search" for p in probes)
        failures = sum(not p["ok"] for p in probes)
        margins = [p["margin"] for p in probes
                   if p["kind"] == "search" and math.isfinite(p["margin"])]
        report = {
            "probes": len(probes),
            "recall": hits / max(n_search, 1),
            "failures": failures,
            "margin_mean": (float(np.mean(margins)) if margins
                            else math.nan),
            "max_latency_s": max(p["latency_s"] for p in probes),
            "ok": failures == 0,
            "detail": probes,
        }
        self._c_runs.inc()
        self._c_probes.inc(len(probes))
        self._c_failures.inc(failures)
        self._g_recall.set(report["recall"])
        if report["margin_mean"] == report["margin_mean"]:
            self._g_margin.set(report["margin_mean"])
        if self.slo is not None:
            self.slo.tick()
        self.last_report = report
        return report
