"""Port parity for the rest of the health layer: ``repro_torch.obs`` slo,
resources, incident, probe and dashboard, and their wiring into
``AnnService`` (``slo=``, ``resources=``, ``incidents=``).

Both packages get the same seeded streams on one fake clock, so every
comparison is exact: the alert series, the clock time each fires at,
``health()`` and ``budgets()`` (burn rates, budgets, sparklines) of the
three drills of ``scripts/slo_selftest.py`` and the recompile drill of
``tests/test_health.py``; the rendered text and page of one snapshot; a
resource monitor's tracked bytes; incident bundles. The services run at
``tests/test_health.py``'s size (D = 16, K = 16, 2-bit, ``BandSpec(4,
4)``, tail of 64 rows) over engines that share R (``convert``); canary
reports are equal but for the margins, held within 1e-6 (the same
integer counts, scaled in float32).
"""
import _ctypes
import copy
import math
import os
import stat

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.obs as J
from repro.core.sketch import CodedRandomProjection as JaxCRP
from repro.core.sketch import SketchConfig as JaxCfg
from repro.ann import BandSpec as JaxBands
from repro.ann import CodeStore as JaxStore
from repro.index import MutableAnnEngine as JaxMutable
from repro.obs.quality import QualityConfig as JaxQualityConfig
from repro.serve import AnnService as JaxService
from repro.serve import AnnServiceConfig as JaxServiceCfg

import repro_torch.obs as T
from repro_torch import convert
from repro_torch.ann import BandSpec
from repro_torch.core.sketch import SketchConfig
from repro_torch.index import MutableAnnEngine
from repro_torch.kernels import _build
from repro_torch.obs import incident as tincident
from repro_torch.obs import kernelstats as tks
from repro_torch.obs.quality import QualityConfig
from repro_torch.serve import AnnService, AnnServiceConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; torch's intra-op threads would
    compete with them, so this file runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


D, K = 16, 16


class _Clock:
    """Injectable fake clock driving deterministic drills."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _FakeResources:
    """ResourceMonitor stand-in exposing only the compile counter."""

    def __init__(self):
        self.compiles = 0

    def jit_compiles(self):
        return self.compiles


def _engine(obs, clock):
    reg = obs.MetricsRegistry()
    slo = obs.SloEngine(registry=reg, clock=clock, resolution=1.0)
    slo.add(obs.SloSpec("search", latency_hist="serve.flush_s",
                        latency_target_s=0.050,
                        error_counter="serve.flush_errors",
                        quality_min=0.8))
    fired = []
    slo.subscribe(lambda series, value, det: fired.append(
        (clock.t, series, value, det.side, det.alarms, det.stat)))
    return reg, slo, fired


def _stationary(reg, slo, clock, rng, seconds, qps=40):
    h = reg.histogram("serve.flush_s")
    for _ in range(seconds):
        for v in rng.lognormal(math.log(0.025), 0.25, size=qps):
            h.observe(float(v))
        if rng.random() < 0.3:
            slo.observe_quality("search", float(rng.uniform(0.85, 1.0)))
        clock.t += 1.0
        slo.tick()


def _step(reg, slo, clock, fired, seconds, late_s, quality=None,
          stop=True):
    h = reg.histogram("serve.flush_s")
    for _ in range(seconds):
        for _ in range(40):
            h.observe(late_s)
        if quality is not None:
            for _ in range(3):
                slo.observe_quality("search", quality)
        clock.t += 1.0
        slo.tick()
        if fired and stop:
            break


# the scenarios of scripts/slo_selftest.py, plus the latency step of
# tests/test_health.py run on through its recovery
def _drill_stationary(obs, seed):
    clock = _Clock()
    reg, slo, fired = _engine(obs, clock)
    _stationary(reg, slo, clock, np.random.default_rng(seed), 400)
    return fired, slo


def _drill_latency_step(obs, seed):
    clock = _Clock()
    reg, slo, fired = _engine(obs, clock)
    _stationary(reg, slo, clock, np.random.default_rng(seed), 90)
    _step(reg, slo, clock, fired, 120, 0.100)
    return fired, slo


def _drill_recall_drop(obs, seed):
    clock = _Clock()
    reg, slo, fired = _engine(obs, clock)
    _stationary(reg, slo, clock, np.random.default_rng(seed), 90)
    _step(reg, slo, clock, fired, 120, 0.025, quality=0.1)
    return fired, slo


def _drill_step_and_recovery(obs, seed):
    clock = _Clock()
    reg, slo, fired = _engine(obs, clock)
    _stationary(reg, slo, clock, np.random.default_rng(seed), 90)
    _step(reg, slo, clock, fired, 60, 0.080)
    _step(reg, slo, clock, fired, 120, 0.040, stop=False)
    return fired, slo


def _drill_recompile(obs, seed):
    clock = _Clock()
    slo = obs.SloEngine(registry=obs.MetricsRegistry(), clock=clock,
                        resolution=1.0)
    res = _FakeResources()
    slo.attach_resources(res)
    fired = []
    slo.subscribe(lambda series, value, det: fired.append(
        (clock.t, series, value, det.side, det.alarms, det.stat)))
    res.compiles = 17 + seed             # warm-up compiles are free
    slo.mark_steady()
    for _ in range(90):
        clock.t += 1.0
        slo.tick()
    for _ in range(60):                  # the hot path starts compiling
        res.compiles += 1
        clock.t += 1.0
        slo.tick()
        if fired:
            break
    return fired, slo


DRILLS = {"stationary": _drill_stationary,
          "latency_step": _drill_latency_step,
          "recall_drop": _drill_recall_drop,
          "step_and_recovery": _drill_step_and_recovery,
          "recompile": _drill_recompile}
# what each drill must show (scripts/slo_selftest.py's and
# tests/test_health.py's pass rules): the first alert's series, or none
FIRST_ALERT = {"stationary": None, "latency_step": "slo.search.latency",
               "recall_drop": "slo.search.quality",
               "step_and_recovery": "slo.search.latency",
               "recompile": "slo.runtime.recompile"}
FINAL_STATUS = {"stationary": "ok", "latency_step": "degraded",
                "recall_drop": "degraded", "step_and_recovery": "ok",
                "recompile": "degraded"}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("drill", list(DRILLS))
def test_slo_drills_match_reference(drill, seed):
    """Alerts (series, the clock time each fires at, value, detector
    state), ``health()`` and ``budgets()`` equal between the packages,
    and the drill's own pass rule holds."""
    t_fired, t_slo = DRILLS[drill](T, seed)
    j_fired, j_slo = DRILLS[drill](J, seed)
    assert t_fired == j_fired
    assert t_slo.health() == j_slo.health()
    assert t_slo.budgets() == j_slo.budgets()
    series = [f[1] for f in t_fired]
    if FIRST_ALERT[drill] is None:
        assert series == []
    else:
        assert series[0] == FIRST_ALERT[drill] and len(series) == 1
        assert t_fired[0][0] <= 90.0 + 60.0, "outside the fast window"
    assert t_slo.health()["status"] == FINAL_STATUS[drill]


def test_histogram_edges_and_slo_units_match_reference():
    """The latency ledgers read histogram buckets, so parity rests on the
    port's bucket edges being the reference's; the small units of the
    engine (no-floor quality, probe verdicts, the snapshot ring) agree."""
    ts, js = T.HistogramSpec(), J.HistogramSpec()
    assert ts._edges == js._edges and ts.n_buckets == js.n_buckets
    for v in (1e-7, 0.049, 0.050, 0.0501, 3.0, 5e4):
        assert ts.bucket_index(v) == js.bucket_index(v)
    for obs in (T, J):
        slo = obs.SloEngine(registry=obs.MetricsRegistry(), clock=_Clock())
        slo.add(obs.SloSpec("classify", latency_hist="serve.classify_s"))
        slo.observe_quality("classify", 0.1)   # NaN floor: a no-op
        assert "classify.quality" not in slo.ledgers
        slo.observe_probe("classify", False)
        led = slo.ledgers["classify.quality"]
        assert (led.total, led.bad) == (1, 1)
    rings = []
    for obs in (T, J):
        clock = _Clock()
        slo = obs.SloEngine(registry=obs.MetricsRegistry(), clock=clock)
        led = slo.ledger("x", 0.99)
        for i in range(3000):
            led.push(i % 10 != 0)
            if i % 10 == 9:
                clock.t += 1.0
                slo.tick(force=True)
        assert len(led.ring) <= 600 + 2
        rings.append((list(led.ring), led.window_rate(clock.t, 60.0)))
    assert rings[0] == rings[1]
    with pytest.raises(ValueError, match="objective"):
        T.SloEngine(registry=T.MetricsRegistry()).ledger("bad", 1.0)


# -- dashboard -------------------------------------------------------------------------

class _Quality:
    def report(self):
        return {"collision": {"rho_hat": 0.5, "pairs": 12},
                "recall": math.nan}


def _snapshot():
    """A snapshot with every section: a degraded SLO (an active alert, a
    shed fraction), latency series, resources, a roofline of three
    families, a quality report and a flight tail."""
    fired, slo = _drill_latency_step(T, 0)
    fr = T.FlightRecorder(capacity=8)
    for i in range(10):
        fr.record("serve.search", 1.0 + i, 1.0 + i + 1e-3 * i, batch=4,
                  trace_id=0xabcdef0123 * i)
    rm = T.ResourceMonitor(registry=slo.registry)
    rm.track("engine.store", type("S", (), {"nbytes": 3 << 20})())
    ks = tks.KernelStats()
    ks.record("packed_topk", q=256, n=4_194_304, w=16, top_k=10)
    ks.record("pack_codes", m=256, k=256, w=16)
    ks.record("coded_project", m=64, d=1024, k=256)
    return T.gather(registry=slo.registry, slo=slo, flight=fr,
                    quality=_Quality(), resources=rm, kernels=ks)


def test_dashboard_renders_like_reference(tmp_path):
    """One snapshot renders to the same text and page in both packages.
    The port's roofline rows read the ``hbm_bytes`` its kernel stats
    record (the reference reads a ``bytes`` key its stats never write),
    so the reference is handed the same rows with ``bytes`` added."""
    snap = _snapshot()
    assert set(snap) == {"registry", "health", "flight", "quality",
                         "resources", "roofline"}
    assert snap["health"]["status"] == "degraded"
    ref = copy.deepcopy(snap)
    for row in ref["roofline"].values():
        row["bytes"] = row["hbm_bytes"]
    txt = T.render_text(snap)
    assert txt == J.render_text(ref)
    assert "== health: DEGRADED" in txt and "ALERT" in txt
    assert "packed_topk" in txt and "3.0MiB" in txt
    page = T.render_html(snap)
    assert page == J.render_html(ref)
    assert page.startswith("<!doctype html>") and "<script" not in page
    # the roofline is the H100 model's
    hw = tks.HW()
    for fam, r in snap["roofline"].items():
        assert r["t_model_s"] == max(r["flops"] / hw.peak_flops,
                                     r["hbm_bytes"] / hw.hbm_bw)
    path = tmp_path / "dash" / "index.html"
    assert T.write_dashboard(str(path), snap) == str(path)
    assert path.read_text(encoding="utf-8") == page
    assert [p.name for p in path.parent.iterdir()] == ["index.html"]
    # sections are optional
    reg = T.MetricsRegistry()
    reg.histogram("h").observe(0.01)
    bare = T.gather(registry=reg, kernels=tks.KernelStats())
    assert set(bare) == {"registry", "roofline"} and not bare["roofline"]
    assert T.render_text(bare) == J.render_text(bare)
    assert T.render_html(bare) == J.render_html(bare)


# -- resources -------------------------------------------------------------------------

def test_resource_monitor_tracks_the_same_bytes():
    """Tracked bytes and their gauges equal for the same store, model and
    callable; on the CPU the device section stays empty and CUDA stays
    uninitialised."""
    words = np.random.default_rng(5).integers(
        0, 2 ** 32, (100, 1), dtype=np.uint64).astype(np.uint32)
    stores = {T: convert.store_from_numpy(words, K, 2, device="cpu"),
              J: JaxStore.from_words(words, K, 2)}
    outs = {}
    for obs, store in stores.items():
        reg = obs.MetricsRegistry()
        rm = obs.ResourceMonitor(registry=reg)
        rm.track("store", store).track("fn", lambda: 1024.0)
        rm.track("model", type("M", (), {"nbytes": 4096})())
        rm.track("broken", lambda: 1 / 0)
        out = rm.collect()
        gauges = {k: v for k, v in reg.snapshot()["gauges"].items()
                  if k.startswith("resources.bytes.")}
        outs[obs] = (out["tracked_total"], gauges,
                     {k: v for k, v in out["tracked"].items()
                      if k != "broken"})
        assert math.isnan(out["tracked"]["broken"])
        assert np.isfinite(out["host"]["rss_bytes"])
        rm.untrack("fn")
        assert rm.collect()["tracked_total"] == 400.0 + 4096.0
    assert outs[T] == outs[J]
    assert outs[T][0] == 400.0 + 1024.0 + 4096.0
    out = T.ResourceMonitor(registry=T.MetricsRegistry()).collect()
    assert out["device"] == {} and not torch.cuda.is_initialized()
    assert out["jit_compiles"] == _build.COMPILES


def test_build_all_counts_its_nvcc_calls(tmp_path, monkeypatch):
    """``jit_compiles()`` is the count of ``nvcc`` calls ``build_all``
    made: one a source on a cold build directory, none when the libraries
    are there; the SLO's recompile ledger burns one trial a compile. The
    compiler is a stand-in script that copies a shared library."""
    lib = _ctypes.__file__          # a shared library ctypes can load
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nout=""\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then out="$2"; fi\n  shift\n'
                    f'done\ncp "{lib}" "$out"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "COMPILES", 0)
    clock = _Clock()
    rm = T.ResourceMonitor(registry=T.MetricsRegistry())
    slo = T.SloEngine(registry=rm.registry, clock=clock).attach_resources(rm)
    assert rm.mark() == 0
    slo.mark_steady()
    assert set(_build.build_all()) == set(_build.SOURCES)
    n = len(_build.SOURCES)
    assert T.jit_compiles() == rm.compiles_since_mark == n
    clock.t += 1.0
    slo.tick()
    led = slo.ledgers["runtime.recompile"]
    assert (led.total, led.bad) == (n, n)
    assert _build.build_all() == {} and T.jit_compiles() == n
    assert rm.collect()["compiles_since_mark"] == n
    assert sorted(os.listdir(tmp_path / "kernels")) == sorted(
        _build._target(s).name for s in _build.SOURCES)


# -- incidents -------------------------------------------------------------------------

def test_incident_bundles_hold_tensors_and_load_in_both_packages(tmp_path):
    """Tensors (0-d or not, any dtype) in a context become plain values; a
    bundle written by either package loads in the other; a capture never
    raises into the caller."""
    f = tincident._jsonable
    assert f(torch.tensor(3)) == 3 and f(torch.tensor(2.5)) == 2.5
    assert f(torch.arange(3, dtype=torch.int32)) == [0, 1, 2]
    assert f(torch.ones((2, 2), dtype=torch.bfloat16)) == [[1.0, 1.0]] * 2
    assert f(np.float32(1.5)) == 1.5 and f(np.arange(2)) == [0, 1]
    assert f(object).startswith("<class")
    ctx = {"t": torch.arange(3), "s": torch.tensor(0.5),
           "n": np.int64(7), "a": np.ones(2, np.float32)}
    want = {"t": [0, 1, 2], "s": 0.5, "n": 7, "a": [1.0, 1.0]}
    t_dir, j_dir = str(tmp_path / "t"), str(tmp_path / "j")
    tm = T.IncidentManager(t_dir, registry=T.MetricsRegistry(),
                           flight=T.FlightRecorder(capacity=4),
                           generation_fn=lambda: 3, keep=2)
    for i in range(3):
        assert tm.capture("drift", f"r{i}", ctx).endswith(f"step_{i + 1}")
    jm = J.IncidentManager(j_dir, registry=J.MetricsRegistry(),
                           flight=J.FlightRecorder(capacity=4),
                           generation_fn=lambda: 3)
    jm.capture("drift", "r", {"n": 7})
    assert tm.steps() == [2, 3]
    got = J.IncidentManager(t_dir).load()
    assert got == tm.load() and got["context"] == want
    assert (got["kind"], got["reason"], got["incident"], got["generation"]) \
        == ("drift", "r2", 3, 3)
    assert T.IncidentManager(j_dir).load() == jm.load()
    with pytest.raises(KeyError):
        T.IncidentManager(str(tmp_path / "none")).load()

    class Broken:
        def report(self):
            raise RuntimeError("broken monitor")
    bad = T.IncidentManager(str(tmp_path / "b"), quality=Broken(),
                            registry=T.MetricsRegistry())
    assert bad.capture("error", "x") == ""
    assert bad.registry.counters["obs.incident.capture_errors"].value == 1


# -- the service -----------------------------------------------------------------------

def _sketchers():
    cfg = dict(k=K, scheme="2bit", w=0.75)
    jc = JaxCRP(JaxCfg(**cfg), D)
    tc = convert.sketch_from_numpy(
        SketchConfig(**cfg), D, np.asarray(jc.stream_encoder().r_matrix()),
        device="cpu")
    return jc, tc


_PKG = {
    "torch": (T, MutableAnnEngine, BandSpec, AnnService, AnnServiceConfig,
              QualityConfig, lambda x: x),
    "jax": (J, JaxMutable, JaxBands, JaxService, JaxServiceCfg,
            JaxQualityConfig, jnp.asarray),
}


def _service(pkg, crp, tmp_path, clock, cache_size=16, quality=True,
             **kw):
    """``tests/test_health.py``'s service, with an injected SLO engine on
    ``clock``: 48 random rows added."""
    obs, Mutable, Bands, Service, Cfg, QCfg, arr = _PKG[pkg]
    eng = Mutable(crp, band_spec=Bands(n_tables=4, band_width=4),
                  tail_rows=64)
    reg = obs.MetricsRegistry()
    svc = Service(
        eng, Cfg(top_k=5, buckets=(4,), cache_size=cache_size,
                 deadline_s=30.0),
        registry=reg, flight=obs.FlightRecorder(capacity=256),
        sampler=obs.TailSampler(min_count=2, quantile=0.5, registry=reg),
        quality=(QCfg(sample_rate=0.5, reservoir_rows=64) if quality
                 else None),
        incidents=str(tmp_path / pkg / "incidents"),
        slo=obs.SloEngine(registry=reg, clock=clock, resolution=1.0),
        resources=True, **kw)
    rng = np.random.default_rng(3)
    svc.add(arr(np.asarray(rng.normal(size=(48, D)), np.float32)))
    return svc, rng, arr


def _same_reports(got, want):
    for key in ("probes", "recall", "failures", "ok"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["margin_mean"], want["margin_mean"],
                               atol=1e-6)
    assert len(got["detail"]) == len(want["detail"])
    for g, w in zip(got["detail"], want["detail"]):
        for key in ("kind", "id", "hit", "ok", "late"):
            assert g[key] == w[key], key
        assert g["margin"] == w["margin"] or \
            abs(g["margin"] - w["margin"]) <= 1e-6


def test_service_health_wiring_matches_reference(tmp_path):
    """The same endpoint calls on both packages' services with every
    health knob on: the SLO ledgers (shadow recall pushed into
    ``search.quality``), ``health()``, the tracked store bytes and the
    counters agree; a canary run leaves the user-facing series, the tail
    sampler and the quality report untouched in both; warm-up arms the
    recompile mark."""
    jc, tc = _sketchers()
    out = {}
    for pkg, crp in (("torch", tc), ("jax", jc)):
        clock = _Clock()
        svc, rng, arr = _service(pkg, crp, tmp_path, clock)
        obs = _PKG[pkg][0]
        assert svc.incidents.slo is svc.slo
        assert svc.incidents.quality is svc.quality
        assert set(svc.slo.specs) == {"search", "classify"}
        assert svc.slo._resources is svc.resources
        for i in range(6):
            for _ in range(1 + i % 4):
                svc.submit(arr(np.asarray(rng.normal(size=(D,)),
                                          np.float32)))
            svc.flush()
            clock.t += 1.0
        reg = svc.registry
        user = (reg.histograms["serve.flush_s"].count,
                reg.counters["serve.queries"].value,
                dict(svc.sampler.retained), svc.quality.report())
        rep = obs.CanaryProber(svc, slo=svc.slo, cfg=obs.ProbeConfig(
            n_probes=5, classify=False,
            latency_budget_s=math.inf)).run_once()
        assert rep["probes"] == 5 and rep["recall"] == 1.0 and rep["ok"]
        assert (reg.histograms["serve.flush_s"].count,
                reg.counters["serve.queries"].value,
                dict(svc.sampler.retained), svc.quality.report()) == user
        assert reg.counters["serve.probe.queries"].value == 5
        svc.warmup(D)
        assert svc.slo._compile_mark is not None
        assert svc.resources.compiles_since_mark == 0
        clock.t += 1.0
        svc.submit(arr(np.asarray(rng.normal(size=(D,)), np.float32)))
        svc.flush()
        led = svc.slo.ledgers
        counters = {k: v for k, v in reg.snapshot()["counters"].items()
                    if not k.startswith("sampler.")}
        out[pkg] = dict(
            ledgers={k: l.totals() for k, l in led.items()},
            health=svc.slo.health(), report=rep,
            tracked=svc.resources.collect()["tracked"],
            counters=counters, recall=svc.quality.recall.queries)
    t, j = out["torch"], out["jax"]
    assert t["recall"] == j["recall"] > 0
    # each shadow check and each canary verdict is one quality event
    assert t["ledgers"]["search.quality"][0] == t["recall"] + 5
    assert t["ledgers"] == j["ledgers"]
    assert t["health"] == j["health"]
    assert t["tracked"] == j["tracked"] and t["tracked"]["engine.store"] > 0
    assert t["counters"] == j["counters"]
    _same_reports(t["report"], j["report"])


def test_corrupted_ranking_drill_matches_reference(tmp_path):
    """``tests/test_health.py``'s drill on both packages: healthy canaries
    retrieve themselves; with ``engine.search_codes`` returning wrong ids
    every canary fails, and the quality alert trips at the same run, with
    the same ``health()`` and an incident bundle of the same kind,
    context and SLO state, which loads back."""
    jc, tc = _sketchers()
    out = {}
    for pkg, crp in (("torch", tc), ("jax", jc)):
        clock = _Clock()
        # cache_size=0: the result cache would serve pre-fault answers
        svc, rng, arr = _service(pkg, crp, tmp_path, clock, cache_size=0,
                                 quality=False)
        obs = _PKG[pkg][0]
        rows = np.asarray(rng.normal(size=(48, D)), np.float32)
        resv = obs.ShadowReservoir(cap=64)
        ids = svc.add(arr(rows))
        resv.offer(np.asarray(ids), rows)
        prober = obs.CanaryProber(svc, slo=svc.slo, reservoir=resv,
                                  cfg=obs.ProbeConfig(
                                      n_probes=4, classify=False,
                                      latency_budget_s=math.inf))
        healthy = []
        for _ in range(8):
            healthy.append(prober.run_once())
            assert healthy[-1]["ok"] and healthy[-1]["recall"] == 1.0
            clock.t += 1.0
        assert svc.slo.health()["status"] == "ok"
        assert svc.incidents.captured == 0
        real = svc.engine.search_codes
        if pkg == "torch":
            svc.engine.search_codes = lambda q, cfg: (
                torch.full((q.shape[0], 5), 99999, dtype=torch.int32),
                torch.zeros((q.shape[0], 5)))
        else:
            svc.engine.search_codes = lambda q, cfg: (
                jnp.full((q.shape[0], 5), 99999, jnp.int32),
                jnp.zeros((q.shape[0], 5), jnp.float32))
        bad = []
        try:
            for _ in range(40):
                bad.append(prober.run_once())
                assert not bad[-1]["ok"] and bad[-1]["recall"] == 0.0
                clock.t += 1.0
                if svc.slo.health()["status"] == "degraded":
                    break
        finally:
            svc.engine.search_codes = real
        assert svc.slo.health()["status"] == "degraded"
        bundle = svc.incidents.load()
        assert bundle["kind"] == "drift"
        assert bundle["context"]["series"] == "slo.search.quality"
        assert bundle["slo"]["status"] == "degraded"
        assert "slo.search.quality" in bundle["slo"]["alerts"]
        assert prober.run_once()["ok"]       # restored
        out[pkg] = dict(healthy=healthy, bad=bad, health=svc.slo.health(),
                        context=bundle["context"], slo=bundle["slo"],
                        captured=svc.incidents.captured)
    t, j = out["torch"], out["jax"]
    assert len(t["bad"]) == len(j["bad"]) and t["captured"] == j["captured"]
    for got, want in zip(t["healthy"] + t["bad"], j["healthy"] + j["bad"]):
        _same_reports(got, want)
    assert t["health"] == j["health"]
    assert t["context"] == j["context"] and t["slo"] == j["slo"]


def test_service_captures_endpoint_errors_as_incidents(tmp_path):
    """A raising flush or classify is captured as an ``error`` bundle (and
    still raises); the availability ledger counts the error."""
    _, tc = _sketchers()
    clock = _Clock()
    svc, rng, _ = _service("torch", tc, tmp_path, clock, quality=False)
    real = svc.engine.search_codes

    def boom(q, cfg):
        raise RuntimeError("device lost")
    svc.engine.search_codes = boom
    svc.submit(np.asarray(rng.normal(size=(D,)), np.float32))
    with pytest.raises(RuntimeError, match="device lost"):
        svc.flush()
    svc.engine.search_codes = real
    b = svc.incidents.load()
    assert (b["kind"], b["reason"]) == ("error",
                                        "flush: RuntimeError: device lost")

    class Broken:
        def margins(self, words, impl="auto"):
            raise ValueError("bad tables")
    svc.classifier = Broken()
    with pytest.raises(ValueError, match="bad tables"):
        svc.classify(np.zeros((2, D), np.float32))
    b = svc.incidents.load()
    assert (b["kind"], b["reason"], b["incident"]) == (
        "error", "classify: ValueError: bad tables", 2)
    clock.t += 1.0
    svc.slo.tick()
    assert svc.slo.ledgers["search.availability"].totals() == (1, 1)
    assert svc.slo.ledgers["classify.availability"].totals() == (1, 1)
