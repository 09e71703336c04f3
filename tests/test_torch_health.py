"""Port parity for the paper's estimator math and the statistical-health
monitors: ``repro_torch.core`` (probabilities, variance, optimal width,
encoders, packed Hamming counts, ``MleRhoEstimator``, the sketcher's
helpers) and ``repro_torch.obs`` quality, shadow and drift, with their
hooks in both engines, the trainer and ``AnnService(quality=)``.

Inputs are made with numpy from a seed and go through the JAX package and
the port on the CPU. Tolerances:

* ``collision_prob_*`` and ``q_region`` within atol 2e-6 of JAX (float32
  there, float64 here); ``dP_drho_*`` within rtol 1e-4 of JAX and of a
  central difference of the port's own float64 ``collision_prob``;
  ``variance_factor_*`` and ``optimal_w``'s ``v_star`` within rtol 1e-4;
  ``w_star`` equal except where V at the two widths agrees within that
  tolerance (the uniform scheme's plateau below rho ~ 0.56);
* encoders, ``collision_fraction``, ``hamming_packed``,
  ``match_count_packed_1bit``, cell counts, ``synthetic_code_pairs``, the
  drift detectors, the reservoir and every pooled count: bit for bit;
* ``MleRhoEstimator`` at G = 64: cell probabilities within 3e-7, and
  ``estimate`` / ``mle_rho_2bit`` on synthetic pairs within one grid
  step (the two tables differ in their float32 rounding, so a near-tie
  of two grid points can fall either way);
* a ``CollisionMonitor`` report within rtol 1e-3 where both MLEs pick the
  same grid point; ``asymptotic_std`` and the shadow rho-error moments
  within rtol 1e-4.

The JAX side runs under ``jax.jit`` where the reference would compile
per call: its eager ``optimal_w`` compiles ``variance_factor`` once per
width, and for the uniform scheme each width has its own bin count, so
this file never calls it for that scheme. The reference's own classes
(``MleRhoEstimator``, ``CollisionMonitor``) build their tables eagerly,
as they are written: a jitted uniform ``cell_probs`` compiles far longer
than the eager one runs.
"""
import dataclasses
import functools
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core as jcore
from repro.ann import AnnEngine as JaxEngine
from repro.ann import BandSpec as JaxBands
from repro.ann import CodeStore as JaxStore
from repro.ann.engine import SearchConfig as JaxSearchConfig
from repro.core import estimators as JE
from repro.core import optimal as JO
from repro.core import packing as JPk
from repro.core import probabilities as JP
from repro.core import schemes as JS
from repro.core import variance as JV
from repro.core.sketch import CodedRandomProjection as JaxCRP
from repro.core.sketch import SketchConfig as JaxCfg
from repro.index import MutableAnnEngine as JaxMutable
from repro.learn import PackedFeatureSpec as JaxFSpec
from repro.learn import PackedLinearModel as JaxModel
from repro.obs import drift as jdrift
from repro.obs import quality as jq
from repro.obs import shadow as jshadow
from repro.obs.registry import MetricsRegistry as JaxRegistry
from repro.serve import AnnService as JaxService
from repro.serve import AnnServiceConfig as JaxServiceCfg

import repro_torch.core as tcore
from repro_torch import convert
from repro_torch.ann import AnnEngine, BandSpec, SearchConfig
from repro_torch.core import estimators as TE
from repro_torch.core import optimal as TO
from repro_torch.core import packing as TPk
from repro_torch.core import probabilities as TP
from repro_torch.core import schemes as TS
from repro_torch.core import variance as TV
from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
from repro_torch.index import MutableAnnEngine
from repro_torch.learn import LearnConfig, fit_log, fit_store, fit_words
from repro_torch.obs import drift as tdrift
from repro_torch.obs import quality as tq
from repro_torch.obs import shadow as tshadow
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.serve import AnnService, AnnServiceConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; torch's intra-op threads would
    compete with them, so this file runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCHEMES = [("uniform", 0.75), ("offset", 1.0), ("2bit", 0.75), ("sign", 1.0)]
RHO = np.linspace(0.0, 0.999, 37)
GRID6 = np.geomspace(0.05, 12.0, 6)


@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    return jax.jit(lambda r: fn(r, *static))


def _j(fn, rho, *static):
    return np.asarray(_jit(fn, *static)(jnp.asarray(rho, jnp.float32)),
                      np.float64)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float64))


# -- A.14: the paper math ---------------------------------------------------------------

@pytest.mark.parametrize("scheme,w", SCHEMES)
def test_collision_prob_and_q_region_match_jax(scheme, w):
    fn = {"uniform": (JP.collision_prob_uniform, TP.collision_prob_uniform),
          "offset": (JP.collision_prob_offset, TP.collision_prob_offset),
          "2bit": (JP.collision_prob_2bit, TP.collision_prob_2bit),
          "sign": (JP.collision_prob_sign, TP.collision_prob_sign)}[scheme]
    np.testing.assert_allclose(fn[1](_t(RHO), w).numpy(), _j(fn[0], RHO, w),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(TP.collision_prob(_t(RHO), w, scheme).numpy(),
                               fn[1](_t(RHO), w).numpy(), rtol=0, atol=0)
    s, t = {"uniform": (0.0, 0.75), "offset": (-1.0, 0.5),
            "2bit": (0.75, 9.5), "sign": (-12.0, 0.0)}[scheme]
    np.testing.assert_allclose(TP.q_region(_t(RHO), s, t).numpy(),
                               _j(JP.q_region, RHO, s, t), rtol=0, atol=2e-6)


@pytest.mark.parametrize("scheme,w", SCHEMES)
def test_dP_drho_matches_jax_and_a_central_difference(scheme, w):
    rho = np.linspace(0.05, 0.95, 19)
    got = TV.dP_drho(_t(rho), w, scheme).numpy()
    np.testing.assert_allclose(got, _j(JV.dP_drho, rho, w, scheme),
                               rtol=1e-4)
    h = 1e-5
    diff = (TP.collision_prob(_t(rho + h), w, scheme)
            - TP.collision_prob(_t(rho - h), w, scheme)).numpy() / (2 * h)
    np.testing.assert_allclose(got, diff, rtol=1e-4)
    name = {"2bit": "2bit"}.get(scheme, scheme)
    np.testing.assert_array_equal(
        getattr(TV, f"dP_drho_{name}")(_t(rho), w).numpy(), got)


@pytest.mark.parametrize("scheme,w", SCHEMES)
def test_variance_factor_matches_jax(scheme, w):
    for width in (w, 2.0):
        got = getattr(TV, f"variance_factor_{scheme}")(_t(RHO), width).numpy()
        np.testing.assert_allclose(
            got, _j(getattr(JV, f"variance_factor_{scheme}"), RHO, width),
            rtol=1e-4)
        np.testing.assert_array_equal(
            TV.variance_factor(_t(RHO), width, scheme).numpy(), got)


def _same_argmin(w_t, v_t, w_j, vs_t, grid):
    """w_star equal, except where V at the two widths agrees within the
    tolerance (a plateau: either width is a minimiser)."""
    for i in np.flatnonzero(w_t != w_j):
        a = int(np.flatnonzero(grid == w_t[i])[0])
        b = int(np.flatnonzero(np.isclose(grid, w_j[i], rtol=1e-6))[0])
        np.testing.assert_allclose(vs_t[i, a], vs_t[i, b], rtol=1e-4)


@pytest.mark.parametrize("scheme", ["offset", "2bit", "sign", "uniform"])
def test_optimal_w_matches_jax(scheme):
    rho = np.array([0.1, 0.3, 0.5, 0.6, 0.8, 0.9, 0.95, 0.99])
    w_t, v_t = TO.optimal_w(rho, scheme, GRID6)
    assert w_t.dtype == v_t.dtype == torch.float64
    vs_t = np.stack([TV.variance_factor(_t(rho), float(w), scheme).numpy()
                     for w in GRID6], axis=-1)
    if scheme == "uniform":
        # never the reference's eager optimal_w here (one compile a width)
        vs_j = np.asarray(jax.jit(lambda r: jnp.stack(
            [JV.variance_factor_uniform(r, float(w)) for w in GRID6],
            axis=-1))(jnp.asarray(rho, jnp.float32)), np.float64)
        idx = np.asarray(jnp.argmin(jnp.asarray(vs_j), axis=-1))
        w_j, v_j = GRID6[idx], vs_j[np.arange(len(rho)), idx]
    else:
        w_j, v_j = (np.asarray(a, np.float64) for a in jax.jit(
            lambda r: JO.optimal_w(r, scheme, GRID6))(jnp.asarray(rho)))
    np.testing.assert_allclose(v_t.numpy(), v_j, rtol=1e-4)
    _same_argmin(w_t.numpy(), v_t.numpy(), np.asarray(w_j), vs_t, GRID6)
    np.testing.assert_array_equal(TO.default_w_grid(), JO.default_w_grid())


def test_optimal_w_threshold_on_the_port():
    """The assertions of the reference's ``test_optimal_w_threshold``
    (paper Fig 5), on the port alone at the default 240-width grid."""
    w_lo, _ = TO.optimal_w([0.15, 0.3, 0.5], "uniform")
    w_hi, _ = TO.optimal_w([0.6, 0.9], "uniform")
    assert np.all(w_lo.numpy() > 5.5), w_lo
    assert float(w_lo.max()) > 6.0
    assert np.all(w_hi.numpy() < 2.0), w_hi
    assert float(w_hi[-1]) < 1.5
    w_q, _ = TO.optimal_w([0.0, 0.5, 0.9], "offset")
    assert np.all(w_q.numpy() < 4.0)


@pytest.mark.parametrize("scheme,w", SCHEMES)
def test_encoders_and_packed_counts_bit_exact(scheme, w):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((40, 33)) * 2.5).astype(np.float32)
    x[0, :12] = [-w, 0.0, w, -0.0, 6.0, -6.0, 2 * w, -2 * w, 9.0, -9.0,
                 w * 7, -w * 8]                 # every edge and the clamps
    q = rng.uniform(0, w, 33).astype(np.float32)
    if scheme == "offset":
        jc = JS.encode_offset(jnp.asarray(x), w, jnp.asarray(q))
        tc = TS.encode_offset(torch.from_numpy(x), w, torch.from_numpy(q))
    elif scheme == "sign":
        jc, tc = JS.encode_sign(jnp.asarray(x)), TS.encode_sign(x)
    else:
        jc = getattr(JS, f"encode_{scheme}")(jnp.asarray(x), w)
        tc = getattr(TS, f"encode_{scheme}")(torch.from_numpy(x), w)
    assert tc.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    spec = TS.spec_for(scheme, w)
    assert spec == TS.CodeSpec(scheme, float(w), 6.0)
    np.testing.assert_array_equal(
        TS.encode(torch.from_numpy(x), spec, torch.from_numpy(q)).numpy(),
        tc.numpy())
    b = np.roll(np.asarray(jc), 1, axis=0)
    for axis in (-1, 0):
        np.testing.assert_array_equal(
            TS.collision_fraction(tc, torch.from_numpy(b), axis).numpy(),
            np.asarray(JS.collision_fraction(jc, jnp.asarray(b), axis)))
    bits = (rng.integers(0, 2, (7, 77))).astype(np.int32)
    wa = JPk.pack_codes(jnp.asarray(bits), 1)
    wb = JPk.pack_codes(jnp.asarray(bits[::-1].copy()), 1)
    ta = torch.from_numpy(np.array(wa).view(np.int32))
    tb = torch.from_numpy(np.array(wb).view(np.int32))
    np.testing.assert_array_equal(TPk.hamming_packed(ta, tb).numpy(),
                                  np.asarray(JPk.hamming_packed(wa, wb)))
    np.testing.assert_array_equal(
        TPk.match_count_packed_1bit(ta, tb, 77).numpy(),
        np.asarray(JPk.match_count_packed_1bit(wa, wb, 77)))


def test_asymptotic_std_and_sketcher_helpers():
    rho = np.array([0.0, 0.3, 0.7, 0.95])
    for scheme, w in SCHEMES:
        got = TE.CollisionEstimator(scheme, w, grid_size=64).asymptotic_std(
            _t(rho), 100)
        # the reference's definition, sqrt(V / k), jitted
        want = np.sqrt(_j(JV.variance_factor, rho, w, scheme) / 100)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    jc, tc = _case("2bit", 0.75, 100)[:2]
    np.testing.assert_allclose(tc.asymptotic_std(_t(rho)).numpy(),
                               np.asarray(jc.asymptotic_std(
                                   jnp.asarray(rho, jnp.float32))), rtol=1e-4)
    assert (tc.bytes_per_vector(), tc.fp32_bytes_per_vector()) == \
        (jc.bytes_per_vector(), jc.fp32_bytes_per_vector()) == (28, 400)
    for scheme, w in (("sign", None), ("uniform", 0.5)):
        t2 = tc.with_scheme(scheme, w)
        # the reference's with_scheme is replace(cfg, scheme=, w=) on D
        j2 = dataclasses.replace(jc.cfg, scheme=scheme,
                                 w=jc.cfg.w if w is None else w)
        assert (t2.cfg.scheme, t2.cfg.w, t2.cfg.seed, t2.d, t2.device) == \
            (j2.scheme, j2.w, 7, D, tc.device)
        assert t2.bytes_per_vector() == 4 * JPk.packed_width(
            100, JS.CodeSpec(j2.scheme, j2.w).bits)
        a = torch.from_numpy(_case("2bit", 0.75, 100)[2][:3])
        np.testing.assert_array_equal(t2.project(a).numpy(),
                                      tc.project(a).numpy())   # the same R


def _pairs(spec, k, rho, m, seed):
    """Code pairs at rho (bit-identical to the reference's draw,
    ``test_synthetic_code_pairs_are_bit_identical``)."""
    return tq.synthetic_code_pairs(spec, k, rho, m, seed=seed)


@pytest.mark.parametrize("scheme,w", [("2bit", 0.75), ("sign", 1.0),
                                      ("uniform", 0.75)])
def test_mle_estimator_matches_jax(scheme, w):
    spec = TS.CodeSpec(scheme, w)
    jm = JE.MleRhoEstimator(JS.CodeSpec(scheme, w), grid_size=64)
    tm = TE.MleRhoEstimator(spec, grid_size=64)
    grid = np.linspace(0.0, 0.99995, 64)
    np.testing.assert_allclose(
        TE.cell_probs(_t(grid), spec).numpy(),
        np.asarray(JE.cell_probs(jnp.asarray(grid), JS.CodeSpec(scheme, w))),
        rtol=0, atol=3e-7)
    step = grid[1]
    for rho, seed in ((0.3, 1), (0.97, 3)):
        a, b = _pairs(spec, 64, rho, 48, seed)
        got = tm.cell_counts(torch.from_numpy(a), torch.from_numpy(b))
        want = np.asarray(jm.cell_counts(jnp.asarray(a), jnp.asarray(b)))
        assert got.dtype == torch.int32 and got.shape == (48, spec.n_codes ** 2)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tm.cell_counts(
            torch.from_numpy(a.reshape(4, 12, 64)),
            torch.from_numpy(b.reshape(4, 12, 64))).numpy(),
            want.reshape(4, 12, -1))
        r_t = tm.estimate(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        r_j = np.asarray(jm.from_counts(jnp.asarray(want)))
        assert np.all(np.abs(r_t - r_j) <= step * 1.0001), (r_t, r_j)
        np.testing.assert_array_equal(
            tm.from_counts(got.to(torch.float64)).numpy(), r_t)
        if scheme == "2bit":
            m_t = TE.mle_rho_2bit(a, b, w, grid_size=64).numpy()
            m_j = np.asarray(JE.mle_rho_2bit(jnp.asarray(a), jnp.asarray(b),
                                             w, grid_size=64))
            np.testing.assert_array_equal(m_t, r_t)
            assert np.all(np.abs(m_t - m_j) <= step * 1.0001)
    assert TE._mle_2bit_estimator(0.75, 64) is TE._mle_2bit_estimator(0.75, 64)


def test_core_exports_the_reference_names():
    names = [n for n in dir(jcore) if not n.startswith("_")
             and not isinstance(getattr(jcore, n), type(jcore))]
    missing = [n for n in names if not hasattr(tcore, n)]
    assert not missing, missing
    assert tcore.optimal_w is TO.optimal_w and tcore.q_region is TP.q_region


# -- A.10, first half: drift, quality, shadow -------------------------------------------

def test_drift_detectors_are_bit_identical():
    rng = np.random.default_rng(9)
    xs = np.concatenate([rng.normal(0.5, 0.05, 120), rng.normal(0.7, 0.05, 80),
                         rng.normal(0.4, 0.05, 80)])
    for make in (lambda m: m.PageHinkley(delta=0.005, threshold=0.3),
                 lambda m: m.PageHinkley(two_sided=False),
                 lambda m: m.Cusum(slack=0.01, threshold=0.5),
                 lambda m: m.Cusum(mu0=0.5)):
        dj, dt = make(jdrift), make(tdrift)
        got = [(dt.update(x), dt.stat, dt.side, dt.n) for x in xs]
        want = [(dj.update(x), dj.stat, dj.side, dj.n) for x in xs]
        assert got == want and dt.alarms == dj.alarms > 0
    fired = {"j": [], "t": []}
    mons = {}
    for key, m, reg in (("j", jdrift, JaxRegistry()), ("t", tdrift,
                                                       MetricsRegistry())):
        mon = m.DriftMonitor(registry=reg).subscribe(
            lambda s, v, d, key=key: fired[key].append((s, v, d.side)))
        mon.watch("b", m.Cusum(threshold=0.2))
        for x in xs:
            mon.update("a", x)
            mon.update("b", x)
        mon.update("a", math.nan)
        mons[key] = (mon, reg)
    assert fired["t"] == fired["j"] and fired["t"]
    assert mons["t"][1].snapshot() == mons["j"][1].snapshot()


@pytest.mark.parametrize("scheme,w", SCHEMES)
def test_synthetic_code_pairs_are_bit_identical(scheme, w):
    q = np.linspace(0.0, w, 16, dtype=np.float32) if scheme == "offset" \
        else None
    ja, jb = jq.synthetic_code_pairs(JS.CodeSpec(scheme, w), 16, 0.6, 30,
                                     seed=4, q=None if q is None
                                     else jnp.asarray(q))
    ta, tb = tq.synthetic_code_pairs(TS.CodeSpec(scheme, w), 16, 0.6, 30,
                                     seed=4, q=None if q is None
                                     else torch.from_numpy(q))
    assert ta.dtype == np.int32
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tb, jb)


def _reports_agree(tm, jm):
    """Two ``CollisionMonitor`` reports: counts and frequencies equal; the
    rest within rtol 1e-3 where both MLEs pick the same grid point. The
    chi-square, z_max and n_cells sum over the table's smallest cells: they
    are compared where both tables hold the same cells within 1e-3. Only
    the uniform scheme's table differs there (ROADMAP queue C, "cell_probs
    underflow": the reference's float32 table flushes cells below about
    1e-8 that the port's float64 table keeps)."""
    got, want = tm.report(), jm.report()
    assert got["pairs"] == want["pairs"] and got["scheme"] == want["scheme"]
    np.testing.assert_array_equal(got["cell_freq"], want["cell_freq"])
    if got["rho_hat"] != want["rho_hat"]:
        assert abs(got["rho_hat"] - want["rho_hat"]) <= 0.99995 / 63 * 1.0001
        return
    for key in ("p_hat", "p_theory", "z_diag", "phat_std", "phat_std_theory"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=1e-9,
                                   err_msg=key)
    gi = min(int(np.searchsorted(tm._rho_grid, got["rho_hat"])),
             len(tm._rho_grid) - 1)
    pt, pj = tm._probs[gi], jm._probs[gi]
    if np.array_equal(pt > 1e-12, pj > 1e-12) and np.allclose(
            pt[pt > 1e-12], pj[pj > 1e-12], rtol=1e-3):
        for key in ("z_max", "chi2", "chi2_per_cell"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-3,
                                       err_msg=key)
        assert got["n_cells"] == want["n_cells"]
    else:
        assert tm.spec.scheme == "uniform"


@pytest.mark.parametrize("scheme,w", SCHEMES)
def test_collision_monitor_matches_jax(scheme, w):
    q = np.full(64, w / 3, np.float32) if scheme == "offset" else None
    jreg, treg = JaxRegistry(), MetricsRegistry()
    jm = jq.CollisionMonitor(JS.CodeSpec(scheme, w), 64, registry=jreg,
                             grid_size=64, min_pairs=40)
    tm = tq.CollisionMonitor(TS.CodeSpec(scheme, w), 64, registry=treg,
                             grid_size=64, min_pairs=40)
    assert tm.diag_only == jm.diag_only == (scheme == "offset")
    for rho, m, seed in ((0.5, 30, 1), (0.9, 30, 2)):
        a, b = jq.synthetic_code_pairs(JS.CodeSpec(scheme, w), 64, rho, m,
                                       seed=seed, q=q)
        bj = jm.observe_pairs(a, b)
        bt = tm.observe_pairs(torch.from_numpy(np.array(a)), b)
        assert bt["p_batch"] == bj["p_batch"]
        assert abs(bt["rho_batch"] - bj["rho_batch"]) <= 0.99995 / 63 * 1.0001
        np.testing.assert_array_equal(tm.counts, jm.counts)
        assert tm.counts.dtype == np.int64
    assert (tm.frac.n, tm.frac.mean, tm.frac.std) == \
        (jm.frac.n, jm.frac.mean, jm.frac.std)
    _reports_agree(tm, jm)
    tc, jc = treg.snapshot()["counters"], jreg.snapshot()["counters"]
    assert tc == jc == {"quality.collision.pairs": 60,
                        "quality.collision.batches": 2}
    assert set(treg.snapshot()["gauges"]) == set(jreg.snapshot()["gauges"])
    tm.reset()
    assert tm.pairs == 0 and not tm.counts.any()


def test_margin_monitor_and_welford_match_jax():
    rng = np.random.default_rng(2)
    for m in (rng.standard_normal((1, 700)), rng.standard_normal((3, 40)),
              np.zeros((1, 0))):
        jm = jq.MarginMonitor(registry=JaxRegistry(), max_rows=512)
        tm = tq.MarginMonitor(registry=MetricsRegistry(), max_rows=512)
        bj = jm.observe(m.astype(np.float32))
        bt = tm.observe(torch.from_numpy(m.astype(np.float32)))
        assert (bt == bj) or (math.isnan(bt) and math.isnan(bj))
        assert (tm.moments.n, tm.moments.mean) == (jm.moments.n,
                                                   jm.moments.mean)
        assert tm.registry.snapshot() == jm.registry.snapshot()


def _encoder(k=64, d=24):
    """One numpy coder (a seeded projection, 2-bit codes) for both
    packages' recall monitors: they are compared given equal codes."""
    r = np.random.default_rng(1).standard_normal((d, k)).astype(np.float32)
    return lambda x: np.digitize(np.asarray(x) @ r / np.sqrt(d),
                                 [-0.75, 0.0, 0.75]).astype(np.int32)


def test_shadow_reservoir_and_recall_match_jax():
    assert tshadow.wilson_interval(0, 0)[0] != tshadow.wilson_interval(0, 0)[0]
    for s, n in ((0, 10), (7, 10), (10, 10), (950, 1000)):
        assert tshadow.wilson_interval(s, n) == jshadow.wilson_interval(s, n)
    rng = np.random.default_rng(6)
    enc = _encoder()
    rows = rng.standard_normal((300, 24)).astype(np.float32)
    jr = jshadow.ShadowReservoir(cap=64, seed=3, registry=JaxRegistry())
    tr = tshadow.ShadowReservoir(cap=64, seed=3, registry=MetricsRegistry())
    for lo, hi in ((0, 50), (50, 200), (200, 300)):
        ids = np.arange(lo, hi) * 3
        jr.offer(ids, rows[lo:hi])
        tr.offer(ids, torch.from_numpy(rows[lo:hi]))
    up = tr.ids()[:5]
    jr.offer(np.r_[up, up[:1]], rows[:6])
    tr.offer(np.r_[up, up[:1]], rows[:6])          # upserts, one twice
    jr.remove(np.r_[tr.ids()[10:20], 1])
    tr.remove(np.r_[tr.ids()[10:20], 1])
    np.testing.assert_array_equal(tr.ids(), jr.ids())
    np.testing.assert_array_equal(tr.rows(), jr.rows())
    assert (tr.n_seen, tr.version, len(tr)) == (jr.n_seen, jr.version, len(jr))
    jrec = jshadow.RecallMonitor(jr, top_k=10, registry=JaxRegistry())
    trec = tshadow.RecallMonitor(tr, top_k=10, registry=MetricsRegistry())
    jest = JE.CollisionEstimator("2bit", 0.75, grid_size=64)
    test = TE.CollisionEstimator("2bit", 0.75, grid_size=64)
    queries = rows[:5] + 0.3 * rng.standard_normal((5, 24)).astype(
        np.float32)
    for i, qv in enumerate(queries):
        qc = enc(qv[None, :])[0] if i % 2 else None
        rj = jrec.observe_query(qv, enc, jest, q_codes=qc)
        rt = trec.observe_query(torch.from_numpy(qv), enc, test,
                                q_codes=None if qc is None
                                else torch.from_numpy(qc))
        assert rt == rj
    got, want = trec.report(), jrec.report()
    for key in ("top_k", "queries", "trials", "recall", "recall_lo",
                "recall_hi", "reservoir_rows"):
        assert got[key] == want[key], key
    for key in ("rho_err_mean", "rho_err_std", "rho_std_theory"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6)
    small = tshadow.RecallMonitor(tshadow.ShadowReservoir(
        cap=8, registry=MetricsRegistry()), registry=MetricsRegistry())
    assert small.observe_query(queries[0], enc, test) is None


# -- the hooks: engines, trainer, service ----------------------------------------------

D, N = 96, 600
QCFG = dict(sample_rate=1.0, grid_size=64, min_pairs=16, reservoir_rows=64)


def _rows(rng, n):
    x = rng.standard_normal((n, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@functools.lru_cache(maxsize=None)
def _case(scheme, w, k):
    """tests/test_torch_engine.py's small case: JAX and port sketchers on
    one R, the corpus and queries, and the JAX-packed words."""
    cfg = dict(k=k, scheme=scheme, w=w, seed=7)
    jc = JaxCRP(JaxCfg(**cfg), D)
    tc = convert.sketch_from_numpy(
        SketchConfig(**cfg), D, np.asarray(jc.stream_encoder().r_matrix()),
        None if jc._offsets is None else np.asarray(jc._offsets),
        device="cpu")
    rng = np.random.default_rng(2014)
    corpus = _rows(rng, N)
    queries = np.concatenate([corpus[:20] + 0.02 * rng.standard_normal(
        (20, D)).astype(np.float32), _rows(rng, 13)])
    # the port's words: bit-identical to JAX's sketch of this corpus
    # (tests/test_torch_engine.py::test_sketch_words_match_jax)
    return jc, tc, corpus, queries, tc.sketch(corpus).numpy().view(np.uint32)


def _bundles(jc, tc, **kw):
    cfg = dict(QCFG, **kw)
    jqm = jq.QualityMonitors(jc, jq.QualityConfig(**cfg),
                             registry=JaxRegistry())
    tqm = tq.QualityMonitors(tc, tq.QualityConfig(**cfg),
                             registry=MetricsRegistry())
    return jqm, tqm


def _same_quality(tqm, jqm):
    """Equal sampling, pooled counts, reservoir and shadow trials; the
    reports within the module docstring's tolerances."""
    c_t, c_j = tqm.registry.snapshot()["counters"], \
        jqm.registry.snapshot()["counters"]
    assert {k: v for k, v in c_t.items() if k.startswith("quality.")} == \
        {k: v for k, v in c_j.items() if k.startswith("quality.")}, (c_t, c_j)
    np.testing.assert_array_equal(tqm.collision.counts, jqm.collision.counts)
    assert tqm.collision.pairs == jqm.collision.pairs > 0
    np.testing.assert_array_equal(tqm.reservoir.ids(), jqm.reservoir.ids())
    _reports_agree(tqm.collision, jqm.collision)
    got, want = tqm.recall.report(), jqm.recall.report()
    for key in ("queries", "trials", "recall", "recall_lo", "recall_hi",
                "reservoir_rows"):
        assert got[key] == want[key] or (
            math.isnan(got[key]) and math.isnan(want[key])), key
    for key in ("rho_err_mean", "rho_err_std", "rho_std_theory"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6)
    assert tqm.rng.random() == jqm.rng.random()     # the same stream state


@functools.lru_cache(maxsize=None)
def _jax_engine():
    """One JAX engine for both tests below (its search compiles once)."""
    jc, _, _, _, words = _case("2bit", 0.75, 100)
    return JaxEngine(jc, JaxStore.from_words(words, 100, 2), JaxBands(4, 4))


def _drive(svc, corpus, queries, mutable):
    """Endpoint calls in one order; returns every result."""
    out = []
    if mutable:
        out.append(svc.bulk_load(corpus[:300], chunk_rows=128))
        out.append(svc.add(corpus[300:400]))
    for lo, hi in ((0, 1), (1, 9), (9, 17)):
        tickets = [svc.submit(queries[i]) for i in range(lo, hi)]
        res = svc.flush()
        out += [res[t] for t in tickets]
    if mutable:
        res_ids = svc.quality.reservoir.ids()
        out.append(svc.upsert(res_ids[:4], corpus[400:404]))
        out.append(svc.delete(np.r_[res_ids[4:20], np.arange(1, 300, 11)],
                              strict=False))
        tickets = [svc.submit(queries[i]) for i in range(8)]
        res = svc.flush()
        out += [res[t] for t in tickets]
    out.append(svc.probe_search(queries[0]))
    return out


@pytest.mark.parametrize("mutable", [False, True],
                         ids=["immutable", "mutable"])
def test_engine_and_service_quality_match_jax(mutable):
    """Both engines' search hook (direct, and through ``AnnService``'s
    flushes), the service's shadow checks, reservoir upkeep by ``add``,
    ``bulk_load`` and ``upsert``, and tombstones by ``delete``, against
    the JAX twins on one R: the same sampled requests, equal counts and
    equal recall. Searches take top_k = 65 (``tests/test_torch_serve.py``
    says why)."""
    jc, tc, corpus, queries, words = _case("2bit", 0.75, 100)
    if mutable:
        jeng = JaxMutable(jc, band_spec=None, tail_rows=128)
        teng = MutableAnnEngine(tc, band_spec=None, tail_rows=128)
    else:
        jeng = _jax_engine()
        teng = AnnEngine(tc, convert.store_from_numpy(words, 100, 2,
                                                      device="cpu"),
                         BandSpec(4, 4))
        jqm, tqm = _bundles(jc, tc)
        jeng.attach_quality(jqm)
        assert teng.attach_quality(tqm) is teng
        q_codes = np.asarray(jeng.encode_queries(jnp.asarray(queries)))
        ji, _ = jeng.search_codes(jnp.asarray(q_codes),
                                  JaxSearchConfig(top_k=65, chunk_q=8))
        ti, _ = teng.search_codes(torch.from_numpy(q_codes.copy()),
                                  SearchConfig(top_k=65, chunk_q=8))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert tqm.collision.pairs == 8
        np.testing.assert_array_equal(tqm.collision.counts,
                                      jqm.collision.counts)
        assert teng.add(queries[:2]).quality is tqm
    kw = dict(buckets=(8,), top_k=65)
    jsvc = JaxService(jeng, JaxServiceCfg(**kw),
                      quality=jq.QualityConfig(**QCFG))
    tsvc = AnnService(teng, AnnServiceConfig(**kw),
                      quality=tq.QualityConfig(**QCFG))
    assert teng.quality is tsvc.quality
    want = _drive(jsvc, corpus, queries, mutable)
    got = _drive(tsvc, corpus, queries, mutable)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            np.testing.assert_array_equal(g[0], np.asarray(w[0]))
            np.testing.assert_allclose(g[1], np.asarray(w[1]), atol=1e-6)
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    tqm, jqm = tsvc.quality, jsvc.quality
    _same_quality(tqm, jqm)
    if mutable:
        assert tqm.recall.queries == 4 and len(tqm.reservoir) >= 40
        assert not set(np.arange(1, 300, 11).tolist()) & \
            set(tqm.reservoir.ids().tolist())
    else:
        assert tqm.recall.queries == 0 and len(tqm.reservoir) == 0
    # the probe advanced no sampling stream and took no trace budget
    assert tsvc.registry.snapshot()["counters"]["serve.probe.queries"] == 1
    assert teng.quality is tqm and tsvc.quality is tqm
    jeng.quality = None


def test_fits_feed_the_margin_monitor_like_jax():
    """``fit_words``, ``fit_store`` and ``fit_log`` (``quality=``) feed the
    margins of the trained model over the reference's seeded row sample:
    the JAX hook on the same model, carried across, feeds the same."""
    from repro.learn.trainer import _observe_fit_margins
    from repro_torch.ann import CodeStore
    jc, tc, _, _, words = _case("2bit", 0.75, 100)
    rng = np.random.default_rng(4)
    y = np.where(rng.standard_normal(N) > 0, 1, -1)
    tw = torch.from_numpy(words.view(np.int32))
    log = MutableAnnEngine(tc, band_spec=None, tail_rows=256)
    ids = log.add_words(tw)
    log.delete(ids[::3])
    labels = {int(i): int(v) for i, v in zip(ids, y)}
    cfg = LearnConfig(steps=3, seed=5)
    fits = [(lambda q: fit_words(tw, y, tc, cfg, quality=q), words),
            (lambda q: fit_store(CodeStore.from_words(tw, 100, 2), y, tc,
                                 cfg, quality=q), words),
            (lambda q: fit_log(log.store, labels, tc, cfg, quality=q),
             log.store.live_words().numpy().view(np.uint32))]
    for fit, fit_rows in fits:
        jqm, tqm = _bundles(jc, tc, margin_sample=128)
        model = fit(tqm)
        jmodel = JaxModel(JaxFSpec(100, 2, 4), jnp.asarray(model.tables.numpy()),
                          jnp.asarray(model.bias.numpy()))
        _observe_fit_margins(jmodel, jnp.asarray(fit_rows), jqm, cfg.seed)
        assert tqm.margins.moments.n == jqm.margins.moments.n == 128
        np.testing.assert_allclose(tqm.margins.moments.mean,
                                   jqm.margins.moments.mean, rtol=1e-5)
        np.testing.assert_allclose(tqm.margins.moments.std,
                                   jqm.margins.moments.std, rtol=1e-5)
        assert tqm.drift.detector("margin_mean").n == 1
    off = tq.QualityMonitors(tc, tq.QualityConfig(),
                             registry=MetricsRegistry(enabled=False))
    fit_words(tw, y, tc, LearnConfig(steps=1), quality=off)
    assert off.margins.moments.n == 0


def test_service_quality_knobs_and_drift_flags(tmp_path):
    _, tc, corpus, queries, words = _case("2bit", 0.75, 100)
    eng = AnnEngine(tc, convert.store_from_numpy(words, 100, 2,
                                                 device="cpu"))
    svc = AnnService(eng, AnnServiceConfig(buckets=(8,)), quality=True)
    assert isinstance(svc.quality, tq.QualityMonitors)
    assert svc.quality.cfg == tq.QualityConfig() and eng.quality is svc.quality
    mon = tq.QualityMonitors(tc, tq.QualityConfig(sample_rate=1.0),
                             registry=svc.registry)
    svc2 = AnnService(eng, AnnServiceConfig(buckets=(8,)), quality=mon,
                      registry=svc.registry)
    assert svc2.quality is mon and eng.quality is mon
    for i in range(30):                  # a step the detector must catch
        mon.drift.update("margin_mean", 5.0 if i > 15 else 0.0)
    assert svc2._drift_flags
    svc2.submit(queries[0])
    svc2.flush()
    assert not svc2._drift_flags
    retained = svc2.sampler.retained_traces()
    assert retained and "margin_mean" in str(retained[-1])
    # with the rest of the health layer on: each shadow check reaches the
    # search quality SLO, and a drift alarm also dumps an incident bundle
    # carrying the quality report and the SLO state
    svc3 = AnnService(eng, AnnServiceConfig(buckets=(8,)), quality=mon,
                      registry=svc.registry, slo=True, resources=True,
                      incidents=str(tmp_path / "incidents"))
    assert svc3.incidents.quality is mon and svc3.incidents.slo is svc3.slo
    mon.offer_rows(np.arange(100), corpus[:100])
    seen = []
    observe = svc3.slo.observe_quality
    svc3.slo.observe_quality = lambda name, r, floor=None: (
        seen.append((name, r)), observe(name, r, floor))
    checks = mon.recall.queries
    for q in queries[:3]:
        svc3.submit(q)
    svc3.flush()
    assert mon.recall.queries == checks + 1
    assert len(seen) == 1 and seen[0][0] == "search" and 0 <= seen[0][1] <= 1
    led = svc3.slo.ledgers["search.quality"]
    assert (led.total, led.bad) == (1, int(seen[0][1] < 0.8))
    for i in range(30):
        mon.drift.update("margin_mean", 0.0 if i > 15 else 5.0)
    assert svc3.incidents.captured >= 1
    bundle = svc3.incidents.load()
    assert bundle["kind"] == "drift"
    assert bundle["context"]["series"] == "margin_mean"
    assert set(bundle["quality"]) == set(mon.report())
    assert bundle["slo"]["status"] == "ok"
    eng.quality = None
