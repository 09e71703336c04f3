"""Port parity for the serving slice: ``repro_torch.obs``, ``serve``,
``kernels.autotune``, the plain versions of TPU kernels 15-17, the bf16
draw and top_k above 2048.

Inputs are made with numpy from a seed and go through the JAX package
and the port on the CPU (the port's ``ops`` run their plain versions
there). Everything is compared bit for bit: the plain versions against
``repro.kernels.ref``, the kernel-stat snapshots and flight events of
the same ``ops`` calls, and the counters, histogram counts, flight
events and results of the same endpoint calls on both packages'
``AnnService`` (rho_hat within 1e-6, see ``_same_results``). The
service runs over engines that share R, rank tables
and classifier weights (``convert``), and every vector it codes is a
scaled basis vector s * e_i (s a power of two), whose projection
s * R[i] both packages compute exactly, so no code sits at a
sum-order-dependent bin edge. Searches take top_k = 65, so that the JAX
side selects with one ``lax.top_k`` (its blocked picking below 65
compiles slowly op by op, as ``tests/test_torch_index.py`` notes).
"""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.ann import AnnEngine as JaxEngine
from repro.ann import BandSpec as JaxBands
from repro.ann import CodeStore as JaxStore
from repro.core.sketch import CodedRandomProjection as JaxCRP
from repro.core.sketch import SketchConfig as JaxCfg
from repro.index import MutableAnnEngine as JaxMutable
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.learn import PackedFeatureSpec as JaxFSpec
from repro.learn import PackedLinearModel as JaxModel
from repro.obs import FlightRecorder as JaxFlight
from repro.obs import kernelstats as jks
from repro.obs import set_flight_recorder as jax_set_flight
from repro.rank import RankTables as JaxTables
from repro.serve import AnnService as JaxService
from repro.serve import AnnServiceConfig as JaxServiceCfg

from repro_torch import convert
from repro_torch.ann import AnnEngine, BandSpec
from repro_torch.core import packing, prng
from repro_torch.core.schemes import CodeSpec
from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
from repro_torch.index import MutableAnnEngine
from repro_torch.kernels import autotune, lut_topk, ops, ref
from repro_torch.learn import PackedFeatureSpec
from repro_torch.obs import (FlightRecorder, MetricsRegistry, Tracer,
                             set_flight_recorder, span)
from repro_torch.obs import kernelstats as tks
from repro_torch.rank import build_rank_tables
from repro_torch.serve import AnnService, AnnServiceConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; torch's intra-op threads would
    compete with them, so this file runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _words(rng, n, w):
    return rng.integers(0, 2 ** 32, (n, w), dtype=np.uint64).astype(np.uint32)


def _mask(rng, n, dead):
    live = rng.random(n) >= dead
    return packing.pack_bitmask(torch.from_numpy(live)).numpy().view(
        np.uint32), live


def _eq(got, want):
    got = tuple(np.asarray(g) for g in got)
    want = tuple(np.asarray(x) for x in want)
    for g, x in zip(got, want):
        assert g.dtype.itemsize == x.dtype.itemsize
        assert np.array_equal(g.view(x.dtype), x), (g, x)


# -- plain versions of TPU kernels 15-17 ---------------------------------------

@pytest.mark.parametrize("bits,tdtype,n,top_k", [
    (1, "float32", 0, 4), (2, "float32", 31, 40), (2, "bfloat16", 300, 7),
    (4, "float32", 33, 5), (8, "bfloat16", 70, 9)])
def test_lut_topk_plain_matches_jax(bits, tdtype, n, top_k):
    rng = np.random.default_rng(bits * 1000 + n)
    w, q = 2, 3
    fp = w * (32 // bits) << bits
    tab = rng.standard_normal((q, fp)).astype(np.float32)
    if n >= 300:                       # every row ties with row 0
        tab[:] = np.round(tab)
    db = _words(rng, n, w)
    jt = jnp.asarray(tab).astype(tdtype)
    tt = torch.from_numpy(tab).to(getattr(torch, tdtype))
    want = jref.packed_lut_topk_ref(jt, jnp.asarray(db), bits, top_k)
    _eq(ops.packed_lut_topk(tt, _i32(db), bits, top_k), want)
    for dead in (0.0, 0.1, 0.9, 1.0):
        vw, _ = _mask(rng, n, dead)
        want = jref.packed_lut_topk_masked_ref(jt, jnp.asarray(db),
                                               jnp.asarray(vw), bits, top_k)
        _eq(ops.packed_lut_topk_masked(tt, _i32(db), _i32(vw), bits, top_k),
            want)


def test_lut_topk_blocks_merge_stably():
    """Column blocks smaller than the corpus give the same bits."""
    rng = np.random.default_rng(4)
    tab = torch.from_numpy(np.round(rng.standard_normal((2, 128))).astype(
        np.float32))
    db = _i32(_words(rng, 500, 2))
    want = ref.packed_lut_topk_ref(tab, db, 2, 30)
    _eq(ref.packed_lut_topk_ref(tab, db, 2, 30, block_elems=2 * 37), want)


@pytest.mark.parametrize("w,bits,top_k,qbs,lists", [
    (16, 2, 10, (8, 16), True),      # the main path: k = 256, 2-bit
    (8, 1, 10, (8, 16), True),
    (32, 4, 10, (8,), True),         # k = 256 at 4 bits: 128 KB at QB 8
    (32, 4, 1500, (8,), False),      # its lists beside it: device memory
    (16, 2, 2049, (8, 16), False),   # above 2048: device memory
    (33, 4, 10, (), None),           # k = 264: the generic kernel's
    (64, 2, 10, (), None),           # k = 1024 at 2 bits: likewise
    (16, 8, 10, (), None), (16, 16, 10, (), None)])
def test_lut_topk_kernel_choice(w, bits, top_k, qbs, lists):
    """The fields kernel takes bits 1-4 where a block's tables fit 128 KB
    and its layout 227 KB; which QB fit, and where the lists live."""
    for qb in lut_topk.BLOCK_Q:
        got = lut_topk.fields_layout(w, bits, top_k, qb)
        assert (got is not None) == (qb in qbs)
        if got is not None:
            assert got[0] <= lut_topk.SMEM_BLOCK_MAX and got[1] == lists
            assert qb * (w * (32 // bits) << bits) * 4 <= 128 * 1024


def test_lut_topk_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="block_q"):
        lut_topk.plan(torch.float32, 9, 3000, 16, 2, 10, block_q=12,
                      n_ranges=4)
    with pytest.raises(ValueError, match="generic"):
        lut_topk.plan(torch.float32, 9, 3000, 16, 8, 10, block_q=16,
                      n_ranges=4)
    p = lut_topk.plan(torch.bfloat16, 9, 3000, 16, 16, 10, block_q=8,
                      n_ranges=4)
    assert (p["kernel"], p["grid"], p["n_ranges"]) == ("generic", (2, 4), 4)


@pytest.mark.parametrize("q_blocks,n,resident,want,waves", [
    (16, 4_194_304, 264, 33, 2),   # QB 16 at Q = 256, 2 blocks an SM
    (32, 4_194_304, 264, 33, 4),   # QB 8, 2 blocks an SM
    (16, 4_194_304, 396, 99, 4),   # 3 blocks an SM
    (1, 2081, 264, 9, 9 / 264),    # a range holds a tile: 9 ranges at most
    (600, 4_194_304, 264, 3, 1800 / 264)])  # more blocks than the card holds
def test_whole_waves(q_blocks, n, resident, want, waves):
    """The smallest S whose grid fills its last wave the most."""
    s = lut_topk.whole_waves(q_blocks, n, resident)
    assert s == want and q_blocks * s / resident == waves


@pytest.mark.parametrize("q,n,k", [(3, 0, 5), (4, 70, 33), (1, 9, 1)])
def test_collision_counts_plain_matches_jax(q, n, k):
    rng = np.random.default_rng(q * 100 + n)
    # any int32 values, sentinel-like ones included
    vals = np.array([-2, -1, 0, 1, 7, 2 ** 31 - 1, -2 ** 31], np.int32)
    cq = rng.choice(vals, (q, k))
    cdb = rng.choice(vals, (n, k))
    want = jref.collision_counts_ref(jnp.asarray(cq), jnp.asarray(cdb))
    got = ops.collision_counts(torch.from_numpy(cq), torch.from_numpy(cdb))
    _eq((got,), (want,))
    _eq((ref.collision_counts_ref(torch.from_numpy(cq), torch.from_numpy(cdb),
                                  block_elems=k * q),), (want,))


# -- top_k above 2048 ------------------------------------------------------------

def test_topk_above_2048_plain_matches_jax():
    rng = np.random.default_rng(2049)
    n, w, bits, k = 2100, 2, 2, 32
    wq, db = _words(rng, 2, w), _words(rng, n, w)
    vw, _ = _mask(rng, n, 0.1)
    tab = rng.standard_normal((2, w * 16 * 4)).astype(np.float32)
    jq, jdb, jt = jnp.asarray(wq), jnp.asarray(db), jnp.asarray(tab)
    tq, tdb, tt = _i32(wq), _i32(db), torch.from_numpy(tab)
    _eq(ops.packed_topk(tq, tdb, bits, k, 2049),
        jref.packed_topk_ref(jq, jdb, bits, k, 2049))
    _eq(ops.packed_lut_topk_masked(tt, tdb, _i32(vw), bits, 2049),
        jref.packed_lut_topk_masked_ref(jt, jdb, jnp.asarray(vw), bits, 2049))
    # scored fused at top_k 513: rerank_m = max(64, 4 * 513) = 2052
    _eq(ops.fused_scored_topk(tq, tt, tdb, bits, k, 2052, 513),
        jref.fused_scored_topk_ref(jq, jt, jdb, bits, k, 2052, 513))


# -- kernel stats ------------------------------------------------------------------

def _ops_sequence(O, arr, words):
    """One call of each of the 17 families through ``O`` (``jops`` or
    ``ops``) on the same values; ``arr`` makes a float or int array,
    ``words`` a uint32 word array, for that package. 8-bit fields keep
    the JAX side's field loops, and so its compiles, short."""
    rng = np.random.default_rng(17)
    q, n, d, k, bits, w = 3, 40, 16, 8, 8, 2
    spec = CodeSpec("uniform", 1.0)
    fp = w * 4 * 256
    x = arr(rng.standard_normal((q, d)).astype(np.float32))
    r = arr(rng.standard_normal((d, k)).astype(np.float32))
    z = arr(rng.standard_normal((q, k)).astype(np.float32))
    codes = arr(rng.integers(0, 12, (q, k)).astype(np.int32))
    cdb = arr(rng.integers(0, 12, (n, k)).astype(np.int32))
    wq, wdb = words(_words(rng, q, w)), words(_words(rng, n, w))
    vw = words(_mask(rng, n, 0.2)[0])
    tab = arr(rng.standard_normal((q, fp)).astype(np.float32))
    ctab = arr(rng.standard_normal((2, fp)).astype(np.float32))
    g = arr(rng.standard_normal((2, n)).astype(np.float32))
    cand = words(_words(rng, q * 6, w).reshape(q, 6, w))
    cvalid = arr(np.ones((q, 6), bool))
    O.coded_project(x, r, spec, impl="ref")
    O.encode_fused(x, r, spec, impl="ref")
    O.code_pack(z, spec, impl="ref")
    O.pack_codes(codes, bits, impl="ref")
    O.collision_counts(codes, cdb, impl="ref")
    O.packed_collision_counts(wq, wdb, bits, k, impl="ref")
    O.packed_topk(wq, wdb, bits, k, 5, impl="ref")
    O.packed_topk_masked(wq, wdb, vw, bits, k, 5, impl="ref")
    O.packed_lut_topk(tab, wdb, bits, 5, impl="ref")
    O.packed_lut_topk_masked(tab, wdb, vw, bits, 5, impl="ref")
    O.packed_lut_rerank(tab, cand, cvalid, bits, 4, impl="ref")
    O.fused_scored_topk(wq, tab, wdb, bits, k, 8, 5, impl="ref")
    O.fused_scored_topk_masked(wq, tab, wdb, vw, bits, k, 8, 5, impl="ref")
    O.packed_linear_fwd(ctab, wdb, bits, impl="ref")
    O.packed_linear_fwd_masked(ctab, wdb, vw, bits, impl="ref")
    O.packed_linear_bwd(g, wdb, bits, impl="ref")
    O.packed_linear_bwd_masked(g, wdb, vw, bits, impl="ref")


def test_kernelstats_match_jax(monkeypatch):
    """The same 17 dispatches give the same snapshot and the same kernel
    flight events. The stats are taken at dispatch, from shapes, so the
    JAX side's plain versions are stubbed (their outputs are held to the
    port's by the other tests of this file and of the port's)."""
    for name in dir(jref):
        if name.endswith("_ref"):
            monkeypatch.setattr(jref, name, lambda *a, **kw: None)
    jprev = jks.set_kernel_stats(jks.KernelStats())
    tprev = tks.set_kernel_stats(tks.KernelStats())
    jfr, tfr = JaxFlight(), FlightRecorder()
    jprev_fr, tprev_fr = jax_set_flight(jfr), set_flight_recorder(tfr)
    try:
        _ops_sequence(jops, jnp.asarray, jnp.asarray)
        _ops_sequence(ops, torch.from_numpy, _i32)
        jsnap = jks.get_kernel_stats().snapshot()
        tsnap = tks.get_kernel_stats().snapshot()
        assert len(tsnap) == 17 and tsnap == jsnap
        assert [e["op"] for e in tfr.tail()] == [e["op"] for e in jfr.tail()]
        roof = tks.roofline_table()
        assert roof["packed_topk"]["t_memory_s"] == \
            tsnap["packed_topk"]["hbm_bytes"] / 3.35e12
        assert all(v["traced_calls"] == 0 for v in tsnap.values())
    finally:
        jks.set_kernel_stats(jprev)
        tks.set_kernel_stats(tprev)
        jax_set_flight(jprev_fr)
        set_flight_recorder(tprev_fr)


# -- the service ---------------------------------------------------------------------

D, K, BITS = 32, 64, 2


def _basis_rows(idx, scales):
    """Rows s * e_i: projections s * R[i], exact in both packages."""
    x = np.zeros((len(idx), D), np.float32)
    x[np.arange(len(idx)), idx] = scales
    return x


def _traffic_rows(rng, n):
    return _basis_rows(rng.integers(0, D, n),
                       rng.choice([-4.0, -1.0, -0.25, 0.5, 2.0], n))


def _sketchers():
    cfg = dict(k=K, scheme="2bit", w=0.75, seed=3)
    jc = JaxCRP(JaxCfg(**cfg), D)
    tc = convert.sketch_from_numpy(
        SketchConfig(**cfg), D, np.asarray(jc.stream_encoder().r_matrix()),
        device="cpu")
    return jc, tc


def _models():
    rng = np.random.default_rng(8)
    fs = PackedFeatureSpec(K, BITS, 4)
    tables = rng.standard_normal((1, fs.table_width)).astype(np.float32)
    bias = np.array([0.125], np.float32)
    return (JaxModel(JaxFSpec(K, BITS, 4), jnp.asarray(tables),
                     jnp.asarray(bias)),
            convert.linear_model_from_numpy(fs, tables, bias, device="cpu"))


def _events(fr):
    return [(e["op"], e["batch"], e["generation"], e["outcome"])
            for e in fr.tail() if not e["op"].startswith("kernel.")]


def _metrics(reg):
    snap = reg.snapshot()
    return (snap["counters"], snap["gauges"],
            {n: h["count"] for n, h in snap["histograms"].items()})


def _drive(svc, rng_seed, mutable):
    """The endpoint sequence; returns every result, in order."""
    rng = np.random.default_rng(rng_seed)
    out = []
    pool = _traffic_rows(rng, 12)
    if mutable:
        out.append(svc.bulk_load(_traffic_rows(rng, 100), chunk_rows=64))
    svc.warmup(D)
    for size in (1, 3, 11):
        picks = rng.integers(0, len(pool), size)
        tickets = [svc.submit(pool[i]) for i in picks]
        res = svc.flush()
        out += [res[t] for t in tickets]
    if mutable:
        out.append(svc.add(_traffic_rows(rng, 40)))
        tickets = [svc.submit(pool[i]) for i in range(5)]
        res = svc.flush()
        out += [res[t] for t in tickets]
        out.append(svc.delete(np.arange(0, 100, 7)))
        out.append(svc.upsert(np.arange(1, 40, 9), _traffic_rows(rng, 5)))
        from repro.index import CompactionPolicy as JP
        from repro_torch.index import CompactionPolicy as TP
        pol = (TP if isinstance(svc, AnnService) else JP)(target_rows=100)
        out.append(svc.compact(pol)["rows_dropped"])
        tickets = [svc.submit(pool[i]) for i in range(9)]
        res = svc.flush()
        out += [res[t] for t in tickets]
    out.append(svc.probe_search(pool[0]))
    if mutable:
        x = _traffic_rows(rng, 10)
        out.append(svc.classify(x))
        out.append(svc.probe_classify(x[:3]))
    return out


def _same_results(got, want):
    """Ids, labels, margins and endpoint returns bit for bit; rho_hat
    within 1e-6: the count-ranked estimator interpolates in float64 in
    the port and in float32 in JAX (``tests/test_torch_index.py``)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            for a, b in zip(g, w):
                a, b = np.asarray(a), np.asarray(b)
                assert a.shape == b.shape, (a, b)
                if b.dtype == np.float32 and b.ndim == 1:
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
                else:
                    assert np.array_equal(a.astype(b.dtype), b), (a, b)
        else:
            assert np.array_equal(np.asarray(g), np.asarray(w)), (g, w)


@pytest.mark.parametrize("mutable", [True, False],
                         ids=["mutable-count", "immutable-scored"])
def test_service_matches_jax(mutable):
    jc, tc = _sketchers()
    jm, tm = _models()
    if mutable:
        jeng = JaxMutable(jc, band_spec=None, tail_rows=64)
        teng = MutableAnnEngine(tc, band_spec=None, tail_rows=64)
        kw = dict(buckets=(1, 8), top_k=65)
    else:
        rng = np.random.default_rng(11)
        words = np.asarray(jc.sketch(jnp.asarray(_traffic_rows(rng, 300))))
        # one set of tables for both (the port builds them faster)
        tables = build_rank_tables(tc)
        teng = AnnEngine(tc, convert.store_from_numpy(words, K, BITS,
                                                      device="cpu"),
                         BandSpec(8, 4), rank_tables=tables)
        jeng = JaxEngine(jc, JaxStore.from_words(words, K, BITS),
                         JaxBands(8, 4), rank_tables=JaxTables(
                             jc.spec, K, jnp.asarray(tables.pair.numpy()),
                             jnp.asarray(tables.rho_grid.numpy()),
                             jnp.asarray(tables.score_grid.numpy())))
        kw = dict(buckets=(1, 8), scored=True, top_k=65)
    jfr, tfr = JaxFlight(), FlightRecorder()
    jdef, tdef = JaxFlight(), FlightRecorder()
    jprev, tprev = jax_set_flight(jdef), set_flight_recorder(tdef)
    try:
        jsvc = JaxService(jeng, JaxServiceCfg(**kw), classifier=jm,
                          flight=jfr)
        tsvc = AnnService(teng, AnnServiceConfig(**kw), classifier=tm,
                          flight=tfr)
        want = _drive(jsvc, 5, mutable)
        got = _drive(tsvc, 5, mutable)
    finally:
        jax_set_flight(jprev)
        set_flight_recorder(tprev)
    _same_results(got, want)
    jcnt, jg, jh = _metrics(jsvc.registry)
    tcnt, tg, th = _metrics(tsvc.registry)
    assert tcnt == jcnt and th == jh and tg == jg
    assert tcnt["serve.cache_hits"] > 0 and tcnt["serve.probe.queries"] == 1
    if mutable:
        assert tcnt["serve.cache_invalidations"] == 2
        assert _metrics(teng.store.registry)[0] == \
            _metrics(jeng.store.registry)[0]
    assert _events(tfr) == _events(jfr)
    assert _events(tdef) == _events(jdef)
    assert dict(tsvc.stats) == dict(jsvc.stats)


def test_service_refuses_the_health_layer():
    _, tc = _sketchers()
    eng = MutableAnnEngine(tc, tail_rows=64)
    for knob in ("slo", "resources", "incidents"):
        with pytest.raises(NotImplementedError, match="item 10"):
            AnnService(eng, **{knob: True})
    # the quality knob is ported (tests/test_torch_health.py)
    assert AnnService(eng, quality=True).quality is eng.quality
    with pytest.raises(TypeError, match="immutable"):
        AnnService(AnnEngine(tc, convert.store_from_numpy(
            np.zeros((1, 4), np.uint32), K, BITS, device="cpu"))).add(
                np.zeros((1, D), np.float32))


def test_deep_tracer_syncs_the_flush_and_dumps_json(tmp_path):
    _, tc = _sketchers()
    eng = MutableAnnEngine(tc, tail_rows=64)
    svc = AnnService(eng, AnnServiceConfig(buckets=(1, 8)))
    svc.bulk_load(_traffic_rows(np.random.default_rng(0), 50))
    with Tracer() as tr:
        svc.submit(_basis_rows([1], [2.0])[0])
        svc.flush()
        with span("outside", sync=False):
            pass
    flush = [e for e in tr.events if e["name"] == "serve.flush"]
    assert flush and flush[0]["args"]["sync"] == "device"
    assert [e for e in tr.events if e["name"] == "outside"][0]["args"][
        "sync"] == "async"
    assert {e["name"] for e in tr.events} >= {"search.coarse", "serve.flush"}
    path = tr.dump(str(tmp_path / "trace.json"))
    assert json.load(open(path))["traceEvents"]


def test_disabled_registry_hands_out_null_metrics():
    reg = MetricsRegistry(enabled=False)
    reg.counter("a").inc(5)
    reg.histogram("h").observe(1.0)
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


# -- autotune -------------------------------------------------------------------

def test_autotune_keys_filter_and_json_round_trip(tmp_path):
    assert autotune.shape_bucket(n=100000, q=256) == "n131072-q256"
    assert autotune.shape_bucket(q=0, n=1) == "n1-q0"
    cache = autotune.AutotuneCache()
    autotune.record_config("packed_topk", torch.int32,
                           dict(q=256, n=100000, w=16, top_k=10),
                           {"n_ranges": 32}, cache=cache)
    with pytest.raises(ValueError, match="non-sweepable"):
        cache.put("cuda", "packed_linear_bwd", "b", "float32",
                  {"block_n": 256})
    with pytest.raises(ValueError, match="non-sweepable"):
        cache.put("cuda", "packed_topk", "b", "int32", {"block_q": 8})
    cache._configs["cuda|packed_topk|x|int32"] = {"block_n": 7}
    assert cache.get("cuda", "packed_topk", "x", "int32") is None
    path = cache.save(str(tmp_path / "tune.json"))
    loaded = autotune.AutotuneCache(path)
    assert len(loaded) == len(cache) == 2
    prev = autotune.set_cache(loaded)
    try:
        assert autotune.lookup("packed_topk", torch.int32, q=200, n=70000,
                               w=16, top_k=9) == {"n_ranges": 32}
        assert autotune.lookup("packed_topk", torch.int32, q=512, n=70000,
                               w=16, top_k=9) == {}
        assert ops._tuned("packed_topk", torch.int32, {"n_ranges": 4},
                          q=200, n=70000, w=16, top_k=9) == {"n_ranges": 4}
        assert ops._tuned("packed_topk", torch.int32, {"n_ranges": None},
                          q=200, n=70000, w=16, top_k=9) == {"n_ranges": 32}
    finally:
        autotune.set_cache(prev)


def test_autotune_tune_with_injected_measure():
    cache = autotune.AutotuneCache()
    seen = []

    def measure(run, config):
        seen.append(config)
        if not config:               # the kernel's defaults, timed first
            return 10 ** 6
        if config["block_q"] == 128:
            raise ValueError("refused before launch")
        return config["block_q"] * 1000 + config["block_n"]

    best = autotune.tune("collision_counts", lambda c: None, torch.int32,
                         dict(q=256, n=4096), measure=measure, cache=cache)
    assert best == {"block_q": 32, "block_n": 32} and len(seen) == 10
    assert seen == [{}] + autotune.candidate_configs("collision_counts")
    assert cache.get("cuda", "collision_counts", "n4096-q256",
                     "int32") == best
    # the defaults win a tie, and a winning default is cached as such
    assert autotune.tune("packed_collision_counts", lambda c: None,
                         torch.int32, dict(q=4, n=10, w=2), cache=cache,
                         measure=lambda run, c: 1.0) == {}
    assert cache.get("cuda", "packed_collision_counts", "n16-q4-w2",
                     "int32") is None
    got = autotune.tune_search_ops(
        n=100, w=2, bits=2, k=32, q=4, cache=cache,
        measure=lambda run, c: (run(c), -c.get("n_ranges", 0))[1])
    assert set(got) == {"packed_topk", "packed_topk_masked",
                        "fused_scored_topk", "fused_scored_topk_masked",
                        "packed_lut_topk"}
    assert got == {op: {"n_ranges": max(autotune.SWEEPS[op]["n_ranges"])}
                   for op in got}


def test_autotune_is_a_noop_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert autotune.tune("packed_topk", lambda c: 1 / 0, torch.int32,
                         dict(q=1)) == {}
    assert autotune.tune_search_ops(n=10, w=2, bits=2, k=32) == {}


# -- the bf16 draw ---------------------------------------------------------------

def test_bf16_draw_matches_jax():
    key = jax.random.fold_in(jax.random.PRNGKey(5), 9)
    want = np.asarray(jax.random.normal(key, (4096, 256), jnp.bfloat16))
    got = prng.normal(prng.fold_in(prng.PRNGKey(5), 9), (4096, 256),
                      dtype=torch.bfloat16)
    assert np.array_equal(got.view(torch.int16).numpy(),
                          want.view(np.int16))
    # all 128 uniforms: the unit holds each index; each maps alike
    bits = prng.random_bits(prng.fold_in(prng.PRNGKey(5), 9), (4096, 256))
    m = ((bits >> 1) & 127).numpy()
    assert np.unique(m).size == 128
    table = prng.bf16_normal_of_index(torch.arange(128)).view(torch.int16)
    assert np.array_equal(table.numpy()[m], want.view(np.int16))


def test_bf16_sketch_matches_jax():
    """R, offsets and the codes of every regime against the reference's
    bf16 sketch (bit-exact here; the card's GEMM may differ at bin edges
    within bf16 rounding)."""
    from repro.encode.encoder import StreamingEncoder as JaxEnc
    from repro.encode.sparse import CsrMatrix as JaxCsr
    from repro_torch.encode import CsrMatrix, StreamingEncoder
    cfg = dict(k=K, dtype="bfloat16", scheme="offset", w=0.75, r_unit=256)
    d = 600
    jc = JaxCRP(JaxCfg(**cfg), d)
    tc = CodedRandomProjection(SketchConfig(**cfg), d, device="cpu")
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((64, d)) / np.sqrt(d)).astype(np.float32)
    xs = x * (rng.random(x.shape) < 0.05)
    # R resident (the fused kernels over a bf16 R), then streamed (bf16
    # accumulation) and CSR (float32 accumulation of bf16 units)
    je, te = JaxEnc(jc), StreamingEncoder(tc)
    assert np.array_equal(_u32(te.encode_packed(x)),
                          np.asarray(je.encode_packed(jnp.asarray(x))))
    assert np.array_equal(te.encode_codes(x).numpy(),
                          np.asarray(je.encode_codes(jnp.asarray(x))))
    je = JaxEnc(jc, r_cap_elems=256 * K)
    te = StreamingEncoder(tc, r_cap_elems=256 * K)
    assert np.array_equal(_u32(te.encode_packed(x)),
                          np.asarray(je.encode_packed(jnp.asarray(x))))
    assert np.array_equal(
        _u32(te.encode_packed(CsrMatrix.from_dense(xs))),
        np.asarray(je.encode_packed(JaxCsr.from_dense(xs))))
    assert tc.stream_encoder().r_matrix().dtype == torch.bfloat16
    assert np.array_equal(
        tc.stream_encoder().r_matrix().view(torch.int16).numpy(),
        np.asarray(jc.stream_encoder().r_matrix()).view(np.int16))
    assert np.array_equal(tc._offsets.view(torch.int16).numpy(),
                          np.asarray(jc._offsets).view(np.int16))
