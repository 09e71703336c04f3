"""Port parity for the mutable index (``repro_torch.index``), its masked
plain versions, checkpoints, snapshots and the ingest pipeline.

One seeded lifecycle of add, delete, upsert and compact runs through the
JAX ``MutableAnnEngine`` and the port's on the same codes and ids, both
scoring with one set of rank tables. Every search mode then agrees: ids bit
for bit, rho_hat within 1e-4 (float32 interpolation). The port also
equals a fresh port ``AnnEngine`` over ``live_words()``. Snapshots
restore across the two packages in both directions.

Sizes follow ``tests/test_index.py``: k = 64, 2-bit codes, 32-row
tails, a few hundred rows. The count-ranked modes take top_k = 65 and
the scored ones rerank_m = 100, so that the JAX side selects with one
``lax.top_k`` (its blocked picking compiles slowly op by op).
"""
import functools
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.ann import BandSpec as JaxBands
from repro.ann import CodeStore as JaxStore
from repro.ann.engine import SearchConfig as JaxSearchConfig
from repro.checkpoint import restore_checkpoint as jax_restore_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.core import packing as jax_packing
from repro.core.sketch import CodedRandomProjection as JaxCRP
from repro.core.sketch import SketchConfig as JaxCfg
from repro.encode import CsrMatrix as JaxCsr
from repro.encode import IngestPipeline as JaxPipeline
from repro.index import CompactionPolicy as JaxPolicy
from repro.index import MutableAnnEngine as JaxMutable
from repro.index import SegmentLogStore as JaxLog
from repro.index import compact as jax_compact
from repro.index import plan_compaction as jax_plan
from repro.index.segment_log import _np_pack_bitmask as jax_np_pack_bitmask
from repro.kernels import ref as jax_ref
from repro.rank import RankTables as JaxTables
from repro_torch import convert
from repro_torch.ann import AnnEngine, BandSpec, CodeStore, SearchConfig
from repro_torch.checkpoint import (ShapeDtype, read_manifest,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.core import packing
from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
from repro_torch.encode import CsrMatrix, IngestPipeline
from repro_torch.index import (CompactionPolicy, MutableAnnEngine,
                               SegmentLogStore, compact, plan_compaction,
                               restore_index)
from repro_torch.index.segment_log import _np_pack_bitmask
from repro_torch.kernels import ops, ref
from repro_torch.rank import build_rank_tables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; torch's intra-op threads would
    compete with them, so this file runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


D, K, BITS, TAIL = 16, 64, 2, 32


def _i32(a):
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- bitmask helpers and the masked plain versions ----------------------------

@pytest.mark.parametrize("n", [1, 31, 33, 100])
def test_bitmask_helpers_match_jax(n):
    flags = np.random.default_rng(n).random(n) < 0.5
    got = packing.pack_bitmask(torch.from_numpy(flags))
    want = np.asarray(jax_packing.pack_bitmask(jnp.asarray(flags)))
    assert packing.bitmask_width(n) == jax_packing.bitmask_width(n) == \
        got.shape[0]
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(_np_pack_bitmask(flags),
                                  jax_np_pack_bitmask(flags))
    np.testing.assert_array_equal(packing.unpack_bitmask(got, n).numpy(),
                                  flags)


def _masks(rng, n):
    """Validity masks over n rows: random 75 % live, none live, all live."""
    return [rng.random(n) < 0.75, np.zeros(n, bool), np.ones(n, bool)]


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_masked_plain_versions_match_jax(bits, dtype):
    """N = 130 rows (a ragged last mask word) with planted ties; the
    top-k above the live count, rerank_m = 70 below it but for the
    all-dead mask."""
    rng = np.random.default_rng(bits * 7 + len(dtype))
    k, n, q = 33, 130, 5
    p = 1 << bits
    cq, cd = rng.integers(0, p, (q, k)), rng.integers(0, p, (n, k))
    cd[[7, 40, 99]] = cq[0]
    wq = np.asarray(jax_packing.pack_codes(jnp.asarray(cq), bits))
    wd = np.asarray(jax_packing.pack_codes(jnp.asarray(cd), bits))
    fp = wq.shape[1] * (32 // bits) * p
    if dtype == "int8":
        tab = rng.integers(-127, 128, (q, fp)).astype(np.int8)
        scl = (2.0 ** rng.integers(-8, 2, (q, wq.shape[1]))).astype(np.float32)
        jt, tt, js, ts = (jnp.asarray(tab), torch.from_numpy(tab),
                          jnp.asarray(scl), torch.from_numpy(scl))
    else:
        tab = rng.standard_normal((q, fp)).astype(np.float32)
        jt, tt, js, ts = jnp.asarray(tab), torch.from_numpy(tab), None, None
        if dtype == "bf16":
            jt, tt = jt.astype(jnp.bfloat16), tt.to(torch.bfloat16)
    jq, jd, tq, td = jnp.asarray(wq), jnp.asarray(wd), _i32(wq), _i32(wd)
    for live in _masks(rng, n):
        jv = jax_packing.pack_bitmask(jnp.asarray(live))
        tv = packing.pack_bitmask(torch.from_numpy(live))
        got = ops.packed_topk_masked(tq, td, tv, bits, k, 140)
        _eq(got, jax_ref.packed_topk_masked_ref(jq, jd, jv, bits, k, 140))
        assert not set(got[1][got[0] >= 0].tolist()) & \
            set(np.flatnonzero(~live).tolist())
        _eq(ops.fused_scored_topk_masked(tq, tt, td, tv, bits, k, 70, 10,
                                         scales=ts),
            jax_ref.fused_scored_topk_masked_ref(jq, jt, jd, jv, bits, k, 70,
                                                 10, scales=js))
        if dtype != "int8":
            _eq(ref.two_stage_scored_masked_ref(tq, tt, td, tv, bits, k, 70,
                                                10),
                jax_ref.two_stage_scored_masked_ref(jq, jt, jd, jv, bits, k,
                                                    70, 10))


# -- one seeded lifecycle through both packages -------------------------------

SCORED = dict(top_k=7, rerank_m=100, scored=True)
MODES = {
    "exact": dict(top_k=65),
    "fused-f32": dict(table_dtype="f32", **SCORED),
    "fused-bf16": dict(table_dtype="bf16", **SCORED),
    "fused-int8": dict(table_dtype="int8", **SCORED),
    "two-stage": dict(fused=False, **SCORED),
    "lsh": dict(mode="lsh", n_probes=1, top_k=65),
    "lsh-scored": dict(mode="lsh", n_probes=1, min_bands=2, **SCORED),
}


@functools.lru_cache(maxsize=None)
def _lifecycle():
    """The JAX engine and the port's after one seeded run of 14 adds,
    deletes, upserts and compactions on the same codes, the query codes,
    and every id deleted and not re-added."""
    cfg = dict(k=K, scheme="2bit", w=0.75)
    jc = JaxCRP(JaxCfg(**cfg), D)
    tc = CodedRandomProjection(SketchConfig(**cfg), D, device="cpu")
    # one set of tables for both (the port's: its float64 build is the
    # quicker); given equal tables, scores are bit-exact
    tt = build_rank_tables(tc)
    jt = JaxTables(spec=jc.spec, k=K, pair=jnp.asarray(tt.pair.numpy()),
                   rho_grid=jnp.asarray(tt.rho_grid.numpy()),
                   score_grid=jnp.asarray(tt.score_grid.numpy()))
    je = JaxMutable(jc, band_spec=JaxBands(16, 4), tail_rows=TAIL,
                    rank_tables=jt)
    te = MutableAnnEngine(tc, band_spec=BandSpec(16, 4), tail_rows=TAIL,
                          rank_tables=tt)
    # this seed runs 7 adds (240 rows), 3 deletes, 2 upserts and
    # 2 compactions, the first after a delete
    rng = np.random.default_rng(1394)
    live, dead = [], set()
    for _ in range(14):
        op = rng.choice(["add", "delete", "upsert", "compact"],
                        p=[0.5, 0.25, 0.15, 0.1])
        if op == "add" or not live:
            codes = rng.integers(0, 4, (int(rng.choice([5, 17, 40])), K))
            ids = je.add_codes(jnp.asarray(codes, jnp.int32))
            np.testing.assert_array_equal(
                te.add_codes(torch.from_numpy(codes).to(torch.int32)), ids)
            live += ids.tolist()
        elif op == "delete":
            kill = set(rng.choice(len(live), size=min(len(live),
                                                      int(rng.integers(1, 10))),
                                  replace=False).tolist())
            ids = [x for i, x in enumerate(live) if i in kill]
            assert je.delete(ids) == te.delete(ids) == len(ids)
            live = [x for i, x in enumerate(live) if i not in kill]
            dead |= set(ids)
        elif op == "upsert":
            m = min(len(live), 3)
            pick = np.asarray(live)[rng.choice(len(live), m, replace=False)]
            codes = rng.integers(0, 4, (m, K))
            je.upsert_codes(pick, jnp.asarray(codes, jnp.int32))
            te.upsert_codes(pick, torch.from_numpy(codes).to(torch.int32))
        else:
            assert je.compact(JaxPolicy(target_rows=4 * TAIL)) == \
                te.compact(CompactionPolicy(target_rows=4 * TAIL))
    q_codes = rng.integers(0, 4, (8, K)).astype(np.int32)
    q_codes[:3] = np.asarray(te.store.live_codes()[[0, 50, -1]])  # exact hits
    return je, te, q_codes, frozenset(dead)


@functools.lru_cache(maxsize=None)
def _jax_result(mode):
    je, _, q_codes, _ = _lifecycle()
    ids, rho = je.search_codes(jnp.asarray(q_codes),
                               JaxSearchConfig(chunk_q=8, **MODES[mode]))
    return np.asarray(ids), np.asarray(rho)


def _search(engine, q_codes, mode, **kw):
    return engine.search_codes(torch.from_numpy(q_codes),
                               SearchConfig(chunk_q=8, **{**MODES[mode], **kw}))


@pytest.mark.parametrize("mode", list(MODES))
def test_lifecycle_search_matches_jax(mode):
    _, te, q_codes, dead = _lifecycle()
    ji, jr = _jax_result(mode)
    ti, tr = _search(te, q_codes, mode)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(tr.numpy(), jr, rtol=0, atol=1e-4)
    assert not set(ti.numpy().ravel().tolist()) & dead
    if mode in ("exact", "fused-f32", "two-stage"):
        assert ti[:3, 0].tolist() == te.store.live_ids()[[0, 50, -1]].tolist()


@pytest.mark.parametrize("mode", list(MODES))
def test_lifecycle_search_matches_fresh_engine(mode):
    """Bit for bit against a fresh immutable engine over ``live_words()``,
    rows mapped through ``live_ids()``. Scored search takes its coarse
    top-m per segment, so there rerank_m covers every live row."""
    _, te, q_codes, _ = _lifecycle()
    kw = dict(rerank_m=2048) if MODES[mode].get("scored") else {}
    fresh = AnnEngine(te.sketcher, CodeStore(words=te.store.live_words(),
                                             k=K, bits=BITS),
                      te.band_spec, rank_tables=te.rank_tables)
    rows, want_rho = _search(fresh, q_codes, mode, **kw)
    live_ids = torch.from_numpy(te.store.live_ids())
    want = torch.where(rows < 0, -1, live_ids[rows.clamp(min=0).long()])
    ids, rho = _search(te, q_codes, mode, **kw)
    assert torch.equal(ids, want.to(torch.int32))
    assert torch.equal(rho, want_rho)


def test_scored_coarse_stage_is_per_segment():
    """Below full coverage, scored search differs from the whole-store
    engine, in the port as in the reference (whose search it equals, see
    above): each segment keeps its own coarse top-m."""
    _, te, q_codes, _ = _lifecycle()
    fresh = AnnEngine(te.sketcher, CodeStore(words=te.store.live_words(),
                                             k=K, bits=BITS),
                      te.band_spec, rank_tables=te.rank_tables)
    live_ids = torch.from_numpy(te.store.live_ids())
    rows, _ = _search(fresh, q_codes, "fused-f32", rerank_m=16)
    whole = torch.where(rows < 0, -1, live_ids[rows.clamp(min=0).long()])
    ids, _ = _search(te, q_codes, "fused-f32", rerank_m=16)
    assert bool((ids != whole).any(dim=1).all())


def test_lifecycle_state_matches_jax():
    """Segments, id map, stats, generation and next_id agree, and so do
    each segment's masked collision counts."""
    je, te, q_codes, _ = _lifecycle()
    assert te.store.stats() == je.store.stats()
    assert te.store.next_id == je.store.next_id
    assert te.generation == je.generation
    np.testing.assert_array_equal(te.store.live_ids(), je.store.live_ids())
    tq = ops.pack_codes(torch.from_numpy(q_codes), BITS)
    jq = jax_packing.pack_codes(jnp.asarray(q_codes), BITS)
    for ts, js in zip(te.store.segments(), je.store.segments()):
        np.testing.assert_array_equal(ts.words.numpy().view(np.uint32),
                                      np.asarray(js.words))
        np.testing.assert_array_equal(ts.hashes.numpy().view(np.uint32),
                                      np.asarray(js.hashes))
        np.testing.assert_array_equal(ts.valid, js.valid)
        np.testing.assert_array_equal(ts.ids, js.ids)
        assert (ts.live, ts.length) == (js.live, js.length)
        _eq(ops.packed_topk_masked(tq, ts.words, ts.valid_dev(), BITS, K, 65),
            jax_ref.packed_topk_masked_ref(jq, js.words, js.valid_dev(), BITS,
                                           K, 65))
    some = te.store.live_ids()[::37]
    np.testing.assert_array_equal(te.codes_for_ids(some),
                                  np.asarray(je.codes_for_ids(some)))


def test_mutation_errors_match_jax():
    """Strict deletes, duplicate ids, ids past int32 and bad upserts
    raise in both packages and change nothing."""
    rng = np.random.default_rng(37)
    codes = rng.integers(0, 4, (10, K)).astype(np.int32)
    js = JaxLog(K, BITS, tail_rows=TAIL)
    ts = SegmentLogStore(K, BITS, tail_rows=TAIL, device="cpu")
    ids = js.add_codes(jnp.asarray(codes))
    np.testing.assert_array_equal(ts.add_codes(torch.from_numpy(codes)), ids)
    two = rng.integers(0, 4, (2, K)).astype(np.int32)
    bad = [
        (KeyError, lambda s, c: s.delete([int(ids[1]), 999])),
        (ValueError, lambda s, c: s.upsert_codes([int(ids[2])],
                                                 c(np.zeros((1, 5), np.int32)))),
        (ValueError, lambda s, c: s.add_codes(c(two), ids=np.asarray([50, 50]))),
        (ValueError, lambda s, c: s.upsert_codes(np.asarray([int(ids[3])] * 2),
                                                 c(two))),
        (ValueError, lambda s, c: s.upsert_codes(
            np.asarray([int(ids[4]), 2 ** 40]), c(two))),
        (ValueError, lambda s, c: s.add_codes(c(two[:1]),
                                              ids=np.asarray([int(ids[5])]))),
    ]
    for err, call in bad:
        with pytest.raises(err):
            call(js, jnp.asarray)
        with pytest.raises(err):
            call(ts, torch.from_numpy)
        assert ts.stats() == js.stats()
    assert ts.delete([999, int(ids[0])], strict=False) == \
        js.delete([999, int(ids[0])], strict=False) == 1
    assert ts.stats() == js.stats() and ts.next_id == js.next_id == 10
    np.testing.assert_array_equal(ts.live_ids(), js.live_ids())


@pytest.mark.parametrize("kind", ["segment_log", "code_store"])
def test_ingest_pipeline_matches_jax(kind):
    """Dense rows through both pipelines on the same R: equal words and
    ids; a clashing id fails the whole batch before the first chunk."""
    jc = _lifecycle()[0].sketcher
    tc = convert.sketch_from_numpy(SketchConfig(k=K, scheme="2bit", w=0.75),
                                   D, np.asarray(jc.stream_encoder().r_matrix()),
                                   device="cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((300, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    w = packing.packed_width(K, BITS)
    if kind == "segment_log":
        ids = rng.permutation(1000)[:300]
        jstore = JaxLog(K, BITS, band_spec=JaxBands(8, 4), tail_rows=128)
        tstore = SegmentLogStore(K, BITS, band_spec=BandSpec(8, 4),
                                 tail_rows=128, device="cpu")
    else:
        ids = None
        jstore = JaxStore.from_words(np.zeros((0, w), np.uint32), K, BITS)
        tstore = CodeStore(words=torch.zeros((0, w), dtype=torch.int32),
                           k=K, bits=BITS)
    jp = JaxPipeline(jc.stream_encoder(), jstore, chunk_rows=64)
    tp = IngestPipeline(tc.stream_encoder(), tstore, chunk_rows=64)
    np.testing.assert_array_equal(tp.ingest(x, ids=ids), jp.ingest(x, ids=ids))
    assert dict(tp.stats) == dict(jp.stats)
    if kind == "segment_log":
        np.testing.assert_array_equal(
            tstore.live_words().numpy().view(np.uint32),
            np.asarray(jstore.live_words()))
        np.testing.assert_array_equal(tstore.live_ids(), jstore.live_ids())
        before = tstore.stats()
        with pytest.raises(ValueError, match="already live"):
            tp.ingest(x[:100], ids=np.arange(2000, 2100).tolist()[:-1]
                      + [int(ids[0])])
        assert tstore.stats() == before
    else:
        np.testing.assert_array_equal(tp.store.words.numpy().view(np.uint32),
                                      np.asarray(jp.store.words))
    # CSR rows, as the reference takes them: the same words again
    np.testing.assert_array_equal(
        tp.ingest(CsrMatrix.from_dense(x[:40])),
        jp.ingest(JaxCsr.from_dense(x[:40])))
    words = (lambda st: st.live_words()) if kind == "segment_log" else \
        (lambda st: st.words)
    np.testing.assert_array_equal(words(tp.store).numpy().view(np.uint32),
                                  np.asarray(words(jp.store)))


# -- snapshots and checkpoints across the two packages ------------------------

SNAP_MODES = ("exact", "fused-f32", "two-stage", "lsh")


def test_snapshot_written_by_jax_restores_in_port(tmp_path):
    je, te, q_codes, _ = _lifecycle()
    je.save(str(tmp_path), 3)
    restored = MutableAnnEngine.restore(te.sketcher, str(tmp_path))
    restored._rank_tables = te.rank_tables
    assert restored.store.stats() == {**je.store.stats(),
                                      "generation": restored.generation}
    assert restored.store.next_id == je.store.next_id
    for mode in SNAP_MODES:
        ids, rho = _search(restored, q_codes, mode)
        ji, jr = _jax_result(mode)
        np.testing.assert_array_equal(ids.numpy(), ji)
        np.testing.assert_allclose(rho.numpy(), jr, rtol=0, atol=1e-4)
    # ingest resumes where the tail stopped, with fresh ids
    new = restored.add_codes(torch.zeros((3, K), dtype=torch.int32))
    assert new.min() == je.store.next_id


def test_snapshot_written_by_port_restores_in_jax(tmp_path):
    je, te, q_codes, _ = _lifecycle()
    te.store.impl = "kernel"         # maps to the reference's "pallas"
    try:
        te.save(str(tmp_path / "port"), 4)
    finally:
        te.store.impl = "auto"
    restored = JaxMutable.restore(je.sketcher, str(tmp_path / "port"))
    assert restored.store.impl == "pallas"
    restored._rank_tables = je.rank_tables
    restored.store.impl = "auto"
    for mode in SNAP_MODES:
        ids, rho = restored.search_codes(
            jnp.asarray(q_codes), JaxSearchConfig(chunk_q=8, **MODES[mode]))
        ti, tr = _search(te, q_codes, mode)
        np.testing.assert_array_equal(np.asarray(ids), ti.numpy())
        np.testing.assert_allclose(np.asarray(rho), tr.numpy(), rtol=0,
                                   atol=1e-4)
    # the manifests agree leaf by leaf: names, files, shapes, dtypes
    je.store.impl = "pallas"
    try:
        je.save(str(tmp_path / "jax"), 4)
    finally:
        je.store.impl = "auto"
    want = read_manifest(str(tmp_path / "jax"), 4)["leaves"]
    got = read_manifest(str(tmp_path / "port"), 4)["leaves"]
    assert [{**e, "shape": list(e["shape"])} for e in got] == \
        [{**e, "shape": list(e["shape"])} for e in want]


def test_snapshot_rejects_version_1(tmp_path):
    meta = json.dumps({"version": 1, "k": K, "bits": BITS}).encode()
    save_checkpoint(str(tmp_path), 0, {"meta": np.frombuffer(meta, np.uint8)})
    with pytest.raises(ValueError, match="version 1"):
        restore_index(str(tmp_path), device="cpu")


def test_bf16_leaf_crosses_both_ways(tmp_path):
    vals = np.random.default_rng(3).standard_normal((3, 5)).astype(np.float32)
    t = torch.from_numpy(vals).to(torch.bfloat16)
    save_checkpoint(str(tmp_path / "port"), 1, {"t": t, "n": np.arange(4)})
    got = jax_restore_checkpoint(
        str(tmp_path / "port"), 1,
        {"t": jax.ShapeDtypeStruct((3, 5), jnp.bfloat16),
         "n": jax.ShapeDtypeStruct((4,), jnp.int32)})
    np.testing.assert_array_equal(np.asarray(got["t"], np.float32),
                                  t.to(torch.float32).numpy())
    jax_save_checkpoint(str(tmp_path / "jax"), 2,
                        {"t": jnp.asarray(vals, jnp.bfloat16)})
    back = restore_checkpoint(str(tmp_path / "jax"), 2,
                              {"t": ShapeDtype((3, 5), torch.bfloat16)},
                              device="cpu")["t"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)


def test_compaction_plan_matches_jax():
    codes = np.random.default_rng(14).integers(0, 4, (96, K)).astype(np.int32)
    js = JaxLog(K, BITS, tail_rows=TAIL)
    ts = SegmentLogStore(K, BITS, tail_rows=TAIL, device="cpu")
    js.add_codes(jnp.asarray(codes))
    ts.add_codes(torch.from_numpy(codes))
    for target, frac in ((32, 0.25), (64, 0.25), (96, 0.0)):
        assert plan_compaction(ts, CompactionPolicy(target, frac)) == \
            jax_plan(js, JaxPolicy(target, frac))
    ts.delete(list(range(0, 96, 3)))
    js.delete(list(range(0, 96, 3)))
    assert compact(ts, CompactionPolicy(64)) == jax_compact(js, JaxPolicy(64))
    assert [s.length for s in ts.sealed] == [s.length for s in js.sealed]
