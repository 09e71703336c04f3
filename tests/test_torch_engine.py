"""Port parity end to end: sketch -> store -> engine -> exact search.

Both packages index the same corpus (unit-normalised rows from a numpy
seed) and answer the same queries. Fed JAX's packed words, the port's
ids and rho are exact (ids bit-exact, rho to float32 interpolation
rounding); fed the same R through ``convert``, its own words may differ
from JAX's only at bin-edge fields (see test_torch_schemes), which these
seeds do not hit.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.ann import AnnEngine as JaxEngine
from repro.ann import BandSpec as JaxBands
from repro.ann import CodeStore as JaxStore
from repro.ann.engine import SearchConfig as JaxSearchConfig
from repro.core.sketch import CodedRandomProjection as JaxCRP
from repro.core.sketch import SketchConfig as JaxCfg
from repro_torch import convert
from repro_torch.ann import AnnEngine, BandSpec, CodeStore, SearchConfig
from repro_torch.ann.engine import merge_topk, run_chunked
from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
from repro_torch.encode import StreamingEncoder

D, N, NQ = 96, 600, 33
# the main path's scheme with a ragged last word, and the offset scheme
# (the only one with offsets); the other schemes are covered code by code
# in test_torch_schemes
CASES = [("2bit", 0.75, 100), ("offset", 1.0, 64)]


def _rows(rng, n):
    x = rng.standard_normal((n, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(2014)
    corpus, extra = _rows(rng, N), _rows(rng, 40)
    queries = np.concatenate([corpus[:20] + 0.02 * rng.standard_normal(
        (20, D)).astype(np.float32), _rows(rng, NQ - 20)])
    return corpus, extra, queries


@functools.lru_cache(maxsize=None)
def _case(scheme, w, k):
    """One JAX sketcher, port sketcher and JAX-packed corpus per case,
    shared by the tests (the JAX side dominates their time)."""
    cfg = dict(k=k, scheme=scheme, w=w, seed=7)
    jc = JaxCRP(JaxCfg(**cfg), D)
    tc = CodedRandomProjection(SketchConfig(**cfg), D, device="cpu")
    corpus = _rows(np.random.default_rng(2014), N)
    return jc, tc, np.asarray(jc.sketch(jnp.asarray(corpus)))


@pytest.mark.parametrize("scheme,w,k", CASES)
def test_sketch_words_match_jax(data, scheme, w, k):
    corpus, _, _ = data
    jc, tc, want = _case(scheme, w, k)
    got = tc.sketch(torch.from_numpy(corpus))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(tc.sketch_oracle(corpus).numpy(), got.numpy())


@functools.lru_cache(maxsize=None)
def _jax_engine(scheme, w, k):
    jc, _, words = _case(scheme, w, k)
    return JaxEngine(jc, JaxStore.from_words(words, k, jc.spec.bits),
                     JaxBands(4, 4))


@pytest.mark.parametrize("top_k", [10, N + 5])
@pytest.mark.parametrize("scheme,w,k", CASES)
def test_search_on_jax_words_is_exact(data, scheme, w, k, top_k):
    _, _, queries = data
    jc, tc, words = _case(scheme, w, k)
    jeng = _jax_engine(scheme, w, k)
    teng = AnnEngine(tc, convert.store_from_numpy(words, k, tc.spec.bits,
                                                  device="cpu"),
                     BandSpec(4, 4))
    np.testing.assert_array_equal(teng.db_band_hashes.numpy(),
                                  np.asarray(jeng.db_band_hashes).astype(np.int64))
    q_codes = np.asarray(jeng.encode_queries(jnp.asarray(queries)))
    ji, jr = jeng.search_codes(jnp.asarray(q_codes),
                               JaxSearchConfig(top_k=top_k, chunk_q=16))
    ti, tr = teng.search_codes(torch.from_numpy(q_codes.copy()),
                               SearchConfig(top_k=top_k, chunk_q=16))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4)
    jv, _ = jeng._exact_coarse(jnp.asarray(q_codes), cfg=JaxSearchConfig(top_k=top_k))
    tv, _ = teng._exact_coarse(torch.from_numpy(q_codes.copy()),
                               cfg=SearchConfig(top_k=top_k))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))   # the counts


@pytest.mark.parametrize("scheme,w,k", CASES[:1])
def test_build_add_search_on_same_r(data, scheme, w, k):
    corpus, extra, queries = data
    jc, _, _ = _case(scheme, w, k)
    tc = convert.sketch_from_numpy(
        SketchConfig(k=k, scheme=scheme, w=w, seed=7), D,
        np.asarray(jc.stream_encoder().r_matrix()),
        None if jc._offsets is None else np.asarray(jc._offsets), device="cpu")
    jeng = JaxEngine.build(jc, jnp.asarray(corpus), JaxBands(4, 4)).add(
        jnp.asarray(extra))
    teng = AnnEngine.build(tc, corpus, BandSpec(4, 4)).add(torch.from_numpy(extra))
    assert teng.n == jeng.n == N + 40
    np.testing.assert_array_equal(teng.store.words.numpy().view(np.uint32),
                                  np.asarray(jeng.store.words))
    ji, jr = jeng.search(jnp.asarray(queries), top_k=10)
    ti, tr = teng.search(torch.from_numpy(queries), top_k=10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4)
    assert np.array_equal(ti.numpy()[:20, 0], np.arange(20))
    np.testing.assert_array_equal(
        teng.codes_for_ids([3, 0, N + 1]).numpy(),
        np.asarray(jeng.codes_for_ids(np.array([3, 0, N + 1]))))


def test_estimate_rho_packed_matches_jax(data):
    corpus, _, _ = data
    jc, tc, _ = _case(*CASES[0])
    jw = jc.sketch(jnp.asarray(corpus[:10]))
    tw = tc.sketch(torch.from_numpy(corpus[:10]))
    np.testing.assert_allclose(
        tc.estimate_rho_packed(tw[:5], tw[5:]).numpy(),
        np.asarray(jc.estimate_rho_packed(jw[:5], jw[5:])), atol=1e-4)


def test_empty_store_and_empty_queries():
    tc = CodedRandomProjection(SketchConfig(k=32), 8, device="cpu")
    eng = AnnEngine(tc, CodeStore(torch.zeros((0, 2), dtype=torch.int32), 32, 2),
                    BandSpec(4, 4))
    ids, rho = eng.search(np.ones((3, 8), np.float32), top_k=4)
    assert ids.shape == (3, 4) and bool((ids == -1).all())
    assert bool((rho == -1.0).all())


@pytest.mark.parametrize("kwargs", [dict(scored=True), dict(mode="lsh")])
def test_later_slices_raise(kwargs):
    tc = CodedRandomProjection(SketchConfig(k=32), 8, device="cpu")
    eng = AnnEngine.build(tc, np.ones((4, 8), np.float32), BandSpec(4, 4))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.search(np.ones((2, 8), np.float32), **kwargs)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.search_sharded(np.ones((2, 8), np.float32))


def test_streaming_regime_raises_above_cap():
    tc = CodedRandomProjection(SketchConfig(k=32), 8, device="cpu")
    enc = StreamingEncoder(tc, r_cap_elems=100)
    with pytest.raises(NotImplementedError, match="queue A item 3"):
        enc.encode_packed(np.ones((2, 8), np.float32))


def test_merge_topk_stable_and_sentinels():
    v1 = torch.tensor([[5, 3, -1]], dtype=torch.int32)
    i1 = torch.tensor([[10, 11, -1]], dtype=torch.int32)
    v2 = torch.tensor([[5, 4, 3]], dtype=torch.int32)
    i2 = torch.tensor([[2, 3, 4]], dtype=torch.int32)
    vals, ids = merge_topk([v1, v2], [i1, i2], 7)
    assert vals.tolist() == [[5, 5, 4, 3, 3, -1, -1]]
    assert ids.tolist() == [[10, 2, 3, 11, 4, -1, -1]]
    f = torch.tensor([[0.5, float("-inf")]])
    _, ids = merge_topk([f], [torch.tensor([[1, 9]], dtype=torch.int32)], 2)
    assert ids.tolist() == [[1, -1]]


@pytest.mark.parametrize("q,chunk_q", [(1, 256), (5, 4), (33, 16), (64, 64)])
def test_run_chunked_pads_and_unpads(q, chunk_q):
    codes = torch.arange(q * 3, dtype=torch.int32).reshape(q, 3)
    seen = []

    def fn(chunk, cfg):
        seen.append(chunk.shape[0])
        return chunk[:, :1], chunk[:, 1:].float()

    ids, rho = run_chunked(codes, SearchConfig(chunk_q=chunk_q), fn)
    assert torch.equal(ids, codes[:, :1]) and torch.equal(rho, codes[:, 1:].float())
    assert len(set(seen)) == 1 and seen[0] <= chunk_q


@pytest.mark.parametrize("kwargs", [
    dict(rerank_m=64), dict(fused=False), dict(table_dtype="int8"),
    dict(min_bands=2), dict(n_probes=1)])
def test_search_refuses_knobs_of_later_slices(kwargs):
    # the reference's LSH and scored knobs have no effect on count-ranked
    # exact search, so the port takes none of them rather than ignore them
    tc = CodedRandomProjection(SketchConfig(k=32), 8, device="cpu")
    eng = AnnEngine.build(tc, np.ones((4, 8), np.float32), BandSpec(4, 4))
    with pytest.raises(TypeError):
        eng.search(np.ones((2, 8), np.float32), **kwargs)
    with pytest.raises(TypeError):
        SearchConfig(**kwargs)


def test_unknown_mode_raises():
    tc = CodedRandomProjection(SketchConfig(k=32), 8, device="cpu")
    eng = AnnEngine.build(tc, np.ones((4, 8), np.float32), BandSpec(4, 4))
    with pytest.raises(ValueError, match="unknown mode"):
        eng.search(np.ones((2, 8), np.float32), mode="approx")
