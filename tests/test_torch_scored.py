"""Port parity for scored search and LSH candidates.

The plain versions of the scored kernels against their JAX ``ref``
twins, then ``AnnEngine.search_codes`` in every scored and LSH mode
against the JAX engine: both engines hold JAX's packed words and score
with the same tables (JAX's own for the 2-bit scheme, tables made from a
numpy seed for the offset scheme, which has no shared cell model).
Ids and scores are bit-exact; rho_hat agrees to float32 interpolation
rounding.
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
from repro.ann.engine import run_chunked as jax_run_chunked
from repro.core import packing as jax_packing
from repro.core.sketch import CodedRandomProjection as JaxCRP
from repro.core.sketch import SketchConfig as JaxCfg
from repro.kernels import ref as jax_ref
from repro.rank import RankTables as JaxTables
from repro.rank import build_rank_tables as jax_build
from repro_torch import convert
from repro_torch.ann import AnnEngine, BandSpec
from repro_torch.ann.engine import SearchConfig
from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
from repro_torch.kernels import ops, ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; torch's intra-op threads would
    compete with them, so this file runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


D, N, NQ = 96, 600, 33
CASES = [("2bit", 0.75, 100), ("offset", 1.0, 64)]


def _i32(a):
    return torch.from_numpy(np.array(a).view(np.int32))


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@functools.lru_cache(maxsize=None)
def _problem(bits, dtype, q=5, n=130, k=33):
    """Packed queries and corpus (with planted ties) and query tables,
    from a numpy seed, as (jax arrays, torch tensors)."""
    rng = np.random.default_rng(bits * 31 + len(dtype))
    p, cpw = 1 << bits, 32 // bits
    cq = rng.integers(0, p, (q, k))
    cd = rng.integers(0, p, (n, k))
    cd[[7, 40, 99]] = cq[0]
    wq = np.asarray(jax_packing.pack_codes(jnp.asarray(cq), bits))
    wd = np.asarray(jax_packing.pack_codes(jnp.asarray(cd), bits))
    fp = wq.shape[1] * cpw * p
    if dtype == "int8":
        tab = rng.integers(-127, 128, (q, fp)).astype(np.int8)
        scl = (2.0 ** rng.integers(-8, 2, (q, wq.shape[1]))).astype(np.float32)
        jt, tt = jnp.asarray(tab), torch.from_numpy(tab)
        js, ts = jnp.asarray(scl), torch.from_numpy(scl)
    else:
        tab = rng.standard_normal((q, fp)).astype(np.float32)
        jt, tt, js, ts = jnp.asarray(tab), torch.from_numpy(tab), None, None
        if dtype == "bf16":
            jt, tt = jt.astype(jnp.bfloat16), tt.to(torch.bfloat16)
    return ((jnp.asarray(wq), jt, jnp.asarray(wd), js),
            (_i32(wq), tt, _i32(wd), ts), k)


# (rerank_m, top_k) a bit width: a truncating rerank_m, rerank_m above
# N = 130, and top_k above the survivors
M_TOP = {1: (32, 7), 2: (140, 7), 4: (3, 10)}


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_fused_and_two_stage_plain_versions_match_jax(bits, dtype):
    (jq, jt, jd, js), (tq, tt, td, ts), k = _problem(bits, dtype)
    m, top_k = M_TOP[bits]
    _eq(ref.fused_scored_topk_ref(tq, tt, td, bits, k, m, top_k, scales=ts),
        jax_ref.fused_scored_topk_ref(jq, jt, jd, bits, k, m, top_k,
                                      scales=js))
    if dtype != "int8":
        _eq(ref.two_stage_scored_ref(tq, tt, td, bits, k, m, top_k),
            jax_ref.two_stage_scored_ref(jq, jt, jd, bits, k, m, top_k))
    counts = ref.packed_collision_ref(tq, td, bits, k)
    np.testing.assert_array_equal(
        ref.coarse_survivor_mask_ref(counts, k, m).numpy(),
        np.asarray(jax_ref.coarse_survivor_mask_ref(
            jnp.asarray(counts.numpy()), k, m)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_lut_rerank_plain_version_matches_jax(bits, dtype):
    (_, jt, jd, _), (_, tt, td, _), _ = _problem(bits, dtype)
    n = td.shape[0]
    cand_ids = np.random.default_rng(bits).integers(-1, n, (tt.shape[0], 50))
    cw = np.asarray(jd)[np.clip(cand_ids, 0, n - 1)]
    for top_k in (7, 60):
        _eq(ops.packed_lut_rerank(tt, _i32(cw), torch.from_numpy(cand_ids >= 0),
                                  bits, top_k),
            jax_ref.packed_lut_rerank_ref(jt, jnp.asarray(cw),
                                          jnp.asarray(cand_ids >= 0), bits,
                                          top_k))


@pytest.mark.parametrize("nq,m,w,bits,dtype,kernel,cpl,warps", [
    (256, 64, 16, 2, torch.float32, "warp", 2, 1),      # the main path
    (256, 64, 16, 2, torch.bfloat16, "warp", 2, 1),
    (1024, 64, 16, 2, torch.float32, "warp", 2, 4),     # a block of 4
    (300, 64, 16, 2, torch.float32, "warp", 2, 2),
    (256, 32, 16, 1, torch.float32, "warp", 1, 1),
    (256, 0, 16, 2, torch.float32, "warp", 1, 1),
    (256, 65, 16, 4, torch.float32, "warp", 4, 1),
    (256, 128, 16, 4, torch.bfloat16, "warp", 4, 1),
    (256, 129, 16, 2, torch.float32, "block", None, None),   # M past a warp
    (5, 2000, 2, 2, torch.float32, "block", None, None),
    (256, 64, 16, 8, torch.float32, "block", None, None),    # 8 and 16 bits
    (256, 64, 16, 16, torch.bfloat16, "block", None, None),
    (256, 64, 80, 4, torch.float32, "block", None, None)])   # table 40 KB
def test_rerank_plan(nq, m, w, bits, dtype, kernel, cpl, warps):
    """Which re-rank kernel a call launches, by shape alone: one warp a
    query for 1-, 2- and 4-bit codes, at most 128 candidates and a
    warp's shared memory within its limit; else one block a query."""
    from repro_torch.kernels import packed_lut as pl
    p = pl.rerank_plan(nq, m, w, bits, dtype, sms=132)
    assert (p["kernel"], p["cpl"], p["warps"]) == (kernel, cpl, warps)
    if kernel == "warp":
        elem = torch.empty((), dtype=dtype).element_size()
        table = (w * (32 // bits) << bits) * elem
        assert p["smem"] == warps * (table + 32 * cpl * (w | 1) * 4)
        assert p["grid"] == (-(-nq // warps),) and m <= 32 * cpl


def test_topk_scored_ties_and_sentinels():
    s = np.array([[1.0, 3.0, 3.0, -np.inf, 3.0, 0.5]], np.float32)
    _eq(ref.topk_scored_ref(torch.from_numpy(s), 8),
        jax_ref.topk_scored_ref(jnp.asarray(s), 8))


def _rows(rng, n):
    x = rng.standard_normal((n, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@functools.lru_cache(maxsize=None)
def _engines(scheme, w, k):
    """The JAX engine and the port's on JAX's packed words and one set of
    tables, and the JAX query codes."""
    cfg = dict(k=k, scheme=scheme, w=w, seed=7)
    jc = JaxCRP(JaxCfg(**cfg), D)
    tc = CodedRandomProjection(SketchConfig(**cfg), D, device="cpu")
    rng = np.random.default_rng(2014)
    corpus = _rows(rng, N)
    queries = np.concatenate([corpus[:20] + 0.02 * rng.standard_normal(
        (20, D)).astype(np.float32), _rows(rng, NQ - 20)])
    words = np.asarray(jc.sketch(jnp.asarray(corpus)))
    if scheme == "offset":
        p = 1 << jc.spec.bits
        pair = rng.standard_normal((p, p)).astype(np.float32)
        jt = JaxTables(spec=jc.spec, k=k, pair=jnp.asarray(pair),
                       rho_grid=jnp.linspace(0.0, 1.0, 64),
                       score_grid=jnp.linspace(-40.0, 60.0, 64))
    else:
        jt = jax_build(jc)
    tt = convert.rank_tables_from_numpy(
        tc.spec, k, np.asarray(jt.pair), np.asarray(jt.rho_grid),
        np.asarray(jt.score_grid), device="cpu")
    jeng = JaxEngine(jc, JaxStore.from_words(words, k, jc.spec.bits),
                     JaxBands(4, 4), rank_tables=jt)
    teng = AnnEngine(tc, convert.store_from_numpy(words, k, tc.spec.bits,
                                                  device="cpu"),
                     BandSpec(4, 4), rank_tables=tt)
    return jeng, teng, np.asarray(jeng.encode_queries(jnp.asarray(queries)))


# rerank_m = 100 keeps the reference's coarse top-m on lax.top_k (its
# blocked picking below 65 traces slowly); the auto rerank_m runs on the
# chip. The two LSH modes of each kind cover n_probes 0 and 1 and
# min_bands 1 and 2.
MODES = {
    "fused-f32": dict(scored=True, table_dtype="f32"),
    "fused-bf16": dict(scored=True, table_dtype="bf16"),
    "fused-int8": dict(scored=True, table_dtype="int8"),
    "two-stage": dict(scored=True, fused=False),
    "lsh-p0-b1": dict(mode="lsh"),
    "lsh-p1-b2": dict(mode="lsh", n_probes=1, min_bands=2),
    "lsh-scored-p0-b1": dict(mode="lsh", scored=True),
    "lsh-scored-p1-b2": dict(mode="lsh", scored=True, n_probes=1,
                             min_bands=2),
}
CASE_MODES = [(c, m) for c in CASES for m in MODES]


@pytest.mark.parametrize("case,mode", CASE_MODES,
                         ids=[f"{c[0]}-{m}" for c, m in CASE_MODES])
def test_search_modes_match_jax(case, mode):
    scheme, w, k = case
    jeng, teng, q_codes = _engines(scheme, w, k)
    kw = dict(top_k=10, chunk_q=64, rerank_m=100, **MODES[mode])
    cfg = JaxSearchConfig(**kw)
    # the JAX engine's own chunk bodies and chunking, without the
    # per-mode jax.jit that search_codes adds: the jnp functions inside
    # compile once per shape and the modes share them
    body = jeng._exact_chunk if cfg.mode == "exact" else jeng._lsh_chunk
    ji, jr = jax_run_chunked(jnp.asarray(q_codes), cfg,
                             lambda chunk, c: body(chunk, cfg=c))
    ti, tr = teng.search_codes(torch.from_numpy(q_codes.copy()),
                               SearchConfig(**kw))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-6)
    if mode in ("fused-f32", "two-stage") and scheme == "2bit":
        assert (ti.numpy()[:20, 0] == np.arange(20)).all()   # planted


def test_search_codes_jitted_matches_eager_chunks():
    """The public jitted JAX path equals the chunk bodies run above."""
    jeng, teng, q_codes = _engines(*CASES[0])
    cfg = JaxSearchConfig(top_k=10, chunk_q=64, rerank_m=100, scored=True)
    ji, jr = jeng.search_codes(jnp.asarray(q_codes), cfg)
    ti, tr = teng.search_codes(torch.from_numpy(q_codes.copy()),
                               SearchConfig(top_k=10, chunk_q=64,
                                            rerank_m=100, scored=True))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-6)


def test_band_match_counts_and_rerank_match_jax():
    jeng, teng, q_codes = _engines(*CASES[0])
    for n_probes in (0, 2):
        np.testing.assert_array_equal(
            teng.band_match_counts(torch.from_numpy(q_codes[:5].copy()),
                                   n_probes).numpy(),
            np.asarray(jeng.band_match_counts(jnp.asarray(q_codes[:5]),
                                              n_probes)))
    cand = np.array([3, 0, 599, 17, 3], np.int32)
    tc, tr = teng.rerank(torch.from_numpy(q_codes[0].copy()), cand)
    jc, jr = jeng.rerank(jnp.asarray(q_codes[0]), cand)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-6)
