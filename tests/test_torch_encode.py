"""Port parity for ``repro_torch.encode``: CSR input, unit streaming above
the residency cap, the code-and-pack epilogue and the CSR step of one
unit and of a group of units.

The same seeded numpy inputs go through ``repro`` and ``repro_torch``
(``device="cpu"``, so ``ops`` runs the plain versions). The CSR regime
sums in the reference's order (XLA's scatter-add onto the accumulator),
so its projections are bit-identical to JAX's. Paths that sum dense
products in another order (the fused kernel's GEMM, torch's matmul)
must agree with JAX's ``sketch_oracle`` but in fields whose JAX
projection lies within ``EDGE_TOL`` of a bin edge.

Sketches are small (D * k at most 160,000 elements): the plain draw of R
costs about 1.5 us an element on the CPU.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.ann import AnnEngine as JaxEngine
from repro.ann import BandSpec as JaxBands
from repro.ann import CodeStore as JaxStore
from repro.ann.engine import QueryCoder as JaxQueryCoder
from repro.core import packing as jax_packing
from repro.core.schemes import CodeSpec as JaxSpec
from repro.core.sketch import CodedRandomProjection as JaxCRP
from repro.core.sketch import SketchConfig as JaxCfg
from repro.encode import CsrMatrix as JaxCsr
from repro.encode import IngestPipeline as JaxPipeline
from repro.encode import StreamingEncoder as JaxEncoder
from repro.encode import unit_buckets as jax_unit_buckets
from repro.index import MutableAnnEngine as JaxMutable
from repro.index import SegmentLogStore as JaxLog
from repro.kernels import ref as jax_ref
from repro_torch.ann import AnnEngine, BandSpec, CodeStore
from repro_torch.ann.engine import QueryCoder
from repro_torch.core import packing, prng
from repro_torch.core.schemes import CodeSpec
from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
from repro_torch.encode import (CsrMatrix, IngestPipeline, StreamingEncoder,
                                unit_buckets)
from repro_torch.index import MutableAnnEngine, SegmentLogStore
from repro_torch.kernels import ops, ref

EDGE_TOL = 1e-5
SCHEMES = [("uniform", 1.0), ("2bit", 0.75), ("sign", 1.0), ("offset", 1.0)]
D, K, R_UNIT = 5000, 32, 2048      # three units, the last 904 rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain draw runs some 150 float64 ops a unit; on a CPU that other
    test workers share, torch's intra-op threads slow them by an order of
    magnitude, so this file's tests run them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sketchers(scheme="2bit", w=0.75, seed=11, d=D):
    cfg = dict(k=K, scheme=scheme, w=w, seed=seed, r_unit=R_UNIT)
    return (JaxCRP(JaxCfg(**cfg), d),
            CodedRandomProjection(SketchConfig(**cfg), d, device="cpu"))


def _sparse_rows(rng, n, d=D, density=0.02):
    x = np.zeros((n, d), np.float32)
    nz = rng.random((n, d)) < density
    x[nz] = rng.standard_normal(int(nz.sum())).astype(np.float32)
    return x


def _messy_csr(rng, n, d=D, max_len=30):
    """CSR rows with unsorted columns, duplicate columns and empty rows."""
    lens = rng.integers(0, max_len, n)
    lens[[1, n // 2]] = 0
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    cols = rng.integers(0, d, int(indptr[-1])).astype(np.int32)
    cols[indptr[2] + 1:indptr[2] + 4] = cols[indptr[2]]   # a repeated column
    vals = rng.standard_normal(cols.size).astype(np.float32)
    return indptr, cols, vals


def _words(t):
    return t.numpy().view(np.uint32)


def _edge_distance(z, spec, q):
    if spec.scheme == "sign":
        return np.abs(z)
    if spec.scheme == "2bit":
        return np.min(np.abs(z[None] - np.array([-spec.w, 0.0, spec.w])
                             [:, None, None]), axis=0)
    v = (z + q if spec.scheme == "offset" else z) / spec.w
    return np.abs(v - np.round(v)) * spec.w


def _assert_codes_agree(got_words, jc, x):
    """Packed words against JAX's oracle: differences only at bin edges."""
    z = np.asarray(jc.project(jnp.asarray(x)))
    want = np.asarray(jc.encode(jnp.asarray(x)))
    got = np.asarray(jax_packing.unpack_codes(jnp.asarray(_words(got_words)),
                                              jc.spec.bits, jc.cfg.k))
    q = None if jc._offsets is None else np.asarray(jc._offsets)
    diff = got != want
    far = diff & (_edge_distance(z, jc.spec, q) > EDGE_TOL)
    assert not far.any(), f"{int(far.sum())} fields differ away from an edge"
    return int(diff.sum())


# -- CsrMatrix and unit_buckets -----------------------------------------------

@pytest.mark.parametrize("bad", [
    dict(indptr=np.array([0, 1], np.int64)),                  # wrong length
    dict(data=np.ones(2, np.float32)),                        # nnz mismatch
    dict(indptr=np.array([0, 1, 2], np.int64)),               # indptr[-1]
    dict(indices=np.array([0, 5, 8], np.int32)),              # col >= d
    dict(indices=np.array([0, -1, 2], np.int32)),             # col < 0
], ids=["indptr-shape", "data-shape", "indptr-end", "col-high", "col-neg"])
def test_csr_validation_matches_jax(bad):
    good = dict(indptr=np.array([0, 2, 3], np.int64),
                indices=np.array([0, 5, 2], np.int32),
                data=np.ones(3, np.float32), shape=(2, 8))
    kw = {**good, **bad}
    with pytest.raises(ValueError) as want:
        JaxCsr(**kw)
    with pytest.raises(ValueError) as got:
        CsrMatrix(**kw)
    assert str(got.value) == str(want.value)
    CsrMatrix(**good)


@pytest.mark.parametrize("n", [0, 1, 40])
def test_csr_views_match_jax(n):
    rng = np.random.default_rng(n)
    x = _sparse_rows(rng, n, d=300, density=0.05)
    if n > 1:
        x[n // 3] = 0.0                                       # an empty row
    jm, tm = JaxCsr.from_dense(x), CsrMatrix.from_dense(x)
    for a, b in ((tm.indptr, jm.indptr), (tm.indices, jm.indices),
                 (tm.data, jm.data)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (tm.n, tm.d, tm.nnz) == (jm.n, jm.d, jm.nnz)
    np.testing.assert_array_equal(tm.densify(), x)
    for lo, hi in ((0, n), (n // 3, n // 3 + 1), (min(5, n), 2 * n + 9),
                   (n, n)):
        ts, js = tm.row_slice(lo, hi), jm.row_slice(lo, hi)
        assert ts.shape == js.shape
        np.testing.assert_array_equal(ts.indptr, js.indptr)
        np.testing.assert_array_equal(ts.densify(), js.densify())


@pytest.mark.parametrize("r_unit", [1, 64, 2048])
def test_unit_buckets_match_jax(r_unit):
    rng = np.random.default_rng(r_unit)
    indptr, cols, vals = _messy_csr(rng, 30, d=300)
    shape = (30, 300)
    got = unit_buckets(CsrMatrix(indptr, cols, vals, shape), r_unit)
    want = jax_unit_buckets(JaxCsr(indptr, cols, vals, shape), r_unit)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# -- the plain versions of the kernels ----------------------------------------

@pytest.mark.parametrize("m,k", [(2, 7), (1, 1), (33, 31), (50, 256)])
@pytest.mark.parametrize("scheme,w", SCHEMES + [("uniform", 0.25)])
def test_code_pack_ref_matches_jax(scheme, w, m, k):
    rng = np.random.default_rng(m * 1000 + k)
    z = (2.5 * rng.standard_normal((m, k))).astype(np.float32)
    q = rng.uniform(0, w, k).astype(np.float32) if scheme == "offset" else None
    want = jax_ref.code_pack_ref(jnp.asarray(z), JaxSpec(scheme, w),
                                 None if q is None else jnp.asarray(q))
    got = ops.code_pack(torch.from_numpy(z), CodeSpec(scheme, w),
                        None if q is None else torch.from_numpy(q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_words(got), np.asarray(want))


def test_csr_projection_bit_identical_to_jax():
    """Unsorted and repeated columns, empty rows: the CSR step sums in
    XLA's scatter-add order, so the projections are equal bit for bit."""
    jc, tc = _sketchers(seed=3)
    rng = np.random.default_rng(5)
    indptr, cols, vals = _messy_csr(rng, 40)
    want = np.asarray(JaxEncoder(jc).project(JaxCsr(indptr, cols, vals,
                                                    (40, D))))
    got = StreamingEncoder(tc).project(CsrMatrix(indptr, cols, vals, (40, D)))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@functools.lru_cache(maxsize=None)
def _jax_csr_projection(r_unit):
    """JAX's projection of ``_messy_csr`` rows at ``r_unit`` (computed
    once a width: every case of a width holds the same reference)."""
    jc = JaxCRP(JaxCfg(k=K, seed=3, r_unit=r_unit), D)
    indptr, cols, vals = _messy_csr(np.random.default_rng(5), 40)
    z = JaxEncoder(jc).project(JaxCsr(indptr, cols, vals, (40, D)))
    return (indptr, cols, vals), np.asarray(z), JaxEncoder(jc).r_slab_elems


@pytest.mark.parametrize("cap,group", [(4096, 1), (8192, 2), (20480, 5)])
def test_csr_projection_matches_jax_in_groups(cap, group):
    """At r_unit 64 (79 units, the last 8 columns) the cap sets the CSR
    path's group of units to 1, 2 or 5, none of which divides 79; r_slab_
    elems stays JAX's. Each projection is JAX's bit for bit on every row
    but those with an entry alone in its unit's bucket: for a bucket of
    one entry XLA contracts acc + val * R[col] into one FMA (the port
    rounds the product, then adds, as for every other bucket), so those
    rows may differ by one ulp. The seeded rows hold two such rows, and
    one of them differs."""
    (indptr, cols, vals), want, slab = _jax_csr_projection(64)
    tc = CodedRandomProjection(SketchConfig(k=K, seed=3, r_unit=64), D,
                               device="cpu")
    enc = StreamingEncoder(tc, r_cap_elems=cap)
    assert enc.csr_group == group and tc.n_units == 79
    assert enc.r_slab_elems == slab == 64 * K
    got = enc.project(CsrMatrix(indptr, cols, vals, (40, D))).numpy()
    units, counts = np.unique(cols // 64, return_counts=True)
    alone = np.isin(cols, cols[np.isin(cols // 64, units[counts == 1])])
    fma_rows = np.unique(np.repeat(np.arange(40), np.diff(indptr))[alone])
    exact = np.setdiff1d(np.arange(40), fma_rows)
    assert fma_rows.size == 2
    np.testing.assert_array_equal(got[exact].view(np.int32),
                                  want[exact].view(np.int32))
    ulps = np.abs(got[fma_rows].view(np.int32).astype(np.int64)
                  - want[fma_rows].view(np.int32))
    assert ulps.max() == 1


def _group_csr(rng, k):
    """``_messy_csr`` rows at D = 300, r_unit 16 (19 units, the last 12
    columns), then: no entry in units 3, 4 and 10; a row whose CSR order
    runs from unit 5 to unit 2 to unit 5 to unit 0; entries in the ragged
    last unit. -> (indptr, indices, data, R units [19 of [width, k]])."""
    indptr, cols, vals = _messy_csr(rng, 30, d=300)
    for u in (3, 4, 10):
        at = cols // 16 == u
        cols[at] += 32
    a = int(indptr[np.argmax(np.diff(indptr) >= 6)])
    cols[a:a + 6] = [5 * 16 + 3, 2 * 16 + 7, 5 * 16 + 3, 1, 299, 290]
    units = [torch.from_numpy(rng.standard_normal(
        (min(16, 300 - 16 * u), k)).astype(np.float32)) for u in range(19)]
    return (torch.from_numpy(indptr), torch.from_numpy(cols),
            torch.from_numpy(vals), units)


@pytest.mark.parametrize("group", [1, 3, 8])
def test_csr_group_step_ref_matches_unit_loop(group):
    """Groups of G units from unit 0 (the last one ragged) through
    ``ops.csr_group_step`` equal ``csr_unit_step_ref`` over every unit in
    ascending order, bit for bit; the slots of units without an entry
    hold NaN and are never read."""
    rng = np.random.default_rng(19)
    indptr, indices, data, units = _group_csr(rng, 7)
    acc0 = torch.from_numpy(rng.standard_normal((30, 7)).astype(np.float32))
    want = acc0.clone()
    for u, r in enumerate(units):
        ref.csr_unit_step_ref(want, indptr, indices, data, r, 16 * u)
    got = acc0.clone()
    for u0 in range(0, 19, group):
        span = min(16 * group, 300 - 16 * u0)
        r = torch.full((-(-span // 16), 16, 7), float("nan"))
        for g in range(r.shape[0]):
            if u0 + g not in (3, 4, 10):
                r[g, :units[u0 + g].shape[0]] = units[u0 + g]
        ops.csr_group_step(got, indptr, indices, data, r, 16 * u0, span)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.numpy().view(np.int32))


def test_csr_kernel_stats_count_each_entry_once():
    """One kernel-stats record a grouped draw and a grouped step, the
    step's FLOPs 2 x entries x k over the whole projection (each entry in
    exactly one group), not the chunk's entries once a group."""
    from repro_torch.obs import kernelstats
    indptr, cols, vals = _messy_csr(np.random.default_rng(5), 40)
    tc = CodedRandomProjection(SketchConfig(k=K, seed=3, r_unit=64), D,
                               device="cpu")
    enc = StreamingEncoder(tc, r_cap_elems=20480)            # G = 5
    prev = kernelstats.set_kernel_stats(kernelstats.KernelStats())
    try:
        enc.project(CsrMatrix(indptr, cols, vals, (40, D)))
        snap = kernelstats.get_kernel_stats().snapshot()
    finally:
        kernelstats.set_kernel_stats(prev)
    occupied = np.unique(cols // 64)
    runs, i = 0, 0
    while i < occupied.size:
        runs += 1
        i += int(np.sum((occupied >= occupied[i])
                        & (occupied < occupied[i] + 5)))
    assert snap["csr_group_step"]["calls"] == runs
    assert snap["normal_unit_group"]["calls"] == runs
    assert snap["csr_group_step"]["flops"] == 2 * cols.size * K
    assert snap["normal_unit_group"]["elements"] == K * sum(
        tc.unit_width(int(u)) for u in occupied)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normal_unit_group_plain_matches_unit_draws(dtype):
    """The grouped draw's plain version: each unit in its slot equal to
    ``prng.normal`` under its key (the ragged unit too); the slots it is
    not given keep their values."""
    key = prng.PRNGKey(9)
    units = [3, 4, 6]
    widths = [16, 16, 12]
    out = torch.full((4, 16, 5), 7.0, dtype=dtype)
    ops.normal_unit_group([prng.fold_in(key, u) for u in units], widths, out,
                          [u - 3 for u in units])
    iv = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for u, w in zip(units, widths):
        want = prng.normal(prng.fold_in(key, u), (w, 5), dtype=dtype)
        assert torch.equal(out[u - 3, :w].view(iv), want.view(iv))
    assert bool((out[2] == 7.0).all()) and bool((out[3, 12:] == 7.0).all())


def test_csr_unit_step_ref_order_and_untouched_rows():
    """Products rounded, added to acc in CSR order; rows without an entry
    in the unit keep their bits (even -0.0)."""
    acc = torch.tensor([[-0.0, 1.0], [2.0, 3.0], [4.0, 5.0]])
    indptr = torch.tensor([0, 3, 3, 4])
    indices = torch.tensor([10, 12, 10, 30], dtype=torch.int32)
    data = torch.tensor([1e8, 1.0, -1e8, 7.0])
    r = torch.tensor([[1.0, 1.0], [0.0, 0.0], [3.0, 5.0]])
    ref.csr_unit_step_ref(acc, indptr, indices, data, r, 10)
    # row 0: ((-0 + 1e8) + 3) - 1e8 = 0 in float32, (1 + 1e8 + 5) - 1e8 = 8
    assert acc.tolist() == [[0.0, 8.0], [2.0, 3.0], [4.0, 5.0]]
    assert str(acc[1, 0].item()) == "2.0"
    acc2 = torch.full((3, 2), -0.0)
    ref.csr_unit_step_ref(acc2, indptr, indices, data, r, 100)
    assert bool(torch.signbit(acc2).all())


@pytest.mark.parametrize("seed", [0, 7])
def test_block_r_units_match_jax(seed):
    """Every unit of a three-unit sketch, the ragged last one included."""
    jc, tc = _sketchers(seed=seed)
    for u in range(jc.n_units):
        w = jc.unit_width(u)
        np.testing.assert_array_equal(
            tc._block_r(u, w).numpy().view(np.int32),
            np.asarray(jc._block_r(u, w)).view(np.int32))
    assert tc.unit_width(2) == 904


def test_normal_from_bits_plain_matches_draw():
    """The draw's last stage alone, on int32 bit-views: equal to
    ``prng.normal`` on the same key (itself equal to JAX's)."""
    key = prng.fold_in(prng.PRNGKey(5), 3)
    bits = prng.random_bits(key, (40, 7))
    got = ops.normal_from_bits(packing.as_i32(bits))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  prng.normal(key, (40, 7)).numpy()
                                  .view(np.int32))


# -- the three regimes against JAX's oracle -----------------------------------

@pytest.mark.parametrize("scheme,w", SCHEMES)
def test_regimes_match_jax_oracle(scheme, w):
    """Fused (R resident), dense streamed (r_cap_elems=1), CSR, and a host
    array streamed: each equal to JAX's ``sketch_oracle`` but at bin
    edges; the streamed paths never build R."""
    jc, tc = _sketchers(scheme, w)
    x = _sparse_rows(np.random.default_rng(len(scheme)), 24)
    oracle = np.asarray(jc.sketch_oracle(jnp.asarray(x)))
    streamed = StreamingEncoder(tc, r_cap_elems=1)
    paths = {"fused": tc.sketch(torch.from_numpy(x)),
             "streamed": streamed.encode_packed(torch.from_numpy(x)),
             "host": streamed.encode_packed(x),
             "csr": StreamingEncoder(tc).encode_packed(
                 CsrMatrix.from_dense(x))}
    assert streamed._rmat is None
    for name, words in paths.items():
        assert words.shape == oracle.shape, name
        _assert_codes_agree(words, jc, x)
    np.testing.assert_array_equal(_words(paths["csr"]), oracle)
    codes = StreamingEncoder(tc, r_cap_elems=1).encode_codes(
        CsrMatrix.from_dense(x))
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jc.encode(jnp.asarray(x))))


def test_above_cap_r_matrix_raises_as_jax_and_encode_serves():
    jc, tc = _sketchers()
    x = _sparse_rows(np.random.default_rng(2), 6)
    jenc, tenc = JaxEncoder(jc, r_cap_elems=100), StreamingEncoder(
        tc, r_cap_elems=100)
    with pytest.raises(ValueError) as want:
        jenc.r_matrix()
    with pytest.raises(ValueError) as got:
        tenc.r_matrix()
    assert str(got.value) == str(want.value)
    assert tenc.r_slab_elems == jenc.r_slab_elems == R_UNIT * K
    words = tenc.encode_packed(x)
    assert tenc._rmat is None and words.shape == (6, tenc.n_words)
    _assert_codes_agree(words, jc, x)


def test_empty_inputs():
    _, tc = _sketchers()
    enc = StreamingEncoder(tc, r_cap_elems=1)
    empty = CsrMatrix(np.zeros(4, np.int64), np.zeros(0, np.int32),
                      np.zeros(0, np.float32), (3, D))
    zero = ops.code_pack(torch.zeros(3, K), tc.spec)
    assert torch.equal(enc.encode_packed(empty), zero)
    assert enc.encode_packed(np.zeros((0, D), np.float32)).shape == (0, 2)
    assert ops.code_pack(torch.zeros(0, 7), tc.spec).shape == (0, 1)
    with pytest.raises(ValueError, match="csr d"):
        enc.encode_packed(CsrMatrix.from_dense(np.ones((1, 9), np.float32)))


# -- pipeline, query coder and engines ----------------------------------------

@pytest.mark.parametrize("kind", ["segment_log", "code_store"])
def test_csr_pipeline_matches_jax_and_is_chunking_invariant(kind):
    jc, tc = _sketchers()
    x = _sparse_rows(np.random.default_rng(9), 100)
    x[[3, 50]] = 0.0
    csr = CsrMatrix.from_dense(x)
    w = StreamingEncoder(tc).n_words

    def stores():
        if kind == "segment_log":
            return (JaxLog(K, 2, band_spec=JaxBands(8, 4), tail_rows=32),
                    SegmentLogStore(K, 2, band_spec=BandSpec(8, 4),
                                    tail_rows=32, device="cpu"))
        return (JaxStore.from_words(np.zeros((0, w), np.uint32), K, 2),
                CodeStore(words=torch.zeros((0, w), dtype=torch.int32), k=K,
                          bits=2))

    def words(store):
        return store.live_words() if kind == "segment_log" else store.words

    jstore, tstore = stores()
    jp = JaxPipeline(jc.stream_encoder(), jstore, chunk_rows=64)
    tp = IngestPipeline(tc.stream_encoder(), tstore, chunk_rows=64)
    np.testing.assert_array_equal(tp.ingest(csr), jp.ingest(JaxCsr.from_dense(x)))
    assert dict(tp.stats) == dict(jp.stats)
    np.testing.assert_array_equal(_words(words(tp.store)),
                                  np.asarray(words(jp.store)))
    _, tstore7 = stores()
    tp7 = IngestPipeline(StreamingEncoder(tc), tstore7, chunk_rows=7)
    tp7.ingest(csr)
    assert tp7.stats["chunks"] == 15
    assert torch.equal(words(tp7.store), words(tp.store))


def test_query_coder_above_cap_matches_jax():
    jc, tc = _sketchers(seed=4)
    jc.stream_encoder().r_cap_elems = tc.stream_encoder().r_cap_elems = 1
    jq, tq = JaxQueryCoder(jc), QueryCoder(tc)
    with pytest.raises(ValueError):
        tq.r_matrix()
    with pytest.raises(ValueError):
        jq.r_matrix()
    x = _sparse_rows(np.random.default_rng(4), 9)
    csr, jcsr = CsrMatrix.from_dense(x), JaxCsr.from_dense(x)
    np.testing.assert_array_equal(tq.encode(csr).numpy(),
                                  np.asarray(jq.encode(jcsr)))
    np.testing.assert_array_equal(_words(tq.encode_packed(csr)),
                                  np.asarray(jq.encode_packed(jcsr)))
    _assert_codes_agree(tq.encode_packed(x), jc, x)
    assert tc.stream_encoder()._rmat is None


def test_engines_over_csr_match_jax():
    """``MutableAnnEngine.ingest`` and ``upsert`` over a CSR corpus,
    and ``AnnEngine.build`` over the same rows, searched with CSR queries
    (perturbed corpus rows and random rows): equal to JAX's engines."""
    jc, tc = _sketchers()
    rng = np.random.default_rng(21)
    x = _sparse_rows(rng, 120)
    qx = np.concatenate([x[[5, 60, 119]] + 0.05 * rng.standard_normal(
        (3, D)).astype(np.float32) * (x[[5, 60, 119]] != 0),
        _sparse_rows(rng, 5)])
    csr, jcsr = CsrMatrix.from_dense(x), JaxCsr.from_dense(x)
    q, jq = CsrMatrix.from_dense(qx), JaxCsr.from_dense(qx)
    je = JaxMutable(jc, band_spec=JaxBands(8, 4), tail_rows=64)
    te = MutableAnnEngine(tc, band_spec=BandSpec(8, 4), tail_rows=64)
    np.testing.assert_array_equal(te.ingest(csr, chunk_rows=50),
                                  je.ingest(jcsr, chunk_rows=50))
    te.upsert([7], q.row_slice(0, 1))
    je.upsert([7], jq.row_slice(0, 1))
    eb = AnnEngine.build(tc, csr, BandSpec(8, 4))
    jb = JaxEngine.build(jc, jcsr, JaxBands(8, 4))
    for got, want in ((te.search(q, top_k=4, chunk_q=8),
                       je.search(jq, top_k=4, chunk_q=8)),
                      (eb.search(q, top_k=4, chunk_q=8),
                       jb.search(jq, top_k=4, chunk_q=8))):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=0, atol=1e-4)
    assert got[0][:3, 0].tolist() == [5, 60, 119]
