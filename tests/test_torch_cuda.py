"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. On a machine
with one, ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py`` builds the kernels and runs them at small
ragged shapes; ``chip_smoke.py`` covers the main path's shapes.
"""
import pytest
import torch

from repro_torch.core import packing
from repro_torch.core.schemes import CodeSpec
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def _near_edge(z, spec, q):
    if spec.scheme == "sign":
        d = z.abs()
    elif spec.scheme == "2bit":
        d = torch.stack([(z + spec.w).abs(), z.abs(), (z - spec.w).abs()]).amin(0)
    else:
        v = (z + q if spec.scheme == "offset" else z) / spec.w
        d = (v - v.round()).abs() * spec.w
    return d <= 1e-5


@pytest.mark.parametrize("scheme,w", [("sign", 1.0), ("2bit", 0.75),
                                      ("uniform", 0.75), ("offset", 1.0)])
def test_gemm_kernels_match_plain(gen, scheme, w):
    spec = CodeSpec(scheme, w)
    x = torch.randn((300, 96), generator=gen, device="cuda")
    x = x / x.norm(dim=1, keepdim=True)
    r = torch.randn((96, 100), generator=gen, device="cuda")
    q = torch.rand((100,), generator=gen, device="cuda") * w \
        if scheme == "offset" else None
    want = ref.coded_project_ref(x, r, spec, q)
    near = _near_edge(torch.matmul(x, r), spec, q)
    got = ops.coded_project(x, r, spec, q, impl="kernel")
    assert not bool(((got != want) & ~near).any())
    words = ops.encode_fused(x, r, spec, q, impl="kernel")
    got = packing.unpack_codes(words, spec.bits, 100)
    assert not bool(((got != want) & ~near).any())


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_pack_and_topk_kernels_bit_exact(gen, bits):
    codes = torch.randint(0, 1 << bits, (257, 100), generator=gen,
                          device="cuda", dtype=torch.int32)
    assert torch.equal(ops.pack_codes(codes, bits, impl="kernel"),
                       ref.pack_codes_ref(codes, bits))
    wq = ref.pack_codes_ref(codes[:9], bits)
    wdb = ref.pack_codes_ref(codes, bits)
    for top_k in (1, 10, 300):
        got = ops.packed_topk(wq, wdb, bits, 100, top_k, impl="kernel")
        want = ref.packed_topk_ref(wq, wdb, bits, 100, top_k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _tables(gen, nq, w, bits, dtype):
    fp = (w * (32 // bits)) << bits
    if dtype == "int8":
        t = torch.randint(-127, 128, (nq, fp), generator=gen, device="cuda",
                          dtype=torch.int8)
        e = torch.randint(-8, 2, (nq, w), generator=gen, device="cuda")
        return t, torch.pow(2.0, e.to(torch.float32))
    t = torch.randn((nq, fp), generator=gen, device="cuda")
    return (t.to(torch.bfloat16) if dtype == "bf16" else t), None


def _words(gen, n, k, bits):
    return ref.pack_codes_ref(torch.randint(0, 1 << bits, (n, k), generator=gen,
                                            device="cuda"), bits)


def _same(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_collision_counts_kernel_bit_exact(gen, bits):
    wq, wdb = _words(gen, 37, 100, bits), _words(gen, 3001, 100, bits)
    assert torch.equal(ops.packed_collision_counts(wq, wdb, bits, 100,
                                                   impl="kernel"),
                       ref.packed_collision_ref(wq, wdb, bits, 100))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_lut_rerank_kernel_bit_exact(gen, bits, dtype):
    for nq, m, top_k in ((13, 50, 7), (5, 2000, 10), (3, 4, 9)):
        tab, _ = _tables(gen, nq, -(-33 // (32 // bits)), bits, dtype)
        cand = _words(gen, nq * m, 33, bits).reshape(nq, m, -1)
        valid = torch.rand((nq, m), generator=gen, device="cuda") > 0.3
        assert _same(ops.packed_lut_rerank(tab, cand, valid, bits, top_k,
                                           impl="kernel"),
                     ref.packed_lut_rerank_ref(tab, cand, valid, bits, top_k))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_fused_scored_kernel_bit_exact(gen, bits, dtype):
    for nq, n, k, m, top_k in ((3, 37, 17, 9, 7), (9, 5000, 64, 64, 10),
                               (4, 20, 33, 30, 10), (2, 0, 17, 5, 3)):
        wq, wdb = _words(gen, nq, k, bits), _words(gen, n, k, bits)
        if n:
            wdb[n // 2] = wq[0]
        tab, scl = _tables(gen, nq, wq.shape[1], bits, dtype)
        assert _same(ops.fused_scored_topk(wq, tab, wdb, bits, k, m, top_k,
                                           scales=scl, impl="kernel"),
                     ref.fused_scored_topk_ref(wq, tab, wdb, bits, k, m, top_k,
                                               scales=scl))


@pytest.mark.parametrize("kwargs", [
    dict(scored=True), dict(scored=True, table_dtype="int8"),
    dict(scored=True, fused=False), dict(mode="lsh"),
    dict(mode="lsh", scored=True, n_probes=1)])
def test_engine_modes_match_plain_versions(gen, kwargs):
    from repro_torch.ann import AnnEngine, BandSpec
    from repro_torch.ann.engine import SearchConfig
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
    crp = CodedRandomProjection(SketchConfig(k=100), 96)
    x = torch.randn((3000, 96), generator=gen, device="cuda")
    x = x / x.norm(dim=1, keepdim=True)
    eng = AnnEngine.build(crp, x, BandSpec(8, 4))
    codes = eng.encode_queries(x[:40] + 0.001 * torch.randn(
        (40, 96), generator=gen, device="cuda"))
    got = eng.search_codes(codes, SearchConfig(chunk_q=16, **kwargs))
    want = eng.search_codes(codes, SearchConfig(chunk_q=16, impl="ref",
                                                **kwargs))
    assert _same(got, want)
    assert bool((got[0][:, 0] == torch.arange(40, device="cuda")).all())


@pytest.mark.parametrize("bits,k", [(8, 400), (16, 40)])
def test_scored_kernels_with_tables_in_device_memory(gen, bits, k):
    # tables over 96 KB a query are read from device memory
    wq, wdb = _words(gen, 3, k, bits), _words(gen, 900, k, bits)
    wdb[5] = wq[0]
    for dtype in ("f32", "bf16", "int8"):
        tab, scl = _tables(gen, 3, wq.shape[1], bits, dtype)
        assert _same(ops.fused_scored_topk(wq, tab, wdb, bits, k, 20, 7,
                                           scales=scl, impl="kernel"),
                     ref.fused_scored_topk_ref(wq, tab, wdb, bits, k, 20, 7,
                                               scales=scl))
        if dtype != "int8":
            cand = wdb[:150].reshape(3, 50, -1)
            valid = torch.rand((3, 50), generator=gen, device="cuda") > 0.3
            assert _same(ops.packed_lut_rerank(tab, cand, valid, bits, 7,
                                               impl="kernel"),
                         ref.packed_lut_rerank_ref(tab, cand, valid, bits, 7))


def _mask(gen, n, live_frac):
    return packing.pack_bitmask(
        torch.rand((n,), generator=gen, device="cuda") < live_frac)


@pytest.mark.parametrize("live_frac", [0.0, 0.1, 0.9, 1.0])
@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_masked_topk_kernel_bit_exact(gen, bits, live_frac):
    # ragged N (mask words past a range boundary), top_k above the live rows
    for nq, n, k, top_k in ((9, 3000, 100, 10), (5, 33, 64, 50),
                            (3, 31, 17, 7), (2, 1, 17, 3), (2, 0, 17, 3)):
        wq, wdb = _words(gen, nq, k, bits), _words(gen, n, k, bits)
        if n:
            wdb[n // 2] = wq[0]
        valid = _mask(gen, n, live_frac)
        assert _same(ops.packed_topk_masked(wq, wdb, valid, bits, k, top_k,
                                            impl="kernel"),
                     ref.packed_topk_masked_ref(wq, wdb, valid, bits, k,
                                                top_k))


@pytest.mark.parametrize("live_frac", [0.0, 0.1, 0.9, 1.0])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_masked_fused_scored_kernel_bit_exact(gen, bits, dtype, live_frac):
    for nq, n, k, m, top_k in ((3, 37, 17, 9, 7), (9, 3000, 64, 64, 10),
                               (4, 33, 33, 40, 10), (2, 0, 17, 5, 3)):
        wq, wdb = _words(gen, nq, k, bits), _words(gen, n, k, bits)
        if n:
            wdb[n // 2] = wq[0]
        valid = _mask(gen, n, live_frac)
        tab, scl = _tables(gen, nq, wq.shape[1], bits, dtype)
        assert _same(ops.fused_scored_topk_masked(wq, tab, wdb, valid, bits, k,
                                                  m, top_k, scales=scl,
                                                  impl="kernel"),
                     ref.fused_scored_topk_masked_ref(wq, tab, wdb, valid,
                                                      bits, k, m, top_k,
                                                      scales=scl))


@pytest.mark.parametrize("kwargs", [
    dict(), dict(scored=True), dict(scored=True, table_dtype="int8"),
    dict(scored=True, fused=False), dict(mode="lsh"),
    dict(mode="lsh", scored=True, n_probes=1)])
def test_mutable_engine_modes_match_plain_versions(gen, kwargs):
    from repro_torch.ann.bands import BandSpec
    from repro_torch.ann.engine import SearchConfig
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
    from repro_torch.index import CompactionPolicy, MutableAnnEngine
    crp = CodedRandomProjection(SketchConfig(k=100), 96)
    x = torch.randn((3000, 96), generator=gen, device="cuda")
    x = x / x.norm(dim=1, keepdim=True)
    eng = MutableAnnEngine(crp, band_spec=BandSpec(8, 4), tail_rows=512)
    ids = eng.ingest(x, chunk_rows=700)
    eng.delete(ids[1::3])
    eng.upsert(ids[:40], x[:40])            # live rows move to the tail
    codes = eng.encode_queries(x[:40] + 0.001 * torch.randn(
        (40, 96), generator=gen, device="cuda"))
    for _ in range(2):                      # before and after compaction
        got = eng.search_codes(codes, SearchConfig(chunk_q=16, **kwargs))
        want = eng.search_codes(codes, SearchConfig(chunk_q=16, impl="ref",
                                                    **kwargs))
        assert _same(got, want)
        assert got[0][:, 0].tolist() == list(range(40))
        eng.compact(CompactionPolicy(target_rows=1024))


# -- the encode kernels: code_pack, the R draw, the CSR step --------------------

@pytest.mark.parametrize("k", [1, 7, 31, 256])
@pytest.mark.parametrize("scheme,w", [("sign", 1.0), ("2bit", 0.75),
                                      ("uniform", 0.75), ("offset", 1.0)])
def test_code_pack_kernel_bit_exact(gen, scheme, w, k):
    spec = CodeSpec(scheme, w)
    q = torch.rand((k,), generator=gen, device="cuda") * w \
        if scheme == "offset" else None
    for m in (0, 1, 33, 3000):
        z = 3.0 * torch.randn((m, k), generator=gen, device="cuda")
        z[:, ::3] = torch.round(z[:, ::3] / w) * w     # values on bin edges
        got = ops.code_pack(z, spec, q, impl="kernel")
        assert got.shape == (m, packing.packed_width(k, spec.bits))
        assert torch.equal(got, ref.code_pack_ref(z, spec, q))


@pytest.mark.parametrize("k", [1, 7, 256])
@pytest.mark.parametrize("width", [1, 217, 4096])
def test_normal_unit_kernel_bit_exact(gen, width, k):
    from repro_torch.core import prng
    key = prng.fold_in(prng.PRNGKey(2 ** 31 + 5), 789)
    got = ops.normal_unit(key, width, k, "cuda", impl="kernel")
    want = prng.normal(key, (width, k))                 # on the CPU
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def test_normal_from_bits_kernel_on_every_mantissa(gen):
    bits = (torch.arange(1 << 23, device="cuda", dtype=torch.int64) << 9)
    got = ops.normal_from_bits(packing.as_i32(bits), impl="kernel")
    want = ops.normal_from_bits(packing.as_i32(bits), impl="ref")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _csr_cases(gen, n, d):
    """indptr, indices, data on the card: empty rows, repeated columns, a
    row wholly in the ragged last unit and rows across many units."""
    lens = torch.randint(0, 60, (n,), generator=gen, device="cuda")
    lens[::7] = 0
    lens[3] = 300
    indptr = torch.cat([torch.zeros(1, dtype=torch.int64, device="cuda"),
                        torch.cumsum(lens, 0)])
    nnz = int(indptr[-1])
    cols = torch.randint(0, d, (nnz,), generator=gen, device="cuda",
                         dtype=torch.int32)
    a = int(indptr[5])
    cols[a:a + int(lens[5])] = d - 1 - torch.arange(
        int(lens[5]), device="cuda", dtype=torch.int32) % 10
    b = int(indptr[3])
    cols[b + 1:b + 9] = cols[b]
    return indptr, cols, torch.randn((nnz,), generator=gen, device="cuda")


@pytest.mark.parametrize("k", [7, 256, 300])
def test_csr_unit_step_kernel_bit_exact(gen, k):
    d, ru = 10_000, 1024                    # 10 units, the last 784 columns
    indptr, cols, data = _csr_cases(gen, 200, d)
    empty = (indptr[:1].expand(201).contiguous(),
             cols[:0], data[:0])
    for ip, ix, dv in ((indptr, cols, data), empty):
        acc_k = torch.randn((200, k), generator=gen, device="cuda")
        acc_r = acc_k.clone()
        for u in range((d + ru - 1) // ru):
            r = torch.randn((min(ru, d - u * ru), k), generator=gen,
                            device="cuda")
            ops.csr_unit_step(acc_k, ip, ix, dv, r, u * ru, impl="kernel")
            ops.csr_unit_step(acc_r, ip, ix, dv, r, u * ru, impl="ref")
        assert torch.equal(acc_k.view(torch.int32), acc_r.view(torch.int32))


def test_sparse_and_streamed_encode_match_plain_versions(gen):
    """The whole streamed and CSR regimes on the card (draw, step,
    code_pack) against the same calls through the plain versions."""
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
    from repro_torch.encode import CsrMatrix, StreamingEncoder
    crp = CodedRandomProjection(SketchConfig(k=100, r_unit=1024), 10_000)
    indptr, cols, data = _csr_cases(gen, 200, 10_000)
    csr = CsrMatrix(indptr.cpu().numpy(), cols.cpu().numpy(),
                    data.cpu().numpy(), (200, 10_000))
    enc = StreamingEncoder(crp, r_cap_elems=1)
    assert torch.equal(enc.encode_packed(csr), enc.encode_packed(csr,
                                                                 impl="ref"))
    x = torch.from_numpy(csr.densify()).cuda()
    assert torch.equal(enc.project(x), enc.project(x, impl="ref"))
    assert enc._rmat is None


def _bits_equal(got, want):
    return got.shape == want.shape and torch.equal(got.view(torch.int32),
                                                   want.view(torch.int32))


@pytest.mark.parametrize("bits,k", [(1, 100), (2, 33), (2, 256), (4, 100),
                                    (8, 33), (16, 33)])
def test_packed_linear_kernels_bit_exact(gen, bits, k):
    """Forward, backward and both masked forms against their plain
    versions at ragged shapes: N across chunk and mask-word edges, C above
    the forward's class tile, block_n 32 and 512, 10 % dead."""
    from repro_torch.kernels.packed_linear import fwd_class_tile
    w = _words(gen, 1000, k, bits)
    fp = (w.shape[1] * (32 // bits)) << bits
    tile = fwd_class_tile(fp)
    for c in (1, 3) + ((tile + 1,) if 0 < tile < 40 else ()):
        tab = torch.randn((c, fp), generator=gen, device="cuda")
        for n in (0, 1, 33, 1000):
            words = w[:n]
            g = torch.randn((c, n), generator=gen, device="cuda")
            valid = packing.pack_bitmask(
                torch.rand((n,), generator=gen, device="cuda") >= 0.1)
            assert _bits_equal(ops.packed_linear_fwd(tab, words, bits,
                                                     impl="kernel"),
                               ref.packed_linear_fwd_ref(tab, words, bits))
            assert _bits_equal(
                ops.packed_linear_fwd_masked(tab, words, valid, bits,
                                             impl="kernel"),
                ref.packed_linear_fwd_masked_ref(tab, words, valid, bits))
            for bn in (32, 512):
                assert _bits_equal(
                    ops.packed_linear_bwd(g, words, bits, impl="kernel",
                                          block_n=bn),
                    ref.packed_linear_bwd_ref(g, words, bits, block_n=bn))
                assert _bits_equal(
                    ops.packed_linear_bwd_masked(g, words, valid, bits,
                                                 impl="kernel", block_n=bn),
                    ref.packed_linear_bwd_masked_ref(g, words, valid, bits,
                                                     block_n=bn))


def test_fit_words_three_steps_bit_exact(gen):
    """Three full-batch Adam steps through the kernels equal the same
    steps through the plain versions, bit for bit."""
    from repro_torch.learn import LearnConfig, fit_words
    words = _words(gen, 3000, 256, 2)
    y = torch.where(torch.rand((3000,), generator=gen, device="cuda") < 0.5,
                    1, -1)
    spec = CodeSpec("2bit", 0.75)
    got = fit_words(words, y, spec, LearnConfig(steps=3), k=256)
    want = fit_words(words, y, spec, LearnConfig(steps=3, impl="ref"), k=256)
    assert _bits_equal(got.tables, want.tables)
    assert _bits_equal(got.bias, want.bias)
