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
from repro_torch.kernels import lut_topk, ops, ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; torch's intra-op threads would
    compete with them, so this file runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# bits 1, 2, 4, 4, 8 and 16 for encode_fused
@pytest.mark.parametrize("scheme,w", [("sign", 1.0), ("2bit", 0.75),
                                      ("uniform", 0.75), ("offset", 1.0),
                                      ("uniform", 0.1), ("uniform", 0.01)])
def test_gemm_kernels_match_plain(gen, scheme, w):
    """The 3xTF32 GEMM kernels against the float32 plain version at the
    shapes their tiles and loads must survive: M across one and many
    row blocks, D % 4 != 0 (the cp.async load) and D % 4 == 0 (TMA), K
    across column blocks; float32 and bf16 R, the prepared R passed and
    absent; two launches bit-identical, and coded_project equal to the
    unpacked words of encode_fused."""
    spec = CodeSpec(scheme, w)
    for m in (1, 7, 64, 129, 300, 1024):
        for d in (33, 96, 1024):
            for k in (17, 100, 256):
                x = torch.randn((m, d), generator=gen, device="cuda")
                x = x / x.norm(dim=1, keepdim=True)
                r32 = torch.randn((d, k), generator=gen, device="cuda")
                q = torch.rand((k,), generator=gen, device="cuda") * w \
                    if scheme == "offset" else None
                for r in (r32, r32.to(torch.bfloat16)):
                    z = torch.matmul(x, r.float())
                    want = ref.coded_project_ref(x, r, spec, q)
                    near = _near_edge(z, spec, q)
                    split = ops.split_r(r)
                    got = ops.coded_project(x, r, spec, q, impl="kernel")
                    assert not bool(((got != want) & ~near).any())
                    assert torch.equal(got, ops.coded_project(
                        x, r, spec, q, impl="kernel", r_split=split))
                    words = ops.encode_fused(x, r, spec, q, impl="kernel",
                                             r_split=split)
                    assert words.shape == (m, packing.packed_width(
                        k, spec.bits))
                    assert torch.equal(words, ops.encode_fused(
                        x, r, spec, q, impl="kernel"))
                    # fields past k are zero and every row codes alike
                    assert torch.equal(words, packing.pack_codes(got,
                                                                 spec.bits))


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


@pytest.mark.parametrize("full_range", [False, True])
@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_pack_codes_kernel_bit_exact(gen, bits, full_range):
    """Both forms of the packing kernel (16-byte loads of aligned rows;
    4-byte loads, here forced by a one-element storage offset) against
    the plain version: K across ragged words and K % 4, M from 0 to more
    than one block, codes in [0, 2^b) and over the whole int32 range
    (the word is a sum of shifted codes, so the lane adds must keep it)."""
    from repro_torch.kernels.pack_codes import pack_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for k in (1, 7, 31, 100, 256, 257):
        for m in (0, 1, 255, 4097):
            lo, hi = (-2 ** 31, 2 ** 31) if full_range else (0, 1 << bits)
            flat = torch.randint(lo, hi, (m * k + 1,), generator=gen,
                                 device="cuda", dtype=torch.int64)
            flat = flat.to(torch.int32)
            for offset in (0, 1):
                codes = flat[offset:offset + m * k].view(m, k)
                want_form = "16-byte" if k % 4 == 0 and offset == 0 \
                    else "4-byte"
                # (an empty tensor's data_ptr is 0: nothing launches)
                assert m == 0 or pack_plan(
                    m, k, bits, sms, codes.data_ptr() % 16 == 0
                )["form"] == want_form
                got = ops.pack_codes(codes, bits, impl="kernel")
                assert torch.equal(got, ref.pack_codes_ref(codes, bits)), \
                    (k, m, offset)


def test_pack_codes_casts_integer_codes(gen):
    """int64 codes (values past 2^31 included) and uint8 codes pack on
    the card as in the plain version: their low 32 bits."""
    wide = torch.randint(-2 ** 40, 2 ** 40, (300, 100), generator=gen,
                         device="cuda", dtype=torch.int64)
    wide[0, :4] = torch.tensor([2 ** 31, 2 ** 32 + 3, -1, 2 ** 33 - 1])
    small = torch.randint(0, 256, (300, 100), generator=gen, device="cuda",
                          dtype=torch.int64).to(torch.uint8)
    for codes in (wide, small):
        for bits in (1, 2, 8, 16):
            assert torch.equal(ops.pack_codes(codes, bits),
                               ops.pack_codes(codes, bits, impl="ref"))


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


def _any_words(gen, n, w):
    """Words of random bits: every code in every field slot, padding
    fields too."""
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (n, w), generator=gen,
                         device="cuda", dtype=torch.int32)


@pytest.mark.parametrize("block_q", [None, 64, 128])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_collision_counts_kernel_bit_exact(gen, bits, block_q):
    """Both kernels of counts_plan (tensor cores at 1 and 2 bits, at QB 64
    and 128, with TMA stores at N 64 and 3,004 and 4-byte stores at the
    other N; popcount at 4 and 8) against the plain version: N across the
    64-row tiles, Q across the query blocks, W 1-16 with padded fields (k
    short of 32W/b), packed codes and words of random bits, the all-ones
    word, exact hits."""
    from repro_torch.kernels import packed_collision as pc
    wq, wdb = _words(gen, 37, 100, bits), _words(gen, 3001, 100, bits)
    assert torch.equal(ops.packed_collision_counts(wq, wdb, bits, 100,
                                                   impl="kernel"),
                       ref.packed_collision_ref(wq, wdb, bits, 100))
    for w in (1, 4, 9, 16):
        k = 32 * w // bits - 1
        for nq in (1, 37, 64, 129):
            for n in (1, 63, 64, 65, 3001, 3004):
                wq = _any_words(gen, nq, w)
                wdb = _any_words(gen, n, w)
                wq[0] = -1
                wdb[0] = -1
                wdb[n // 2] = wq[nq // 2]
                if n > 3:
                    wdb[3:] = torch.where(wdb[3:] % 3 == 0, wq[-1], wdb[3:])
                p = pc.counts_plan(nq, n, w, bits, block_q, wq.device)
                assert p["kernel"] == ("tensor" if bits <= 2 else "popcount")
                if bits <= 2:
                    assert p["store"] == ("tma" if n % 4 == 0 else "4-byte")
                before = ops.launch_counts()
                got = ops.packed_collision_counts(wq, wdb, bits, k,
                                                  impl="kernel",
                                                  block_q=block_q)
                after = ops.launch_counts()
                assert after["packed_collision_counts"] == \
                    before["packed_collision_counts"] + 1
                assert after["packed_counts_tc"] == \
                    before["packed_counts_tc"] + (bits <= 2)
                assert torch.equal(got, ref.packed_collision_ref(
                    wq, wdb, bits, k)), (w, nq, n, p)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_lut_rerank_kernel_bit_exact(gen, bits, dtype):
    """Both kernels of rerank_plan against the plain version: the warp
    kernel at every CPL (M 1-128), the block kernel at M in the thousands
    and, launched apart, at the warp kernel's shapes; top_k above M, a
    query with no valid candidate, all candidates tied (equal table
    entries)."""
    from repro_torch.kernels import packed_lut as pl
    for nq, m, top_k in ((13, 50, 7), (5, 2000, 10), (3, 4, 9), (40, 1, 3),
                         (9, 31, 40), (33, 32, 10), (300, 64, 10),
                         (7, 65, 70), (5, 128, 10)):
        w = -(-33 // (32 // bits))
        tab, _ = _tables(gen, nq, w, bits, dtype)
        cand = _words(gen, nq * m, 33, bits).reshape(nq, m, -1)
        valid = torch.rand((nq, m), generator=gen, device="cuda") > 0.3
        valid[nq // 2] = False
        for t in (tab, torch.ones_like(tab)):   # the second: all tied
            want = ref.packed_lut_rerank_ref(t, cand, valid, bits, top_k)
            p = pl.rerank_plan(nq, m, w, bits, t.dtype, device=t.device)
            assert p["kernel"] == ("warp" if m <= 128 else "block")
            before = ops.launch_counts()["packed_lut_rerank_warp"]
            assert _same(ops.packed_lut_rerank(t, cand, valid, bits, top_k,
                                               impl="kernel"), want)
            assert ops.launch_counts()["packed_lut_rerank_warp"] == \
                before + (p["kernel"] == "warp")
            if p["kernel"] == "warp":   # the block kernel at this shape
                got = (torch.empty_like(want[0]), torch.empty_like(want[1]))
                pl._launch(dict(kernel="block"), t,
                           pl.TABLE_DTYPES[t.dtype], cand, valid, bits,
                           top_k, *got)
                assert _same(got, want)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [7, 256, 300])
@pytest.mark.parametrize("group", [1, 2, 8])
def test_csr_group_step_kernel_bit_exact(gen, group, k, dtype):
    """Groups of G units from unit 0 (10 units, the last 784 columns; a
    row of 300 entries, past the 128 a warp holds in registers) against
    the plain version and against the kernel of one unit a launch; the
    slot of unit 4, which no entry touches, holds NaN."""
    d, ru = 10_000, 1024
    indptr, cols, data = _csr_cases(gen, 200, d)
    cols[cols // ru == 4] += ru
    units = [torch.randn((min(ru, d - u * ru), k), generator=gen,
                         device="cuda").to(dtype) for u in range(10)]
    acc0 = torch.randn((200, k), generator=gen, device="cuda")
    acc_k, acc_r, acc_u = acc0.clone(), acc0.clone(), acc0.clone()
    for u0 in range(0, 10, group):
        span = min(group * ru, d - u0 * ru)
        r = torch.full((-(-span // ru), ru, k), float("nan"), device="cuda",
                       dtype=dtype)
        for g in range(r.shape[0]):
            if u0 + g != 4:
                r[g, :units[u0 + g].shape[0]] = units[u0 + g]
        ops.csr_group_step(acc_k, indptr, cols, data, r, u0 * ru, span,
                           impl="kernel")
        ops.csr_group_step(acc_r, indptr, cols, data, r, u0 * ru, span,
                           impl="ref")
    for u, r in enumerate(units):
        ops.csr_unit_step(acc_u, indptr, cols, data, r, u * ru,
                          impl="kernel")
    assert torch.equal(acc_k.view(torch.int32), acc_r.view(torch.int32))
    assert torch.equal(acc_k.view(torch.int32), acc_u.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normal_unit_group_kernel_bit_exact(gen, dtype):
    """The last 8 units of the URL sketch (the last one 217 rows) in one
    launch, unit 785 not given: each slot equal to the draw of one unit
    a launch; the slot not given keeps its values."""
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
    crp = CodedRandomProjection(SketchConfig(
        k=256, dtype="bfloat16" if dtype == torch.bfloat16 else "float32"),
        3_231_961)
    units = [782, 783, 784, 786, 787, 788, 789]
    out = torch.full((8, 4096, 256), 3.0, device="cuda", dtype=dtype)
    crp._draw_units(units, out, impl="kernel")
    iv = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for u in units:
        want = crp._block_r(u, crp.unit_width(u), impl="kernel")
        assert torch.equal(out[u - 782, :want.shape[0]].view(iv),
                           want.view(iv))
    assert crp.unit_width(789) == 217
    assert bool((out[3] == 3.0).all()) and bool((out[7, 217:] == 3.0).all())


def test_grouped_csr_encode_matches_plain_versions(gen):
    """The CSR regime at G = 3 (f32) and G = 4 (bf16) on the card against
    the same calls through the plain versions."""
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
    from repro_torch.encode import CsrMatrix, StreamingEncoder
    indptr, cols, data = _csr_cases(gen, 200, 10_000)
    csr = CsrMatrix(indptr.cpu().numpy(), cols.cpu().numpy(),
                    data.cpu().numpy(), (200, 10_000))
    for dtype, group in (("float32", 3), ("bfloat16", 4)):
        crp = CodedRandomProjection(SketchConfig(k=100, r_unit=1024,
                                                 dtype=dtype), 10_000)
        enc = StreamingEncoder(crp, r_cap_elems=2 * group * 1024 * 100)
        assert enc.csr_group == group
        assert torch.equal(enc.encode_packed(csr),
                           enc.encode_packed(csr, impl="ref"))


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
def test_packed_linear_kernels_bit_exact(gen, bits, k, monkeypatch):
    """Forward, backward and both masked forms against their plain
    versions at ragged shapes: N across chunk and mask-word edges, C 1, 3,
    8, 9 and above the forward's class tile, all, none, 10 % and 90 % dead
    for the forward; the backward at block_n 32 and 512 with 10 % dead at
    every N, and at block_n 1, 100 and 1,000 (a chunk the tiled partial
    kernel walks in several row tiles) with all, none, 10 % and 90 % of
    the rows dead (at 16 bits, whose partials are 256 KB a field, up to N
    = 101), and with its partials folded in groups of three chunks. Then
    the forward's grid: N across its 256-row tiles (255, 256, 257, 513,
    1,000) with its grid as planned and shrunk to two blocks a class tile
    (each then walks several row tiles), on words 16-byte aligned and
    shifted by one word (4-byte loads), every mask; and tables too wide
    for shared memory (the memory form, reached by shrinking the tables'
    budget) at every width."""
    from repro_torch.kernels import packed_linear
    from repro_torch.kernels.packed_linear import fwd_class_tile
    w = _words(gen, 1000, k, bits)
    fp = (w.shape[1] * (32 // bits)) << bits
    tile = fwd_class_tile(fp)
    wide = bits != 16
    classes = ((1, 3, 8, 9) if wide else (1, 3)) + \
        ((tile + 1,) if 0 < tile < 40 else ())
    sizes = (0, 1, 31, 33, 100, 101, 1000) if wide else (0, 1, 33, 101,
                                                          1000)
    for c in classes:
        tab = torch.randn((c, fp), generator=gen, device="cuda")
        p = packed_linear.bwd_plan(1000, w.shape[1], bits, c, 1000)
        assert p["form"] == ("tiled" if bits <= 4 else "mem")
        if p["form"] == "tiled":
            assert p["tiles_per_chunk"] > 1
        for n in sizes:
            words = w[:n]
            g = torch.randn((c, n), generator=gen, device="cuda")
            masks = [_mask(gen, n, live) for live in (0.0, 1.0, 0.9, 0.1)]
            valid = masks[2]
            full = wide or n <= 101
            assert _bits_equal(ops.packed_linear_fwd(tab, words, bits,
                                                     impl="kernel"),
                               ref.packed_linear_fwd_ref(tab, words, bits))
            for vw in masks:
                assert _bits_equal(
                    ops.packed_linear_fwd_masked(tab, words, vw, bits,
                                                 impl="kernel"),
                    ref.packed_linear_fwd_masked_ref(tab, words, vw, bits))
            for bn in (1, 32, 100, 512, 1000) if full else (32, 512):
                assert _bits_equal(
                    ops.packed_linear_bwd(g, words, bits, impl="kernel",
                                          block_n=bn),
                    ref.packed_linear_bwd_ref(g, words, bits, block_n=bn))
                for vw in masks if full else [valid]:
                    assert _bits_equal(
                        ops.packed_linear_bwd_masked(g, words, vw, bits,
                                                     impl="kernel",
                                                     block_n=bn),
                        ref.packed_linear_bwd_masked_ref(g, words, vw, bits,
                                                         block_n=bn))
    # ten chunks of partials in groups of three
    c, n = 3, 1000
    g = torch.randn((c, n), generator=gen, device="cuda")
    monkeypatch.setattr(packed_linear, "PART_BYTES_MAX", 3 * 4 * c * fp)
    assert _bits_equal(ops.packed_linear_bwd(g, w, bits, impl="kernel",
                                             block_n=100),
                       ref.packed_linear_bwd_ref(g, w, bits, block_n=100))
    valid = _mask(gen, n, 0.9)
    assert _bits_equal(
        ops.packed_linear_bwd_masked(g, w, valid, bits, impl="kernel",
                                     block_n=100),
        ref.packed_linear_bwd_masked_ref(g, w, valid, bits, block_n=100))
    # the forward's grid: row tiles, two blocks a class tile, unaligned rows
    flat = _words(gen, 1001, k, bits).reshape(-1)
    for c in classes:
        tab = torch.randn((c, fp), generator=gen, device="cuda")
        for n in (255, 256, 257, 513, 1000):
            masks = [_mask(gen, n, live) for live in (0.0, 1.0, 0.9, 0.1)]
            for shift in (0, 1):
                words = flat[shift:shift + n * w.shape[1]].view(n, -1)
                for blocks in (None, 2):
                    with monkeypatch.context() as m:
                        if blocks:
                            m.setattr(packed_linear, "FWD_BLOCKS_MAX", blocks)
                        p = packed_linear.fwd_plan(n, w.shape[1], bits, c)
                        assert p["form"] == ("smem" if tile else "mem")
                        if blocks and tile:
                            assert p["grid"][0] == min(p["tiles"], 2)
                        assert _bits_equal(
                            ops.packed_linear_fwd(tab, words, bits,
                                                  impl="kernel"),
                            ref.packed_linear_fwd_ref(tab, words, bits))
                        for vw in masks:
                            assert _bits_equal(
                                ops.packed_linear_fwd_masked(
                                    tab, words, vw, bits, impl="kernel"),
                                ref.packed_linear_fwd_masked_ref(
                                    tab, words, vw, bits))
    # tables too wide for shared memory: the memory form
    monkeypatch.setattr(packed_linear, "SMEM_TABLE_MAX", 64)
    for c in (1, 3, 9):
        tab = torch.randn((c, fp), generator=gen, device="cuda")
        assert packed_linear.fwd_plan(1000, w.shape[1], bits,
                                      c)["form"] == "mem"
        for n in (33, 1000):
            assert _bits_equal(ops.packed_linear_fwd(tab, w[:n], bits,
                                                     impl="kernel"),
                               ref.packed_linear_fwd_ref(tab, w[:n], bits))
            for live in (0.0, 0.9):
                vw = _mask(gen, n, live)
                assert _bits_equal(
                    ops.packed_linear_fwd_masked(tab, w[:n], vw, bits,
                                                 impl="kernel"),
                    ref.packed_linear_fwd_masked_ref(tab, w[:n], vw, bits))


@pytest.mark.parametrize("bits,k", [(1, 100), (2, 256), (4, 100)])
def test_packed_linear_bwd_mem_form_bit_exact(gen, bits, k, monkeypatch):
    """The backward's device-memory form at 1-, 2- and 4-bit fields, the
    form a row too wide for two shared-memory slots takes (here a block's
    shared memory shrunk so that it does), against the plain versions:
    block_n 32 and 100, N across chunk and mask-word edges, 10 % and all
    dead."""
    from repro_torch.kernels import packed_linear
    monkeypatch.setattr(packed_linear, "SMEM_BLOCK_MAX", 64)
    w = _words(gen, 1000, k, bits)
    for c in (1, 3):
        assert packed_linear.bwd_plan(1000, w.shape[1], bits, c,
                                      100)["form"] == "mem"
        for n in (1, 33, 1000):
            words = w[:n]
            g = torch.randn((c, n), generator=gen, device="cuda")
            for bn in (32, 100):
                assert _bits_equal(
                    ops.packed_linear_bwd(g, words, bits, impl="kernel",
                                          block_n=bn),
                    ref.packed_linear_bwd_ref(g, words, bits, block_n=bn))
                for live in (0.9, 0.0):
                    vw = _mask(gen, n, live)
                    assert _bits_equal(
                        ops.packed_linear_bwd_masked(g, words, vw, bits,
                                                     impl="kernel",
                                                     block_n=bn),
                        ref.packed_linear_bwd_masked_ref(g, words, vw, bits,
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


# -- the serving slice: TPU kernels 15-17, the autotuner, the repairs ----------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_lut_topk_kernels_bit_exact(gen, bits, dtype):
    k = 17 if bits == 16 else 40
    for nq, n, top_k in ((9, 3000, 10), (5, 33, 50), (3, 31, 7), (2, 1, 3),
                         (2, 0, 3)):
        wq, wdb = _words(gen, nq, k, bits), _words(gen, n, k, bits)
        tab, _ = _tables(gen, nq, wq.shape[1], bits, dtype)
        assert _same(ops.packed_lut_topk(tab, wdb, bits, top_k,
                                         impl="kernel"),
                     ref.packed_lut_topk_ref(tab, wdb, bits, top_k))
        for live_frac in (0.0, 0.1, 0.9, 1.0):
            valid = _mask(gen, n, live_frac)
            assert _same(ops.packed_lut_topk_masked(tab, wdb, valid, bits,
                                                    top_k, impl="kernel"),
                         ref.packed_lut_topk_masked_ref(tab, wdb, valid,
                                                        bits, top_k))
    # every row tied: ties go to the lowest ids
    tab = torch.ones((2, tab.shape[1]), device="cuda")
    wdb = _words(gen, 500, k, bits)
    got = ops.packed_lut_topk(tab, wdb, bits, 20, impl="kernel")
    assert _same(got, ref.packed_lut_topk_ref(tab, wdb, bits, 20))
    assert got[1][0].tolist() == list(range(20))
    # the grid: Q around the fields kernel's blocks of 8 and 16, N ragged
    # against its 256-row tiles and 32-row offers, S and QB given (a QB
    # that cannot fit, or 16 for the generic kernel, is refused); every
    # default launch twice
    wdb = _words(gen, 2081, k, bits)
    valid = _mask(gen, 2081, 0.9)
    w = wdb.shape[1]
    for nq in (1, 7, 8, 9, 17, 300):
        tab, _ = _tables(gen, nq, w, bits, dtype)
        for vw in (None, valid):
            def run(**kw):
                if vw is None:
                    return ops.packed_lut_topk(tab, wdb, bits, 10,
                                               impl="kernel", **kw)
                return ops.packed_lut_topk_masked(tab, wdb, vw, bits, 10,
                                                  impl="kernel", **kw)
            want = ref.packed_lut_topk_ref(tab, wdb, bits, 10) \
                if vw is None else \
                ref.packed_lut_topk_masked_ref(tab, wdb, vw, bits, 10)
            first = run()
            assert _same(first, want) and _same(run(), first)
            for s in (1, 3, 64):
                for qb in (None, 8, 16):
                    if lut_topk.fields_layout(w, bits, 10, qb or 8) is None \
                            and qb == 16:
                        with pytest.raises(ValueError, match="block_q|generic"):
                            run(n_ranges=s, block_q=qb)
                        continue
                    assert _same(run(n_ranges=s, block_q=qb), want), \
                        (nq, s, qb, vw is None)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k,top_k,kernel", [
    (256, 10, "fields"), (256, 1500, "fields"), (264, 10, "generic")])
def test_lut_topk_table_limits(gen, dtype, k, top_k, kernel):
    """4-bit tables at k = 256, the largest the fields kernel takes (at
    top_k 1,500 its lists live in device memory), and at k = 264, one
    field a word past it: the generic kernel's."""
    bits, n, nq = 4, 2081, 17
    wdb = _words(gen, n, k, bits)
    tab, _ = _tables(gen, nq, wdb.shape[1], bits, dtype)
    valid = _mask(gen, n, 0.9)
    assert lut_topk.plan(tab.dtype, nq, n, wdb.shape[1], bits, top_k,
                         device="cuda")["kernel"] == kernel
    got = ops.packed_lut_topk(tab, wdb, bits, top_k, impl="kernel")
    assert _same(got, ref.packed_lut_topk_ref(tab, wdb, bits, top_k))
    assert _same(ops.packed_lut_topk(tab, wdb, bits, top_k, impl="kernel",
                                     n_ranges=3), got)
    assert _same(ops.packed_lut_topk_masked(tab, wdb, valid, bits, top_k,
                                            impl="kernel"),
                 ref.packed_lut_topk_masked_ref(tab, wdb, valid, bits,
                                                top_k))


def test_collision_counts_kernel_on_any_codes(gen):
    vals = torch.tensor([-2, -1, 0, 1, 7, 2 ** 31 - 1, -2 ** 31],
                        device="cuda", dtype=torch.int32)
    for nq, n, k in ((37, 3001, 100), (1, 1, 1), (130, 257, 256), (3, 0, 5),
                     (0, 9, 4)):
        cq = vals[torch.randint(0, 7, (nq, k), generator=gen, device="cuda")]
        cdb = vals[torch.randint(0, 7, (n, k), generator=gen, device="cuda")]
        want = ref.collision_counts_ref(cq, cdb)
        for bq in (32, 64, 128):
            for bn in (32, 64, 128):
                got = ops.collision_counts(cq, cdb, impl="kernel", block_q=bq,
                                           block_n=bn)
                assert torch.equal(got, want)


def _sweep_calls(gen):
    """op -> a call of it with given knobs, on small tensors."""
    from repro_torch.core.schemes import CodeSpec as Spec
    bits, k, n, nq = 2, 64, 5000, 20
    wq, wdb = _words(gen, nq, k, bits), _words(gen, n, k, bits)
    valid = _mask(gen, n, 0.9)
    tab, _ = _tables(gen, nq, wq.shape[1], bits, "f32")
    codes = torch.randint(0, 4, (nq, k), generator=gen, device="cuda",
                          dtype=torch.int32)
    z = torch.randn((777, k), generator=gen, device="cuda")
    cdb = torch.randint(0, 4, (300, k), generator=gen, device="cuda",
                        dtype=torch.int32)
    return {
        "pack_codes": lambda c: ops.pack_codes(codes, bits, **c),
        "code_pack": lambda c: ops.code_pack(z, Spec("2bit", 0.75), **c),
        "collision_counts": lambda c: ops.collision_counts(codes, cdb, **c),
        "packed_collision_counts": lambda c: ops.packed_collision_counts(
            wq, wdb, bits, k, **c),
        "packed_topk": lambda c: ops.packed_topk(wq, wdb, bits, k, 10, **c),
        "packed_topk_masked": lambda c: ops.packed_topk_masked(
            wq, wdb, valid, bits, k, 10, **c),
        "packed_lut_topk": lambda c: ops.packed_lut_topk(tab, wdb, bits, 10,
                                                         **c),
        "packed_lut_topk_masked": lambda c: ops.packed_lut_topk_masked(
            tab, wdb, valid, bits, 10, **c),
        "fused_scored_topk": lambda c: ops.fused_scored_topk(
            wq, tab, wdb, bits, k, 64, 10, **c),
        "fused_scored_topk_masked": lambda c: ops.fused_scored_topk_masked(
            wq, tab, wdb, valid, bits, k, 64, 10, **c),
    }


def test_autotune_grid_is_bit_identical(gen):
    """Every candidate of every swept op gives the default's bits, and a
    measured sweep records a winner from the grid."""
    from repro_torch.kernels import autotune
    calls = _sweep_calls(gen)
    assert set(calls) == set(autotune.SWEEPS)
    for op, run in calls.items():
        want = run({})
        want = want if isinstance(want, tuple) else (want,)
        for config in autotune.candidate_configs(op):
            got = run(config)
            assert _same(got if isinstance(got, tuple) else (got,), want), \
                (op, config)
    cache = autotune.AutotuneCache()
    best = autotune.tune("packed_topk", calls["packed_topk"], torch.int32,
                         dict(q=20, n=5000, w=4, top_k=10), cache=cache)
    assert best in [{}] + autotune.candidate_configs("packed_topk")
    assert len(cache) == 1


def _tied_words(gen, nq, n, k, bits):
    """Queries and a corpus with query 0's words at rows spread over the
    ranges (ties across S) and a run of equal rows."""
    wq, wdb = _words(gen, nq, k, bits), _words(gen, n, k, bits)
    for r in (n // 7, n // 3, n // 2, n - 1):
        wdb[r] = wq[0]
    wdb[n // 5:n // 5 + 40] = wdb[n // 4]
    return wq, wdb


# (queries, rows, k, top_k): QB 64 (few queries, or lists of 64), QB 128,
# N not a multiple of the 64-row tile, N under one tile, k with padding
# fields, lists in device memory (top_k 128 at 2 bits, 2049 at both)
_TC_CASES = ((5, 3001, 100, 10), (70, 9000, 256, 10), (130, 4097, 256, 64),
             (9, 63, 33, 7), (3, 700, 256, 128), (2, 3000, 64, 2049))


@pytest.mark.parametrize("live_frac", [None, 0.0, 0.5])
@pytest.mark.parametrize("bits", [1, 2])
def test_tc_sweep_partial_lists_bit_exact(gen, bits, live_frac):
    """The tensor-core count sweep's partial lists [S, Q, top_k] against
    their plain version, at the default S and others (ties across
    ranges, ragged tiles, all rows dead)."""
    from repro_torch.kernels import packed_collision as pc
    for nq, n, k, top_k in _TC_CASES:
        wq, wdb = _tied_words(gen, nq, n, k, bits)
        valid = None if live_frac is None else _mask(gen, n, live_frac)
        for s in (None, 1, 2, 3, 7, 64):
            p = pc.plan(nq, n, wq.shape[1], bits, top_k, s, wq.device)
            assert p["kernel"] == "tensor"
            before = pc.tc_launches
            got = pc.packed_topk_partial_cuda(wq, wdb, valid, bits, k, top_k,
                                              n_ranges=s)
            assert pc.tc_launches == before + 1
            want = ref.packed_topk_partial_ref(wq, wdb, valid, bits, k,
                                               top_k, p["n_ranges"])
            assert _same(got, want), (nq, n, k, top_k, s, p)
            assert _same(pc.merge_ranges_cuda(*got),
                         ref.packed_topk_masked_ref(wq, wdb, valid, bits, k,
                                                    top_k)
                         if valid is not None else
                         ref.packed_topk_ref(wq, wdb, bits, k, top_k))


@pytest.mark.parametrize("bits", [1, 2])
def test_tc_sweep_ops_bit_exact(gen, bits):
    """The four top-k ops through the tensor-core sweep: bit-exact against
    their plain versions at every S, each launch counted."""
    from repro_torch.kernels import packed_collision as pc
    for nq, n, k, top_k in _TC_CASES[:4]:
        wq, wdb = _tied_words(gen, nq, n, k, bits)
        valid = _mask(gen, n, 0.8)
        tab, _ = _tables(gen, nq, wq.shape[1], bits, "f32")
        m = max(top_k, 16)
        for s in (None, 3, 64):
            before = pc.tc_launches
            assert _same(ops.packed_topk(wq, wdb, bits, k, top_k,
                                         impl="kernel", n_ranges=s),
                         ref.packed_topk_ref(wq, wdb, bits, k, top_k))
            assert _same(ops.packed_topk_masked(wq, wdb, valid, bits, k,
                                                top_k, impl="kernel",
                                                n_ranges=s),
                         ref.packed_topk_masked_ref(wq, wdb, valid, bits, k,
                                                    top_k))
            assert _same(ops.fused_scored_topk(wq, tab, wdb, bits, k, m, 10,
                                               impl="kernel", n_ranges=s),
                         ref.fused_scored_topk_ref(wq, tab, wdb, bits, k, m,
                                                   10))
            assert _same(ops.fused_scored_topk_masked(
                wq, tab, wdb, valid, bits, k, m, 10, impl="kernel",
                n_ranges=s),
                ref.fused_scored_topk_masked_ref(wq, tab, wdb, valid, bits, k,
                                                 m, 10))
            assert pc.tc_launches == before + 4


def test_topk_above_2048_on_the_card(gen):
    bits, k, n, nq = 2, 64, 20000, 5
    wq, wdb = _words(gen, nq, k, bits), _words(gen, n, k, bits)
    valid = _mask(gen, n, 0.9)
    tab, _ = _tables(gen, nq, wq.shape[1], bits, "f32")
    assert _same(ops.packed_topk(wq, wdb, bits, k, 2049, impl="kernel"),
                 ref.packed_topk_ref(wq, wdb, bits, k, 2049))
    assert _same(ops.packed_topk_masked(wq, wdb, valid, bits, k, 4000,
                                        impl="kernel"),
                 ref.packed_topk_masked_ref(wq, wdb, valid, bits, k, 4000))
    for m, top_k in ((2052, 513), (5000, 2100)):
        assert _same(ops.fused_scored_topk(wq, tab, wdb, bits, k, m, top_k,
                                           impl="kernel"),
                     ref.fused_scored_topk_ref(wq, tab, wdb, bits, k, m,
                                               top_k))
        assert _same(ops.fused_scored_topk_masked(
            wq, tab, wdb, valid, bits, k, m, top_k, impl="kernel"),
            ref.fused_scored_topk_masked_ref(wq, tab, wdb, valid, bits, k, m,
                                             top_k))
    assert _same(ops.packed_lut_topk(tab, wdb, bits, 2049, impl="kernel"),
                 ref.packed_lut_topk_ref(tab, wdb, bits, 2049))
    cand = _words(gen, nq * 3000, k, bits).reshape(nq, 3000, -1)
    cvalid = torch.rand((nq, 3000), generator=gen, device="cuda") > 0.2
    assert _same(ops.packed_lut_rerank(tab, cand, cvalid, bits, 2500,
                                       impl="kernel"),
                 ref.packed_lut_rerank_ref(tab, cand, cvalid, bits, 2500))


@pytest.mark.parametrize("kwargs", [
    dict(top_k=2049), dict(top_k=513, scored=True),
    dict(top_k=10, rerank_m=2100, scored=True, fused=False),
    dict(top_k=10, rerank_m=2100, scored=True, mode="lsh")])
def test_engine_above_2048_matches_plain_versions(gen, kwargs):
    from repro_torch.ann import AnnEngine, BandSpec
    from repro_torch.ann.engine import SearchConfig
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
    crp = CodedRandomProjection(SketchConfig(k=64), 32)
    x = torch.randn((6000, 32), generator=gen, device="cuda")
    eng = AnnEngine.build(crp, x, BandSpec(8, 4))
    codes = eng.encode_queries(x[:6])
    got = eng.search_codes(codes, SearchConfig(chunk_q=8, **kwargs))
    want = eng.search_codes(codes, SearchConfig(chunk_q=8, impl="ref",
                                                **kwargs))
    assert _same(got, want)


def test_bf16_draw_on_the_card(gen):
    from repro_torch.core import prng
    key = prng.fold_in(prng.PRNGKey(5), 9)
    got = ops.normal_unit(key, 4096, 256, "cuda", impl="kernel",
                          dtype=torch.bfloat16)
    want = prng.normal(key, (4096, 256), dtype=torch.bfloat16)   # the CPU
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))
    m = (prng.random_bits(key, (4096, 256)) >> 1) & 127
    assert torch.unique(m).numel() == 128                # all 128 uniforms


@pytest.mark.parametrize("scheme,w", [("2bit", 0.75), ("offset", 1.0)])
def test_bf16_sketch_kernels_match_plain(gen, scheme, w):
    """bf16 R through the GEMMs, bf16 z through code_pack, and a bf16
    sketch's regimes against ``impl="ref"`` (the GEMMs at bin edges
    only)."""
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
    from repro_torch.encode import CsrMatrix, StreamingEncoder
    spec = CodeSpec(scheme, w)
    x = torch.randn((300, 96), generator=gen, device="cuda")
    x = x / x.norm(dim=1, keepdim=True)
    r = torch.randn((96, 100), generator=gen, device="cuda").to(torch.bfloat16)
    q = (torch.rand((100,), generator=gen, device="cuda") * w).to(
        torch.bfloat16) if scheme == "offset" else None
    qf = None if q is None else q.float()
    want = ref.coded_project_ref(x, r, spec, q)
    near = _near_edge(torch.matmul(x, r.float()), spec, qf)
    got = ops.coded_project(x, r, spec, q, impl="kernel")
    assert not bool(((got != want) & ~near).any())
    got = packing.unpack_codes(ops.encode_fused(x, r, spec, q, impl="kernel"),
                               spec.bits, 100)
    assert not bool(((got != want) & ~near).any())
    z = (3.0 * torch.randn((777, 100), generator=gen, device="cuda")).to(
        torch.bfloat16)
    assert torch.equal(ops.code_pack(z, spec, q, impl="kernel"),
                       ref.code_pack_ref(z, spec, q))
    crp = CodedRandomProjection(SketchConfig(k=64, scheme=scheme, w=w,
                                             dtype="bfloat16", r_unit=256),
                                700)
    xs = torch.randn((200, 700), generator=gen, device="cuda") / 700 ** 0.5
    for cap in (1 << 24, 256 * 64):
        enc = StreamingEncoder(crp, r_cap_elems=cap)
        got = enc.encode_packed(xs)
        want = enc.encode_packed(xs, impl="ref")
        z = (enc.project(xs, impl="ref") if cap < 700 * 64
             else torch.matmul(xs, enc.r_matrix().float()))
        near = _near_edge(z.float(), spec, None if crp._offsets is None
                          else crp._offsets.float())
        diff = packing.unpack_codes(got, spec.bits, 64) != \
            packing.unpack_codes(want, spec.bits, 64)
        assert not bool((diff & ~near).any())
    sp = xs * (torch.rand(xs.shape, generator=gen, device="cuda") < 0.05)
    csr = CsrMatrix.from_dense(sp.cpu().numpy())
    enc = StreamingEncoder(crp)
    assert torch.equal(enc.encode_packed(csr), enc.encode_packed(csr,
                                                                 impl="ref"))


@pytest.mark.parametrize("scheme,w", [("2bit", 0.75), ("sign", 1.0),
                                      ("uniform", 0.75)])
def test_mle_estimator_on_the_card(gen, scheme, w):
    """``MleRhoEstimator.cell_counts`` on the card equals the CPU's bit for
    bit; ``estimate`` (a float32 product on each device) equals it except
    at near-ties, never more than one grid step away."""
    from repro_torch.core.estimators import MleRhoEstimator, mle_rho_2bit
    from repro_torch.obs.quality import synthetic_code_pairs
    spec = CodeSpec(scheme, w)
    est = MleRhoEstimator(spec, grid_size=128)
    step = est.rho_max / 127
    for rho in (0.3, 0.9):
        a, b = synthetic_code_pairs(spec, 100, rho, 500, seed=2)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        cc = est.cell_counts(ta.cuda(), tb.cuda())
        assert cc.is_cuda and torch.equal(cc.cpu(), est.cell_counts(ta, tb))
        got = est.estimate(ta.cuda(), tb.cuda()).cpu()
        want = est.estimate(ta, tb)
        assert bool(((got - want).abs() <= step * 1.0001).all())
        if scheme == "2bit":
            assert torch.equal(mle_rho_2bit(ta.cuda(), tb.cuda(), w,
                                            grid_size=128).cpu(), got)


@pytest.mark.parametrize("scheme,w", [("2bit", 0.75), ("offset", 1.0)])
def test_collision_monitor_batch_on_the_card(gen, scheme, w):
    """A ``CollisionMonitor`` batch reduced on the card pools the same
    int64 counts and per-pair fractions as on the CPU."""
    import numpy as np
    from repro_torch.obs import MetricsRegistry
    from repro_torch.obs.quality import CollisionMonitor, synthetic_code_pairs
    spec = CodeSpec(scheme, w)
    q = torch.full((64,), w / 3) if scheme == "offset" else None
    a, b = synthetic_code_pairs(spec, 64, 0.7, 300, seed=5, q=q)
    mons = [CollisionMonitor(spec, 64, registry=MetricsRegistry(),
                             grid_size=64) for _ in range(2)]
    out = [m.observe_pairs(torch.from_numpy(a).to(dev),
                           torch.from_numpy(b).to(dev))
           for m, dev in zip(mons, ("cuda", "cpu"))]
    assert out[0] == out[1]
    np.testing.assert_array_equal(mons[0].counts, mons[1].counts)
    assert (mons[0].frac.mean, mons[0].frac.std) == \
        (mons[1].frac.mean, mons[1].frac.std)


def test_service_quality_on_the_card(gen):
    """``AnnService(quality=)`` over a small mutable engine on the card:
    the collision audit's pooled counts equal a host recount of the
    sampled pairs, the shadow reservoir holds no deleted id, and each
    sampled recall equals a numpy recount."""
    import numpy as np
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
    from repro_torch.index import MutableAnnEngine
    from repro_torch.obs.quality import QualityConfig
    from repro_torch.serve import AnnService, AnnServiceConfig
    crp = CodedRandomProjection(SketchConfig(k=64), 48)
    eng = MutableAnnEngine(crp, band_spec=None, tail_rows=256)
    svc = AnnService(eng, AnnServiceConfig(buckets=(8, 32)),
                     quality=QualityConfig(sample_rate=1.0, grid_size=64,
                                           reservoir_rows=128))
    x = torch.randn((1000, 48), generator=gen, device="cuda")
    x = x / x.norm(dim=1, keepdim=True)
    ids = svc.bulk_load(x[:600])
    svc.add(x[600:900])
    svc.upsert(ids[:10], x[900:910])
    kill = np.r_[svc.quality.reservoir.ids()[:30], ids[100:200]]
    svc.delete(np.unique(kill), strict=False)
    assert not set(np.unique(kill).tolist()) & \
        set(svc.quality.reservoir.ids().tolist())
    qm = svc.quality
    pairs = []
    orig = qm.collision.observe_pairs

    def spy(a, b):
        pairs.append((a.cpu().numpy(), np.asarray(torch.as_tensor(b).cpu())))
        return orig(a, b)
    qm.collision.observe_pairs = spy
    recalls = []
    orig_q = qm.recall.observe_query

    def spy_q(q_raw, encode_fn, estimator, q_codes=None):
        r = orig_q(q_raw, encode_fn, estimator, q_codes=q_codes)
        rows, codes = qm.reservoir.rows(), qm.recall._codes
        qv = torch.as_tensor(q_raw).cpu().numpy()
        cos = rows @ (qv / np.linalg.norm(qv)) / np.linalg.norm(rows, axis=1)
        frac = (codes == q_codes.cpu().numpy()[None, :]).mean(axis=1)
        gt = np.argsort(-cos, kind="stable")[:10]
        got = np.argsort(-frac, kind="stable")[:10]
        assert r == len(set(gt.tolist()) & set(got.tolist())) / 10
        recalls.append(r)
        return r
    qm.recall.observe_query = spy_q
    for lo in range(0, 40, 10):
        for i in range(lo, lo + 10):
            svc.submit(x[i] + 0.05 * torch.randn(48, generator=gen,
                                                 device="cuda"))
        svc.flush()
    n = qm.collision.n_codes
    want = np.zeros(n * n, np.int64)
    for a, b in pairs:
        want += np.bincount((a * n + b).ravel(), minlength=n * n)
    assert pairs and np.array_equal(qm.collision.counts, want)
    assert recalls and len(recalls) == qm.recall.queries
