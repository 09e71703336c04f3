"""Port parity: packing, packed counts, packed top-k and band hashes.

The same numpy inputs go through ``repro`` (JAX, ``impl="ref"`` as it
runs off-TPU) and ``repro_torch`` on the CPU; every result here is an
integer and must be bit-exact. One tiny interpret-mode case per Pallas
kernel ties the port's plain versions to the TPU kernels themselves.
The small JAX references run under ``jax.jit`` (one compile per shape is
cheaper than op-by-op dispatch); the top-k reference runs eagerly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.ann import bands as jbands
from repro.core import packing as jpk
from repro.kernels import ref as jref
from repro.kernels.pack_codes import pack_codes_pallas
from repro.kernels.packed_collision import (packed_collision_counts_pallas,
                                           packed_topk_pallas)
from repro_torch.ann import bands as tbands
from repro_torch.core import packing as tpk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; torch's intra-op threads would
    compete with them, so this file runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


J_PACK = jax.jit(jpk.pack_codes, static_argnums=1)
J_UNPACK = jax.jit(jpk.unpack_codes, static_argnums=(1, 2))
J_MISMATCH = jax.jit(jpk.mismatch_count_words, static_argnums=1)
J_COUNTS = jax.jit(jref.packed_collision_ref, static_argnums=(2, 3))
J_BANDS = jax.jit(jbands.band_hashes, static_argnums=1)
J_PROBES = jax.jit(jbands.probe_hashes, static_argnums=(1, 2))

BITS = [1, 2, 4, 8, 16]
KS = [64, 100]          # 100 leaves a ragged last word for every bits > 1


def _codes(rng, shape, bits):
    return rng.integers(0, 1 << bits, size=shape, dtype=np.int32)


def _u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32)


def _t(words_u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(words_u32).view(np.int32))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("bits", BITS)
def test_pack_unpack_bit_exact(bits, k):
    codes = _codes(np.random.default_rng(bits * 7 + k), (9, k), bits)
    want = np.asarray(J_PACK(jnp.asarray(codes), bits))
    got = tpk.pack_codes(torch.from_numpy(codes), bits)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(
        tpk.unpack_codes(got, bits, k).numpy(),
        np.asarray(J_UNPACK(jnp.asarray(want), bits, k)))
    assert tpk.packed_width(k, bits) == jpk.packed_width(k, bits)


@pytest.mark.parametrize("bits", BITS)
def test_pack_unpack_zero_rows(bits):
    # the reference raises here (a reshape with -1 over an empty axis);
    # the port packs an empty corpus to [0, W] and back
    w = tpk.packed_width(17, bits)
    words = tpk.pack_codes(torch.zeros((0, 17), dtype=torch.int32), bits)
    assert words.shape == (0, w) and words.dtype == torch.int32
    assert tpk.unpack_codes(words, bits, 17).shape == (0, 17)


@pytest.mark.parametrize("bits", BITS)
def test_mismatch_count_words_bit_exact(bits):
    rng = np.random.default_rng(bits)
    x = rng.integers(0, 2 ** 32, size=(257,), dtype=np.uint64).astype(np.uint32)
    x[:3] = [0, 0xFFFFFFFF, 0x80000001]
    want = np.asarray(J_MISMATCH(jnp.asarray(x), bits))
    got = tpk.mismatch_count_words(tpk.as_u32(_t(x)), bits)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", BITS)
def test_packed_counts_bit_exact(bits, k=100):
    rng = np.random.default_rng(100 + bits + k)
    wq = np.asarray(J_PACK(jnp.asarray(_codes(rng, (5, k), bits)), bits))
    wdb = np.asarray(J_PACK(jnp.asarray(_codes(rng, (40, k), bits)), bits))
    want = np.asarray(J_COUNTS(jnp.asarray(wq),
                                                jnp.asarray(wdb), bits, k))
    got = tref.packed_collision_ref(_t(wq), _t(wdb), bits, k, block_elems=64)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tpk.match_count_packed(_t(wq)[:, None], _t(wdb)[None], bits, k).numpy(),
        want)


@pytest.mark.parametrize("bits,top_k", [(b, 45) for b in BITS]   # 45 > N
                         + [(2, 1), (2, 10)])
def test_packed_topk_ref_bit_exact(bits, top_k):
    """Values AND tie-broken ids; duplicated rows force ties."""
    rng = np.random.default_rng(bits * 31 + top_k)
    k = 100
    wq = np.asarray(J_PACK(jnp.asarray(_codes(rng, (6, k), bits)), bits))
    wdb = np.array(J_PACK(jnp.asarray(_codes(rng, (37, k), bits)), bits))
    wdb[[5, 20, 30]] = wq[0]
    wdb[[3, 4]] = wdb[9]
    want = [np.asarray(a) for a in jref.packed_topk_ref(
        jnp.asarray(wq), jnp.asarray(wdb), bits, k, top_k)]
    got = tops.packed_topk(_t(wq), _t(wdb), bits, k, top_k)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("top_k", [3, 130])      # 130 takes lax.top_k there
def test_topk_stable_ref_ties_and_negatives(top_k):
    rng = np.random.default_rng(top_k)
    m = rng.integers(-3, 4, size=(7, 120), dtype=np.int32)
    want = [np.asarray(a) for a in jref.topk_stable_ref(jnp.asarray(m), top_k)]
    got = tref.topk_stable_ref(torch.from_numpy(m), top_k)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("k", [256, 100, 33])     # 100, 33: padding fields
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_onehot_counts_identity_matches_jax(bits, k):
    """The tensor-core sweep's arithmetic: k - F + onehot(q) . onehot(db)
    equals the reference's collision counts, with every field slot of the
    words random (padding fields nonzero) and rows tied."""
    rng = np.random.default_rng(bits * 1000 + k)
    w = tpk.packed_width(k, bits)
    wq = rng.integers(0, 2 ** 32, size=(6, w), dtype=np.uint64).astype(np.uint32)
    wdb = rng.integers(0, 2 ** 32, size=(50, w),
                       dtype=np.uint64).astype(np.uint32)
    wdb[[4, 17, 33]] = wq[0]                 # exact hits, tied
    wdb[[8, 9]] = wdb[40]                    # tied rows
    wdb[11] = wq[1] ^ 0xFFFFFFFF             # every field differs
    want = np.asarray(J_COUNTS(jnp.asarray(wq), jnp.asarray(wdb), bits, k))
    got = tref.onehot_counts_ref(_t(wq), _t(wdb), bits, k)
    np.testing.assert_array_equal(got.numpy(), want)
    # row 11 differs from query 1 in every field slot, padding included
    assert want[1, 11] == k - 32 * w // bits


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bits", [1, 2])
def test_partial_lists_merge_to_the_stable_topk(bits, masked):
    """The count sweep's plain partial lists at any S, merged in range
    order by the strictly-beats rule, are the reference's stable top-k:
    what the kernels' partial lists are held to on the card."""
    rng = np.random.default_rng(7 + bits + 2 * masked)
    k, n, top_k = 100, 301, 9
    wq = np.asarray(J_PACK(jnp.asarray(_codes(rng, (5, k), bits)), bits))
    wdb = np.array(J_PACK(jnp.asarray(_codes(rng, (n, k), bits)), bits))
    wdb[[3, 150, 299]] = wq[0]               # ties across ranges
    live = rng.random(n) >= 0.3
    valid = tpk.pack_bitmask(torch.from_numpy(live)) if masked else None
    if masked:
        want = jref.packed_topk_masked_ref(
            jnp.asarray(wq), jnp.asarray(wdb),
            jnp.asarray(valid.numpy().view(np.uint32)), bits, k, top_k)
    else:
        want = jref.packed_topk_ref(jnp.asarray(wq), jnp.asarray(wdb), bits,
                                    k, top_k)
    want = [np.asarray(a) for a in want]
    for s in (1, 2, 3, 7, 64, n):
        pv, pi = tref.packed_topk_partial_ref(_t(wq), _t(wdb), valid, bits, k,
                                              top_k, s)
        assert pv.shape == (s, 5, top_k) == pi.shape
        rows = -(-n // s)
        inside = (pi < 0) | ((pi >= torch.arange(s)[:, None, None] * rows)
                             & (pi < torch.arange(1, s + 1)[:, None, None]
                                * rows))
        assert bool(inside.all()) and bool(((pv < 0) == (pi < 0)).all())
        # the merge: the lists in range order, a stable sort by count
        vals = pv.permute(1, 0, 2).reshape(5, -1)
        ids = pi.permute(1, 0, 2).reshape(5, -1)
        order = torch.sort(vals, dim=1, descending=True, stable=True).indices
        np.testing.assert_array_equal(
            vals.gather(1, order)[:, :top_k].numpy(), want[0])
        np.testing.assert_array_equal(
            ids.gather(1, order)[:, :top_k].numpy(), want[1])


H100_SMS = 132


@pytest.mark.parametrize("nq,w,bits,top_k,kernel,qb,in_smem", [
    (256, 16, 2, 10, "tensor", 128, True),    # the main path: k = 256
    (256, 8, 1, 10, "tensor", 128, True),     # k = 256 at 1 bit
    (64, 16, 2, 10, "tensor", 64, True),      # a serving bucket
    (256, 16, 2, 64, "tensor", 64, True),     # rerank_m 64: lists at QB 64
    (256, 16, 2, 21, "tensor", 128, True),    # the longest lists at QB 128
    (256, 16, 2, 22, "tensor", 64, True),
    (256, 16, 2, 126, "tensor", 64, True),    # the longest at QB 64
    (256, 16, 2, 127, "tensor", 64, False),   # device memory
    (5, 16, 2, 2049, "tensor", 64, False),    # above 2048
    (256, 20, 2, 10, "tensor", 64, True),     # QB 128's lists no longer fit
    (256, 40, 2, 10, "tensor", 64, False),    # the widest one-hot: 160 KB
    (256, 41, 2, 10, "popcount", None, None),
    (256, 32, 4, 10, "popcount", None, None),  # 4, 8, 16 bits: popcount
    (256, 64, 8, 10, "popcount", None, None),
    (256, 128, 16, 10, "popcount", None, None)])
def test_count_sweep_plan(nq, w, bits, top_k, kernel, qb, in_smem):
    """Which count sweep a top-k call launches, by shape alone: the
    tensor-core kernel for 1 and 2 bits where its one-hot queries fit
    shared memory, QB and where its lists live."""
    from repro_torch.kernels import packed_collision as pc
    p = pc.plan(nq, 4_194_304, w, bits, top_k, sms=H100_SMS,
                blocks_per_sm=1)
    assert p["kernel"] == kernel
    if kernel == "popcount":
        assert p["grid"] == (-(-nq // 8), p["n_ranges"])
        assert pc.tc_layout(w, bits, top_k, 64) is None
        return
    assert (p["block_q"], p["lists_in_smem"]) == (qb, in_smem)
    assert p["smem"] <= pc.SMEM_BLOCK_MAX
    assert p["grid"] == (-(-nq // qb), -(-p["n_ranges"] // 2))
    # the one-hot queries: QB * 64 W bytes, in whole 128-byte chunks
    assert p["smem"] >= qb * 64 * w


@pytest.mark.parametrize("nq,qb,s,grid", [
    (256, 128, 132, (2, 66)),     # one whole wave of 132 blocks
    (64, 64, 264, (1, 132)),
    (1024, 128, 66, (8, 33)),     # 264 blocks: two whole waves
    (300, 128, 88, (3, 44))])
def test_count_sweep_default_ranges(nq, qb, s, grid):
    """The tensor-core sweep's default S: two ranges a block, the block
    rows whose grid fills its last wave the most (``whole_waves``)."""
    from repro_torch.kernels import packed_collision as pc
    p = pc.plan(nq, 4_194_304, 16, 2, 10, sms=H100_SMS, blocks_per_sm=1)
    assert (p["block_q"], p["n_ranges"], p["grid"]) == (qb, s, grid)
    # a knob: S as given, clamped to N, two ranges a block
    p = pc.plan(nq, 4_194_304, 16, 2, 10, n_ranges=7, sms=H100_SMS,
                blocks_per_sm=1)
    assert (p["n_ranges"], p["grid"][1]) == (7, 4)
    assert pc.plan(nq, 5, 16, 2, 10, n_ranges=64, sms=H100_SMS,
                   blocks_per_sm=1)["n_ranges"] == 5


@pytest.mark.parametrize("nq,n,w,bits,block_q,kernel,qb,grid,store", [
    (256, 4_194_304, 16, 2, None, "tensor", 128, (2, 66), "tma"),  # LSH
    (256, 4_194_301, 16, 2, None, "tensor", 128, (2, 66), "4-byte"),  # N % 4
    (256, 4_194_304, 8, 1, None, "tensor", 128, (2, 66), "tma"),   # k 256
    (64, 262_144, 16, 2, None, "tensor", 64, (1, 132), "tma"),     # QB 64
    (256, 262_144, 16, 2, 32, "tensor", 64, (4, 33), "tma"),       # a knob
    (37, 3001, 4, 1, 128, "tensor", 128, (1, 24), "4-byte"),  # 47 tiles
    (256, 4_194_304, 20, 2, 128, "tensor", 64, (4, 33), "tma"),   # QB 128 too wide
    (256, 1000, 33, 2, None, "tensor", 64, (4, 8), "tma"),  # the widest one-hot
    (256, 1000, 34, 2, None, "popcount", 32, (8, 8), None),
    (256, 4_194_304, 32, 4, None, "popcount", 32, (32768, 8), None),
    (256, 1000, 64, 8, 64, "popcount", 64, (8, 4), None),
    (256, 1000, 128, 16, None, "popcount", 32, (8, 8), None)])
def test_counts_plan(nq, n, w, bits, block_q, kernel, qb, grid, store):
    """Which all-pairs count kernel a call launches, by shape alone: the
    tensor-core kernel for 1- and 2-bit codes whose one-hot queries fit,
    with its QB, persistent grid and store form; the popcount kernel for
    4, 8 and 16 bits and for wider rows."""
    from repro_torch.kernels import packed_collision as pc
    p = pc.counts_plan(nq, n, w, bits, block_q, sms=H100_SMS,
                       blocks_per_sm=1)
    assert (p["kernel"], p["block_q"], p["grid"], p["store"]) == \
        (kernel, qb, grid, store)
    # plans are cached; each call gets a copy of its own
    p["grid"] = None
    assert pc.counts_plan(nq, n, w, bits, block_q, sms=H100_SMS,
                          blocks_per_sm=1)["grid"] == grid
    if kernel == "tensor":
        assert p["smem"] == pc.counts_layout(w, bits, qb) <= pc.SMEM_BLOCK_MAX
        # the one-hot queries, QB * 64 W bytes, and the staged counts
        assert p["smem"] >= qb * 64 * w + 2 * qb * 64 * 4
    else:
        assert pc.counts_layout(w, bits, 64) is None
    with pytest.raises(ValueError, match="block_q"):
        pc.counts_plan(nq, n, w, bits, 0, sms=H100_SMS, blocks_per_sm=1)


@pytest.mark.parametrize("bits", [1, 2])
def test_onehot_identity_matches_counts_pallas_interpret(bits):
    """k - F + onehot(q) . onehot(row), in plain PyTorch, equals the TPU
    kernel's counts in interpret mode at k = 100 (padded fields): the
    k - F term the tensor-core count kernel adds to its products."""
    rng = np.random.default_rng(20 + bits)
    k = 100
    wq = np.asarray(J_PACK(jnp.asarray(_codes(rng, (5, k), bits)), bits))
    wdb = np.array(J_PACK(jnp.asarray(_codes(rng, (40, k), bits)), bits))
    wdb[[3, 17]] = wq[2]
    want = np.asarray(packed_collision_counts_pallas(
        jnp.asarray(wq), jnp.asarray(wdb), bits, k, block_q=8, block_n=32,
        block_w=4, interpret=True))
    f = wq.shape[1] * (32 // bits)
    hits = tref.onehot_rows(_t(wq), bits, torch.int64) @ \
        tref.onehot_rows(_t(wdb), bits, torch.int64).T
    np.testing.assert_array_equal((k - f + hits).to(torch.int32).numpy(),
                                  want)
    assert want[2, 3] == want[2, 17] == k


def test_pack_codes_pallas_interpret_matches_port():
    codes = _codes(np.random.default_rng(5), (32, 100), 2)
    want = np.asarray(pack_codes_pallas(jnp.asarray(codes), 2, block_m=32,
                                        interpret=True))
    np.testing.assert_array_equal(
        _u32(tops.pack_codes(torch.from_numpy(codes), 2)), want)


@pytest.mark.parametrize("bits", [1, 2, 16])
def test_pack_codes_pallas_interpret_sums_full_range_codes(bits):
    """On int32 codes over the whole range the TPU kernel's word is the
    uint32 sum of code << (i*b), not an or; the port's plain version, and
    the lane adds of its CUDA kernel, keep that sum."""
    codes = np.random.default_rng(40 + bits).integers(
        -2 ** 31, 2 ** 31, size=(8, 37), dtype=np.int32)
    want = np.asarray(pack_codes_pallas(jnp.asarray(codes), bits, block_m=8,
                                        interpret=True))
    np.testing.assert_array_equal(
        _u32(tops.pack_codes(torch.from_numpy(codes), bits)), want)


@pytest.mark.parametrize("m,k,bits,aligned,threads,form,slots,lanes,t,grid", [
    # the query chunk: 16,384 lanes over at least 132 blocks, not 64
    (256, 256, 2, True, 256, "16-byte", 64, 4, 96, 171),
    # a mutable add batch and the dense corpus: the resident blocks
    (65_536, 256, 2, True, 256, "16-byte", 64, 4, 256, 1056),
    (4_194_304, 256, 2, True, 256, "16-byte", 64, 4, 256, 1056),
    (4_194_304, 256, 2, True, 1024, "16-byte", 64, 4, 1024, 264),
    # an unaligned base, or K % 4 != 0: a code a lane
    (256, 256, 2, False, 256, "4-byte", 256, 16, 256, 256),
    (5, 7, 4, True, 256, "4-byte", 8, 8, 32, 2),
    (3, 100, 1, False, 128, "4-byte", 128, 32, 32, 12),
    # ragged last words: a row's slots padded to whole words
    (9, 100, 2, True, 256, "16-byte", 28, 4, 32, 8),
    (3, 100, 1, True, 256, "16-byte", 32, 8, 32, 3),
    (3, 256, 8, True, 256, "16-byte", 64, 1, 32, 6),
    (3, 256, 16, True, 256, "16-byte", 64, 1, 32, 6)])  # two words a lane
def test_pack_plan(m, k, bits, aligned, threads, form, slots, lanes, t, grid):
    """The packing kernel's form, slots and grid, by shape alone."""
    from repro_torch.kernels.pack_codes import pack_plan
    p = pack_plan(m, k, bits, H100_SMS, aligned, threads)
    assert (p["form"], p["slots"], p["lanes_per_word"], p["threads"],
            p["grid"]) == (form, slots, lanes, t, grid)
    assert p["words"] == tpk.packed_width(k, bits)
    assert p["words_per_lane"] == (2 if form == "16-byte" and bits == 16
                                   else 1)
    assert p["threads"] % 32 == 0 and 32 % p["lanes_per_word"] == 0
    assert p["grid"] <= p["resident"] == \
        H100_SMS * min(32, 2048 // p["threads"])
    if m * slots >= H100_SMS * 32:   # enough slots to fill the card
        assert p["grid"] >= H100_SMS
    p["grid"] = None                 # a cached plan hands out copies
    assert pack_plan(m, k, bits, H100_SMS, aligned, threads)["grid"] == grid
    with pytest.raises(ValueError, match="threads"):
        pack_plan(m, k, bits, H100_SMS, aligned, 96)


PACK_UNROLL = 4   # csrc/pack_codes.cu's UNROLL: strides a lane's step


def _pack_lane_model(codes: np.ndarray, bits: int, p: dict) -> np.ndarray:
    """csrc/pack_codes.cu's walk in numpy: each lane of the planned grid
    takes its slots as the kernel does (a step of UNROLL strides while its
    warp's first slot is in range; a dense plan's slot s over the whole
    array, else (row, slot) advanced by the plan's row_step and
    slot_step), adds its codes' shifted values into its partial word, and
    the lanes of a word add theirs into the word; every slot is taken
    once."""
    m, k = codes.shape
    cpw, vec, slots = 32 // bits, p["vec"], p["slots"]
    lanes = p["lanes_per_word"]
    assert vec == 1 or k % 4 == 0
    assert slots % lanes == 0 and 32 % lanes == 0
    stride = p["grid"] * p["threads"]
    drow, dj = p["row_step"], p["slot_step"]
    assert drow * slots + dj == stride
    flat = (codes.astype(np.int64) & 0xFFFFFFFF).ravel().tolist()
    out = [0] * (m * p["words"])
    taken = [0] * (m * slots)
    for s0 in range(stride):
        row, j = divmod(s0, slots)
        base = s0 - s0 % 32
        while base < m * slots:
            for u in range(PACK_UNROLL):
                if p["dense"]:
                    s = base + s0 % 32 + u * stride
                    row, j = divmod(s, slots)   # the same slot, flat
                    first, word = s * vec, s * vec // cpw
                else:
                    first = row * k + j * vec
                    word = row * p["words"] + j * vec // cpw
                if row < m:
                    taken[row * slots + j] += 1
                    for i in range(max(0, min(vec, k - j * vec))):
                        shift = ((j % lanes) * vec + i) % cpw * bits
                        out[word + i // cpw] += flat[first + i] << shift
                if not p["dense"]:
                    j, row = j + dj, row + drow
                    if j >= slots:
                        j, row = j - slots, row + 1
            base += PACK_UNROLL * stride
    assert taken == [1] * (m * slots)
    return (np.array(out, dtype=object).reshape(m, p["words"])
            & 0xFFFFFFFF).astype(np.uint32)


@pytest.mark.parametrize("bits", BITS)
def test_pack_kernel_walk_model(bits):
    """The kernel's slots, lanes and grid-stride walk (modelled in numpy)
    give the plain version's words on full-range codes, in both forms, at the
    planned grid and at grids that walk many strides across rows."""
    from repro_torch.kernels.pack_codes import pack_plan
    rng = np.random.default_rng(60 + bits)
    for m, k, aligned in ((9, 100, True), (7, 257, False), (5, 7, True),
                          (4, 64, True), (6, 64, False), (0, 64, True)):
        codes = rng.integers(-2 ** 31, 2 ** 31, size=(m, k), dtype=np.int32)
        want = _u32(tpk.pack_codes(torch.from_numpy(codes), bits))
        p = pack_plan(m, k, bits, H100_SMS, aligned)
        assert p["dense"] == (k % (32 // bits) == 0 or
                              (p["vec"] == 4 and bits == 16))
        for grid, threads in ((p["grid"], p["threads"]), (1, 32), (3, 64)):
            steps = divmod(grid * threads, p["slots"])
            q = dict(p, grid=grid, threads=threads, row_step=steps[0],
                     slot_step=steps[1])
            np.testing.assert_array_equal(_pack_lane_model(codes, bits, q),
                                          want)


def test_packed_topk_pallas_interpret_matches_port():
    rng = np.random.default_rng(6)
    wq = np.asarray(J_PACK(jnp.asarray(_codes(rng, (8, 64), 2)), 2))
    wdb = np.array(J_PACK(jnp.asarray(_codes(rng, (50, 64), 2)), 2))
    wdb[[7, 33]] = wq[1]
    vals, ids = packed_topk_pallas(jnp.asarray(wq), jnp.asarray(wdb), 2, 64, 5,
                                   block_q=8, block_n=32, interpret=True)
    got = tops.packed_topk(_t(wq), _t(wdb), 2, 64, 5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(vals))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ids))


@pytest.mark.parametrize("n_tables,band_width", [(8, 8), (16, 4), (3, 5)])
def test_band_hashes_bit_exact(n_tables, band_width):
    spec_j = jbands.BandSpec(n_tables, band_width)
    spec_t = tbands.BandSpec(n_tables, band_width)
    codes = _codes(np.random.default_rng(n_tables), (11, 64), 4)
    want = np.asarray(J_BANDS(jnp.asarray(codes), spec_j))
    got = tbands.band_hashes(torch.from_numpy(codes), spec_t)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n_probes", [0, 1, 4])
def test_probe_hashes_bit_exact(n_probes):
    codes = _codes(np.random.default_rng(n_probes), (5, 2, 40), 2)
    codes[0, 0, :8] = 0      # probes bump code 0 to -1 (uint32 wrap)
    want = np.asarray(J_PROBES(jnp.asarray(codes),
                                          jbands.BandSpec(4, 8), n_probes))
    got = tbands.probe_hashes(torch.from_numpy(codes), tbands.BandSpec(4, 8),
                              n_probes)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_band_spec_validate_raises():
    with pytest.raises(ValueError):
        tbands.BandSpec(9, 8).validate(64)
