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
from repro.kernels.packed_collision import packed_topk_pallas
from repro_torch.ann import bands as tbands
from repro_torch.core import packing as tpk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

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


def test_pack_codes_pallas_interpret_matches_port():
    codes = _codes(np.random.default_rng(5), (32, 100), 2)
    want = np.asarray(pack_codes_pallas(jnp.asarray(codes), 2, block_m=32,
                                        interpret=True))
    np.testing.assert_array_equal(
        _u32(tops.pack_codes(torch.from_numpy(codes), 2)), want)


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
