"""Port parity: the threefry generator behind the canonical R, bit-exact.

``repro_torch.core.prng`` rebuilds ``jax.random``'s threefry2x32 keys,
bits, uniforms and normals in integer PyTorch; the sketch's R units and
offset vector must equal the JAX reference's bit for bit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.sketch import CodedRandomProjection as JaxCRP
from repro.core.sketch import SketchConfig as JaxCfg
from repro_torch.core import prng
from repro_torch.core.sketch import CodedRandomProjection, SketchConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; torch's intra-op threads would
    compete with them, so this file runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEEDS = [0, 1, 2 ** 31 - 1]


def _bits_equal(a: np.ndarray, b: np.ndarray):
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS + [-5, 2 ** 31, 2 ** 32 + 7])
def test_prng_key(seed):
    assert prng.PRNGKey(seed) == tuple(np.asarray(jax.random.PRNGKey(seed)).tolist())


@pytest.mark.parametrize("data", [0, 1, 4095, 2 ** 32 - 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed, data):
    want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
    assert prng.fold_in(prng.PRNGKey(seed), data) == tuple(want.tolist())


@pytest.mark.parametrize("shape", [(1,), (7,), (33, 5), (2, 3, 4)])
def test_random_bits(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 9)
    want = np.asarray(jax.random.bits(key, shape))
    got = prng.random_bits(prng.fold_in(prng.PRNGKey(3), 9), shape)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("minval,maxval", [(0.0, 1.0), (0.0, 0.75), (-2.0, 3.0)])
def test_uniform(minval, maxval):
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.uniform(key, (999,), minval=minval,
                                         maxval=maxval))
    _bits_equal(prng.uniform(prng.PRNGKey(11), (999,), minval, maxval).numpy(),
                want)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal(seed):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
    want = np.asarray(jax.random.normal(key, (300, 67)))
    got = prng.normal(prng.fold_in(prng.PRNGKey(seed), 2), (300, 67))
    _bits_equal(got.numpy(), want)


def test_erfinv_matches_xla_on_every_mantissa_of_a_slice():
    """The normal draw is a function of 23 mantissa bits; this checks a
    strided slice of all 2^23 (every one agrees, checked offline)."""
    f = (np.arange(0, 1 << 23, 61, dtype=np.uint32) | 0x3F800000).view(
        np.float32) - np.float32(1)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.maximum(lo, f * np.float32(2) + lo).astype(np.float32)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(u)))
    _bits_equal(prng.erfinv_xla(torch.from_numpy(u)).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_block_r_units_full_and_ragged(seed):
    """d = 96 at r_unit = 64: one full unit and a ragged 32-row unit (the
    sign scheme only keeps the reference's estimator table cheap)."""
    cfg = dict(k=48, scheme="sign", seed=seed, r_unit=64)
    jc = JaxCRP(JaxCfg(**cfg), 96)
    tc = CodedRandomProjection(SketchConfig(**cfg), 96, device="cpu")
    assert tc.n_units == jc.n_units == 2
    for u in range(2):
        w = jc.unit_width(u)
        _bits_equal(tc._block_r(u, w).numpy(), np.asarray(jc._block_r(u, w)))
    _bits_equal(tc.stream_encoder().r_matrix().numpy(),
                np.asarray(jc.stream_encoder().r_matrix()))


@pytest.mark.parametrize("seed", SEEDS)
def test_offsets(seed):
    cfg = dict(k=100, scheme="offset", w=0.5, seed=seed)
    jc = JaxCRP(JaxCfg(**cfg), 16)
    tc = CodedRandomProjection(SketchConfig(**cfg), 16, device="cpu")
    _bits_equal(tc._offsets.numpy(), np.asarray(jc._offsets))
    assert tc.offset_key() == tuple(np.asarray(jc.offset_key()).tolist())
