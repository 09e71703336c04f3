"""Port parity: coding schemes, collision probabilities, the estimator,
and the two GEMM kernels' plain versions.

Codes from a given projection are bit-exact. Codes and words from a
projection x @ R may differ only in fields where JAX's z lies within
1e-5 of a bin edge: a CPU ``torch.matmul`` sums in another order than
XLA's dot, and rows are unit-normalised, so z is O(1) and the two sums
agree to about 1e-7. rho_hat is held to atol 1e-4: the port builds the
estimator table in float64 where JAX builds it in float32, and 1e-4 is
far below the estimator's own std at k = 256. The JAX references run
under ``jax.jit``: one compile per shape is cheaper than op-by-op dispatch.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import packing as jpk
from repro.core import schemes as jsch
from repro.core.estimators import CollisionEstimator as JaxEst
from repro.core.estimators import rho_from_sign_collision as jax_rho_sign
from repro.kernels import ref as jref
from repro.kernels.encode_fused import encode_fused_pallas
from repro.kernels.proj_code import coded_project_pallas
from repro_torch.core import packing as tpk
from repro_torch.core import schemes as tsch
from repro_torch.core.estimators import CollisionEstimator as TorchEst
from repro_torch.core.estimators import rho_from_sign_collision as torch_rho_sign
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


J_ENCODE = jax.jit(jsch.encode, static_argnums=1)
J_CODED = jax.jit(jref.coded_project_ref, static_argnums=2)
J_FUSED = jax.jit(jref.encode_fused_ref, static_argnums=2)
J_UNPACK = jax.jit(jpk.unpack_codes, static_argnums=(1, 2))
J_DOT = jax.jit(lambda x, r: jnp.dot(x, r, preferred_element_type=jnp.float32))

SCHEMES = [("sign", 1.0), ("2bit", 0.75), ("uniform", 0.75), ("uniform", 0.3),
           ("offset", 1.0), ("offset", 0.75)]
# the table test takes one width per scheme: uniform at w = 0.3 needs a
# 30-bin quadrature that costs the reference seconds on one core
TABLE_SCHEMES = [s for s in SCHEMES if s not in (("uniform", 0.3),
                                                  ("offset", 0.75))]
EDGE_TOL = 1e-5


def _offsets(rng, k, w):
    return rng.uniform(0, w, size=k).astype(np.float32)


def _edge_distance(z, scheme, w, q):
    if scheme == "sign":
        return np.abs(z)
    if scheme == "2bit":
        return np.min(np.abs(z[None] - np.array([-w, 0.0, w])[:, None, None]), 0)
    v = (z + q if scheme == "offset" else z) / w
    return np.abs(v - np.round(v)) * w


@pytest.mark.parametrize("scheme,w", SCHEMES)
def test_spec_bits(scheme, w):
    j, t = jsch.CodeSpec(scheme, w), tsch.CodeSpec(scheme, w)
    assert (t.n_bins_side, t.n_codes, t.bits) == (j.n_bins_side, j.n_codes, j.bits)


@pytest.mark.parametrize("scheme,w", SCHEMES)
def test_encode_bit_exact_given_z(scheme, w):
    rng = np.random.default_rng(len(scheme))
    z = (rng.standard_normal((40, 64)) * 3).astype(np.float32)
    z[0, :12] = [0.0, -0.0, w, -w, 2 * w, -2 * w, 6.0, -6.0, 100.0, -100.0,
                 np.nextafter(np.float32(w), np.float32(0)), np.float32(1e-30)]
    q = _offsets(rng, 64, w)
    want = np.asarray(J_ENCODE(jnp.asarray(z), jsch.CodeSpec(scheme, w),
                                jnp.asarray(q)))
    got = tsch.encode(torch.from_numpy(z), tsch.CodeSpec(scheme, w),
                      torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)


def test_offset_scheme_needs_offsets():
    with pytest.raises(ValueError):
        tsch.encode(torch.zeros(2, 3), tsch.CodeSpec("offset", 1.0))


@pytest.mark.parametrize("scheme,w", TABLE_SCHEMES)
def test_collision_prob_and_estimator_rho(scheme, w):
    """The tabulated P(rho) on the estimator's 4096-point grid (the
    reference's float32 against the port's float64), and rho_hat."""
    jest, test = JaxEst(scheme, w), TorchEst(scheme, w)
    np.testing.assert_allclose(test._p.numpy(), jest._p_grid, atol=2e-6)
    p = np.concatenate([[0.0, 0.1, 0.999999, 1.0],
                        np.linspace(0.2, 0.99, 37)]).astype(np.float32)
    got = test(torch.from_numpy(p)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jest(jnp.asarray(p))), atol=1e-4)


def test_rho_from_sign_collision():
    p = np.linspace(0.0, 1.0, 11).astype(np.float32)
    np.testing.assert_allclose(torch_rho_sign(torch.from_numpy(p)).numpy(),
                               np.asarray(jax_rho_sign(jnp.asarray(p))),
                               atol=1e-6)


def _gemm_case(scheme, w, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((50, 96)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    r = rng.standard_normal((96, k)).astype(np.float32)
    return x, r, _offsets(rng, k, w)


@pytest.mark.parametrize("k", [64, 100])
@pytest.mark.parametrize("scheme,w", SCHEMES)
def test_coded_project_and_encode_fused_ref(scheme, w, k):
    x, r, q = _gemm_case(scheme, w, k, seed=k + len(scheme))
    jspec, tspec = jsch.CodeSpec(scheme, w), tsch.CodeSpec(scheme, w)
    z = np.asarray(J_DOT(jnp.asarray(x), jnp.asarray(r)))
    want = np.asarray(J_CODED(jnp.asarray(x), jnp.asarray(r), jspec,
                              jnp.asarray(q)))
    tx, tr, tq = map(torch.from_numpy, (x, r, q))
    got = tops.coded_project(tx, tr, tspec, tq).numpy()
    flips = got != want
    assert not np.any(flips & (_edge_distance(z, scheme, w, q) > EDGE_TOL))
    words = tops.encode_fused(tx, tr, tspec, tq)
    want_w = np.asarray(J_FUSED(jnp.asarray(x), jnp.asarray(r), jspec,
                                jnp.asarray(q)))
    assert words.shape == want_w.shape
    got_c = tpk.unpack_codes(words, tspec.bits, k).numpy()
    want_c = np.asarray(J_UNPACK(jnp.asarray(want_w), jspec.bits, k))
    flips = got_c != want_c
    assert not np.any(flips & (_edge_distance(z, scheme, w, q) > EDGE_TOL))
    np.testing.assert_array_equal(got_c, got)


@pytest.mark.parametrize("scheme,w", [("2bit", 0.75), ("offset", 1.0)])
def test_gemm_pallas_interpret_matches_port(scheme, w):
    """The TPU kernels themselves (interpret mode, one grid step) against
    the port's plain versions, under the same bin-edge rule."""
    x, r, q = _gemm_case(scheme, w, 64, seed=3)
    x, r = x[:32, :64], r[:64]
    z = x @ r
    jspec, tspec = jsch.CodeSpec(scheme, w), tsch.CodeSpec(scheme, w)
    near = _edge_distance(z, scheme, w, q) <= EDGE_TOL
    codes = np.asarray(coded_project_pallas(
        jnp.asarray(x), jnp.asarray(r), jspec, jnp.asarray(q), block_m=32,
        block_k=32, block_d=64, interpret=True))
    tx, tr, tq = map(torch.from_numpy, (x, r, q))
    got = tref.coded_project_ref(tx, tr, tspec, tq).numpy()
    assert not np.any((got != codes) & ~near)
    words = np.asarray(encode_fused_pallas(
        jnp.asarray(x), jnp.asarray(r), jspec, jnp.asarray(q), block_m=32,
        block_d=64, interpret=True))
    got_w = tref.encode_fused_ref(tx, tr, tspec, tq)
    flips = tpk.unpack_codes(got_w, tspec.bits, 64).numpy() != \
        np.asarray(jpk.unpack_codes(jnp.asarray(words), jspec.bits, 64))
    assert not np.any(flips & ~near)
