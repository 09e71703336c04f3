"""Port parity for the scoring tables: the contingency-cell model, the
tables built from it, and the per-query tables the scored kernels read.

The port builds its tables in float64 where the JAX package builds them
in float32, so built tables agree to a relative 1e-4. Tables carried
across with ``convert.rank_tables_from_numpy`` give bit-identical query
tables, bf16 and int8 (values and scales) included.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.estimators import cell_probs as jax_cell_probs
from repro.core.estimators import region_bounds as jax_region_bounds
from repro.core.schemes import CodeSpec as JaxSpec
from repro.rank import RankTables as JaxTables
from repro.rank import build_rank_tables as jax_build
from repro_torch import convert
from repro_torch.core.estimators import cell_probs, region_bounds
from repro_torch.core.schemes import CodeSpec
from repro_torch.rank import build_rank_tables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; torch's intra-op threads would
    compete with them, so this file runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the main path's table (2-bit, w = 0.75, k = 256) and the sign scheme's
TABLE_CASES = [("2bit", 0.75, 256), ("sign", 1.0, 64)]


@functools.lru_cache(maxsize=None)
def _tables(scheme, w, k):
    jt = jax_build(JaxSpec(scheme, w), k)
    return jt, build_rank_tables(CodeSpec(scheme, w), k, device="cpu")


def _shared(jt):
    spec = CodeSpec(jt.spec.scheme, jt.spec.w)
    return convert.rank_tables_from_numpy(
        spec, jt.k, np.asarray(jt.pair), np.asarray(jt.rho_grid),
        np.asarray(jt.score_grid), device="cpu")


@pytest.mark.parametrize("scheme,w", [("sign", 1.0), ("2bit", 0.75),
                                      ("uniform", 0.75), ("offset", 1.0)])
def test_region_bounds_match_jax(scheme, w):
    if scheme == "offset":
        for fn, spec in ((jax_region_bounds, JaxSpec), (region_bounds, CodeSpec)):
            with pytest.raises(ValueError, match="offset"):
                fn(spec(scheme, w))
        return
    assert region_bounds(CodeSpec(scheme, w)) == \
        jax_region_bounds(JaxSpec(scheme, w))


@pytest.mark.parametrize("scheme,w", [("sign", 1.0), ("2bit", 0.75)])
def test_cell_probs_match_jax(scheme, w):
    rho = np.array([0.0, 0.3, 0.9, 0.999], np.float32)
    want = np.asarray(jax_cell_probs(jnp.asarray(rho), JaxSpec(scheme, w)))
    got = cell_probs(torch.from_numpy(rho.astype(np.float64)),
                     CodeSpec(scheme, w)).numpy()
    # the reference's float32 quadrature against the port's float64
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got.sum(axis=(-1, -2)), 1.0, atol=1e-9)


@pytest.mark.parametrize("scheme,w,k", TABLE_CASES)
def test_built_tables_match_jax(scheme, w, k):
    jt, tt = _tables(scheme, w, k)
    np.testing.assert_allclose(tt.pair.numpy(), np.asarray(jt.pair),
                               rtol=1e-4)
    g = np.asarray(jt.score_grid)
    # relative to the grid's range: the curve crosses zero
    np.testing.assert_allclose(tt.score_grid.numpy(), g, rtol=0,
                               atol=1e-4 * np.abs(g).max())
    np.testing.assert_array_equal(tt.rho_grid.numpy(),
                                  np.asarray(jt.rho_grid))
    assert bool((tt.score_grid[1:] > tt.score_grid[:-1]).all())
    scores = np.linspace(g[0] - 5, g[-1] + 5, 257).astype(np.float32)
    np.testing.assert_allclose(
        tt.rho_from_scores(torch.from_numpy(scores)).numpy(),
        np.asarray(jt.rho_from_scores(jnp.asarray(scores))), atol=1e-4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("scheme,w,k", TABLE_CASES)
def test_query_tables_on_shared_tables_bit_exact(scheme, w, k, dtype):
    jt, _ = _tables(scheme, w, k)
    codes = np.random.default_rng(k).integers(0, jt.spec.n_codes, (9, k))
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = np.asarray(jt.query_tables(jnp.asarray(codes), dtype=jdt)
                      .astype(jnp.float32))
    tt = _shared(jt).quantize(tdt)
    got = tt.query_tables(torch.from_numpy(codes))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)
    np.testing.assert_array_equal(
        tt.rho_from_scores(torch.tensor([-50.0, 0.0, 40.0])).numpy(),
        np.asarray(jt.rho_from_scores(jnp.asarray([-50.0, 0.0, 40.0]))))


@pytest.mark.parametrize("scheme,w,k", TABLE_CASES)
def test_query_tables_int8_on_shared_tables_bit_exact(scheme, w, k):
    jt, _ = _tables(scheme, w, k)
    codes = np.random.default_rng(k + 1).integers(0, jt.spec.n_codes, (9, k))
    jq, js = jt.query_tables_int8(jnp.asarray(codes))
    tq, ts = _shared(jt).query_tables_int8(torch.from_numpy(codes))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _edge_pair(top):
    """A 2-bit pair table whose row 0 peaks at ``top`` (every word of an
    all-zero query then has max_abs == top) and whose other rows peak
    at 1.0."""
    return np.array([[top, -0.5, 0.25, -top / 3],
                     [0.1, 0.2, -0.3, 0.4],
                     [-0.75, 0.125, 0.5, -0.2],
                     [0.3, -0.6, 0.9, -1.0]], np.float32)


@pytest.mark.parametrize("j", [-3, 0, 4])
@pytest.mark.parametrize("ulps", [-1, 0, 1])
def test_int8_scale_at_powers_of_two(j, ulps):
    """max_abs / 127 at exactly 2**j and 1 ulp either side: the scale
    follows XLA's float32 log2, whatever the exact answer would be."""
    top = np.float32(127.0 * 2.0 ** j)
    if ulps:
        top = np.nextafter(top, np.float32(np.inf * ulps), dtype=np.float32)
    pair = _edge_pair(top)
    spec, k = CodeSpec("2bit", 0.75), 20
    jt = JaxTables(spec=JaxSpec("2bit", 0.75), k=k, pair=jnp.asarray(pair),
                   rho_grid=jnp.linspace(0, 1, 8),
                   score_grid=jnp.linspace(-1, 1, 8))
    tt = convert.rank_tables_from_numpy(spec, k, pair, np.linspace(0, 1, 8),
                                        np.linspace(-1, 1, 8), device="cpu")
    codes = np.zeros((3, k), np.int64)
    codes[1, 5:] = 3
    jq, js = jt.query_tables_int8(jnp.asarray(codes))
    tq, ts = tt.query_tables_int8(torch.from_numpy(codes))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    mant, _ = np.frexp(ts.numpy())
    assert (mant == 0.5).all()              # powers of two


@pytest.mark.parametrize("j", [-20, 13])
def test_int8_scale_where_xla_exp2_is_inexact(j):
    """XLA's float32 exp2 misses 2**j at these exponents, so the
    reference's scale is a few ulps off a power of two; the port keeps
    the power of two its int8 contract needs, and the same entries."""
    top = np.float32(127.0 * 2.0 ** j)
    pair = np.full((4, 4), top / 4, np.float32)
    pair[0, 0] = top
    spec, k = CodeSpec("2bit", 0.75), 16
    jt = JaxTables(spec=JaxSpec("2bit", 0.75), k=k, pair=jnp.asarray(pair),
                   rho_grid=jnp.linspace(0, 1, 8),
                   score_grid=jnp.linspace(-1, 1, 8))
    tt = convert.rank_tables_from_numpy(spec, k, pair, np.linspace(0, 1, 8),
                                        np.linspace(-1, 1, 8), device="cpu")
    codes = np.zeros((1, k), np.int64)
    jq, js = jt.query_tables_int8(jnp.asarray(codes))
    tq, ts = tt.query_tables_int8(torch.from_numpy(codes))
    assert (ts.numpy() == np.float32(2.0 ** j)).all()
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), rtol=1e-6)
