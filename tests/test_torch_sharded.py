"""Port parity for the sharded paths and the gradient compressor.

``AnnEngine.search_sharded``, ``CodeStore.shard``, ``encode_sharded``,
``packed_grads_sharded``, ``fit_words``/``fit_store(mesh=)`` and
``GradCompressor`` against the JAX reference on the same numpy inputs.

* World size 1, in this process: a gloo group on a ``FileStore`` and a
  CPU ``("data",)`` mesh (a module fixture) against the reference on a
  1-device ``Mesh``.
* World size 2: two gloo ranks of the port in child processes against
  one child running the reference on 2 forced host devices (as
  ``tests/test_distributed.py`` does), each writing an ``.npz``.

Tolerances: ids bit-identical everywhere; rho_hat within rtol 1e-6;
encoded words equal but at fields whose float64 projection lies within
1e-5 of a bin edge; sharded gradients within rtol 1e-5, atol 1e-6 (the
reference's own tolerance for a sum in another order); trained models
within rtol 1e-4, atol 1e-5 with equal predictions. The compressor: R
from the port's own QR within 1e-5 of the reference's (float32 QR of a
Gaussian [chunk, chunk]: LAPACK builds differ in rounding); with R
carried across, codes equal but at fields within 1e-5 of a bin edge,
scales within rtol 1e-6, and decoded and synced gradients and the EF
state within rtol 1e-5 and 1e-5 of the largest magnitude (float32
products of length k and chunk summed in another order).
"""
import functools
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from repro import learn as jl
from repro.learn.linear import targets_pm as jax_targets_pm
from repro.ann import AnnEngine as JaxEngine
from repro.ann import BandSpec as JaxBands
from repro.ann import CodeStore as JaxStore
from repro.core import packing as jax_packing
from repro.core.gradient_compression import (
    GradCompressionConfig as JaxGcCfg, GradCompressor as JaxGc,
    code_centroids as jax_centroids)
from repro.core.schemes import CodeSpec as JaxSpec
from repro.core.sketch import CodedRandomProjection as JaxCRP
from repro.core.sketch import SketchConfig as JaxCfg
from repro.encode import StreamingEncoder as JaxEncoder
from repro.encode import encode_sharded as jax_encode_sharded
from repro.rank import RankTables as JaxTables
from repro_torch import convert
from repro_torch import learn as tl
from repro_torch.ann import AnnEngine, BandSpec, CodeStore
from repro_torch.core import packing, prng, schemes
from repro_torch.core.gradient_compression import (GradCompressionConfig,
                                                   GradCompressor,
                                                   code_centroids)
from repro_torch.core.schemes import CodeSpec
from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
from repro_torch.encode import encode_sharded
from repro_torch.launch import dp_axes, make_dp_mesh, make_mesh_compat
from repro_torch.parallel import all_gather_stack, all_reduce_sum
from repro_torch.rank import build_rank_tables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, N, NQ, K = 96, 600, 33, 40
SKETCH = dict(k=K, scheme="2bit", w=0.75, seed=7)
EDGE_TOL = 1e-5
TABLES_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
# rerank_m = 100 keeps the reference's coarse top-m on lax.top_k (its
# blocked picking below 65 traces slowly), as tests/test_torch_scored.py
MODES = {
    "count": dict(),
    "two-stage": dict(scored=True, fused=False, rerank_m=100),
    "fused-f32": dict(scored=True, table_dtype="f32", rerank_m=100),
    "fused-int8": dict(scored=True, table_dtype="int8", rerank_m=100),
}
GC_CFG = dict(rate=4, chunk=256)
GC_LEAVES = ("w", "b0", "b1")
CHILD_TIMEOUT_S = 180


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; torch's intra-op threads would
    compete with them, so this file runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A world-size-1 gloo group on a FileStore and its CPU mesh."""
    path = str(tmp_path_factory.mktemp("gloo") / "store")
    dist.init_process_group("gloo", store=dist.FileStore(path, 1), rank=0,
                            world_size=1)
    try:
        yield make_dp_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("data",))


def _rows(rng, n):
    x = rng.standard_normal((n, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _i32(a):
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _edge_distance(z, spec, q=None):
    if spec.scheme == "sign":
        return np.abs(z)
    if spec.scheme == "2bit":
        return np.min(np.abs(z[None] - np.array([-spec.w, 0.0, spec.w])
                             [:, None, None]), axis=0)
    v = (z + q if spec.scheme == "offset" else z) / spec.w
    return np.abs(v - np.round(v)) * spec.w


def _codes_agree(got, want, z, spec, q=None):
    """int codes equal but where z lies within EDGE_TOL of a bin edge."""
    diff = np.asarray(got) != np.asarray(want)
    far = diff & (_edge_distance(np.asarray(z, np.float64), spec, q)
                  > EDGE_TOL)
    assert not far.any(), f"{int(far.sum())} fields differ away from an edge"


@pytest.fixture(scope="module")
def inputs():
    """Every input, made by the port from numpy seeds: corpus words
    (``sketch``), rank tables (``build_rank_tables``), R, queries (20
    planted), encode rows, the gradient problem and, from the reference,
    the compressor's R."""
    rng = np.random.default_rng(2014)
    corpus = _rows(rng, N)
    queries = np.concatenate([corpus[:20] + 0.02 * rng.standard_normal(
        (20, D)).astype(np.float32), _rows(rng, NQ - 20)])
    tc = CodedRandomProjection(SketchConfig(**SKETCH), D, device="cpu")
    tt = build_rank_tables(tc)
    gw, gy, gtables = _grad_inputs()
    g = [_flat_gc(_gc_tree(50 + r)) for r in range(2)]
    ef = [_flat_gc(_gc_tree(60 + r, 0.1)) for r in range(2)]
    return dict(
        k=K, d=D, corpus=corpus, queries=queries, x=_rows(rng, 64),
        words=tc.sketch(torch.from_numpy(corpus)).numpy().view(np.uint32),
        r=tc.stream_encoder().r_matrix().numpy(),
        pair=tt.pair.numpy(), rho_grid=tt.rho_grid.numpy(),
        score_grid=tt.score_grid.numpy(), gwords=gw, gy=gy, tables=gtables,
        gc_r=_jax_gc(**GC_CFG)._r_np,
        **{f"g_{n}": np.stack([t[n] for t in g]) for n in GC_LEAVES},
        **{f"ef_{n}": np.stack([t[n] for t in ef]) for n in GC_LEAVES})


@pytest.fixture(scope="module")
def engines(inputs):
    """The two packages' engines over the same words, R and tables."""
    z = inputs
    jc = JaxCRP(JaxCfg(**SKETCH), D)
    jt = JaxTables(spec=jc.spec, k=K, pair=jnp.asarray(z["pair"]),
                   rho_grid=jnp.asarray(z["rho_grid"]),
                   score_grid=jnp.asarray(z["score_grid"]))
    jeng = JaxEngine(jc, JaxStore.from_words(z["words"], K, 2),
                     JaxBands(4, 4), rank_tables=jt)
    tc = convert.sketch_from_numpy(SketchConfig(**SKETCH), D, z["r"],
                                   device="cpu")
    tt = convert.rank_tables_from_numpy(tc.spec, K, z["pair"],
                                        z["rho_grid"], z["score_grid"],
                                        device="cpu")
    teng = AnnEngine(tc, convert.store_from_numpy(z["words"], K, 2,
                                                  device="cpu"),
                     BandSpec(4, 4), rank_tables=tt)
    return jeng, teng


# -- world size 1 ---------------------------------------------------------------

def test_mesh_helpers(mesh):
    assert mesh.mesh_dim_names == ("data",) and mesh.device_type == "cpu"
    assert dp_axes(mesh) == ("data",)
    assert make_mesh_compat((1,), ("pod",), "cpu").mesh_dim_names == ("pod",)
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(all_gather_stack(x, mesh, "data"), x[None])
    assert torch.equal(all_reduce_sum(x, mesh, "data"), x)


@pytest.mark.parametrize("mode", list(MODES))
def test_search_sharded_matches_jax(mesh, jax_mesh, engines, inputs, mode):
    jeng, teng = engines
    queries = inputs["queries"]
    np.testing.assert_array_equal(
        teng.encode_queries(queries).numpy(),
        np.asarray(jeng.encode_queries(jnp.asarray(queries))))
    ji, jr = jeng.search_sharded(jnp.asarray(queries), jax_mesh, top_k=10,
                                 **MODES[mode])
    ti, tr = teng.search_sharded(queries, mesh, top_k=10, **MODES[mode])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6)
    # at world size 1 the sharded search is the unsharded one, bit for bit
    ui, ur = teng.search(queries, top_k=10, mode="exact", **MODES[mode])
    assert torch.equal(ti, ui) and torch.equal(tr, ur)
    if mode in ("count", "fused-f32"):
        assert (ti.numpy()[:20, 0] == np.arange(20)).all()   # planted


def test_store_shard_and_row_sharding(mesh):
    from torch.distributed.tensor import Shard
    store = CodeStore(words=torch.arange(14, dtype=torch.int32).reshape(7, 2),
                      k=32, bits=2)
    assert store.row_sharding(mesh) == [Shard(0)]
    local = store.shard(mesh)
    assert local.n == 7 and torch.equal(local.words, store.words)


def test_sharded_paths_refuse_a_mismatch(mesh, engines, inputs):
    teng = engines[1]
    meta = CodeStore(words=torch.zeros((4, 2), dtype=torch.int32,
                                       device="meta"), k=32, bits=2)
    with pytest.raises(ValueError, match="mesh is on 'cpu'"):
        meta.shard(mesh)
    with pytest.raises(ValueError, match="no dim"):
        teng.store.shard(mesh, axis="model")
    with pytest.raises(ValueError, match="int8"):
        teng.search_sharded(inputs["queries"], mesh, scored=True,
                            fused=False, table_dtype="int8")
    with pytest.raises(ValueError, match="mesh is on 'cpu'"):
        tl.packed_grads_sharded(
            (torch.zeros(1, 4), torch.zeros(1)),
            torch.zeros((4, 2), dtype=torch.int32, device="meta"),
            torch.ones(1, 4), tl.PackedFeatureSpec(32, 2, 4), mesh)


def test_encode_sharded_matches_jax(mesh, jax_mesh, engines, inputs):
    x = inputs["x"]
    jeng, teng = engines
    want = np.asarray(jax_encode_sharded(JaxEncoder(jeng.sketcher),
                                         jnp.asarray(x), jax_mesh))
    got = encode_sharded(teng.sketcher.stream_encoder(), x, mesh)
    assert got.dtype == torch.int32 and got.shape == want.shape
    z = x.astype(np.float64) @ inputs["r"].astype(np.float64)
    _codes_agree(packing.unpack_codes(got, 2, K).numpy(),
                 np.asarray(jax_packing.unpack_codes(jnp.asarray(want), 2,
                                                     K)),
                 z, teng.sketcher.spec)
    # the port's sharded words are its own project + code_pack, bit for bit
    assert torch.equal(got, teng.sketcher.sketch_oracle(x))


def _learn_problem(seed, k, n):
    """Planted binary rows (as tests/test_torch_learn.py's _problem) ->
    (codes, uint32 words, labels ±1)."""
    rng = np.random.default_rng(seed)
    y = np.where(rng.random(n) < 0.5, 1, -1)
    mu = rng.standard_normal(k) * 0.4
    z = rng.standard_normal((n, k)) + y[:, None] * mu
    codes = schemes.encode(torch.from_numpy(z.astype(np.float32)),
                           CodeSpec("2bit", 0.75))
    return (codes.numpy(),
            packing.pack_codes(codes, 2).numpy().view(np.uint32), y)


def _grad_inputs(n=257, k=32):
    """n = 257: not a multiple of 32 * world."""
    _, w, y = _learn_problem(23, k, n)
    fspec = tl.feature_spec_for(CodeSpec("2bit", 0.75), k)
    rng = np.random.default_rng(29)
    tables = (rng.standard_normal((1, fspec.table_width)).astype(np.float32)
              * fspec.entry_mask("cpu").numpy())
    return w, y, tables


def test_packed_grads_sharded_matches_jax(mesh, jax_mesh):
    w, y, tables = _grad_inputs()
    jf = jl.feature_spec_for(JaxSpec("2bit", 0.75), 32)
    tf = tl.feature_spec_for(CodeSpec("2bit", 0.75), 32)
    # jitted: the reference's shard_map run eagerly compiles op by op
    jl_, (jdt, jdb) = jax.jit(lambda p, w_, y_: jl.packed_grads_sharded(
        p, w_, y_, jf, jax_mesh))((jnp.asarray(tables), jnp.zeros((1,))),
                                  jnp.asarray(w),
                                  jax_targets_pm(jnp.asarray(y), 1))
    params = (torch.from_numpy(tables), torch.zeros(1))
    y_pm = tl.linear.targets_pm(y, 1, "cpu")
    tl_, (tdt, tdb) = tl.packed_grads_sharded(params, _i32(w), y_pm, tf, mesh)
    np.testing.assert_allclose(float(tl_), float(jl_), rtol=1e-6)
    np.testing.assert_allclose(tdt.numpy(), np.asarray(jdt), **GRAD_TOL)
    np.testing.assert_allclose(tdb.numpy(), np.asarray(jdb), **GRAD_TOL)
    ul, (udt, udb) = tl.linear.packed_loss_and_grads(params, _i32(w), y_pm,
                                                     tf)
    np.testing.assert_allclose(tdt.numpy(), udt.numpy(), **GRAD_TOL)
    np.testing.assert_allclose(tdb.numpy(), udb.numpy(), **GRAD_TOL)


FIT_K, FIT_N, FIT_TEST = 32, 600, 100


@functools.lru_cache(maxsize=None)
def _fit_problem():
    return _learn_problem(11, FIT_K, FIT_N + FIT_TEST)


@functools.lru_cache(maxsize=None)
def _jax_fit(batch):
    """The reference's ``fit_store`` (its ``fit_words`` over the store's
    words) on a 1-device mesh, shared by both entry points' cases."""
    _, w, y = _fit_problem()
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    return jl.fit_store(JaxStore.from_words(jnp.asarray(w[:FIT_N]), FIT_K,
                                            2),
                        jnp.asarray(y[:FIT_N]), JaxSpec("2bit", 0.75),
                        jl.LearnConfig(steps=10, batch=batch, seed=3),
                        mesh=mesh)


@pytest.mark.parametrize("batch", [0, 128], ids=["full_batch", "minibatch"])
@pytest.mark.parametrize("entry", ["fit_words", "fit_store"])
def test_fit_with_mesh_matches_jax(mesh, entry, batch):
    _, w, y = _fit_problem()
    n, cfg, spec = FIT_N, tl.LearnConfig(steps=10, batch=batch, seed=3), \
        CodeSpec("2bit", 0.75)
    if entry == "fit_store":
        tm = tl.fit_store(CodeStore(words=_i32(w[:n]), k=FIT_K, bits=2),
                          y[:n], spec, cfg, mesh=mesh)
    else:
        tm = tl.fit_words(_i32(w[:n]), y[:n], spec, cfg, k=FIT_K, mesh=mesh)
    jm = _jax_fit(batch)
    np.testing.assert_allclose(tm.tables.numpy(), np.asarray(jm.tables),
                               **TABLES_TOL)
    np.testing.assert_allclose(tm.bias.numpy(), np.asarray(jm.bias),
                               **TABLES_TOL)
    np.testing.assert_array_equal(tm.predict(_i32(w[n:])).numpy(),
                                  np.asarray(jm.predict(jnp.asarray(w[n:]))))
    # the mesh changes the gradient's sum order only
    plain = tl.fit_words(_i32(w[:n]), y[:n], spec, cfg, k=FIT_K)
    np.testing.assert_allclose(tm.tables.numpy(), plain.tables.numpy(),
                               **TABLES_TOL)


# -- the compressor, world size 1 ----------------------------------------------

GC_SPECS = [("sign", 1.0), ("2bit", 0.75), ("uniform", 1.0),
            ("offset", 1.0), ("uniform", 0.3)]


@pytest.mark.parametrize("scheme,w", GC_SPECS)
def test_code_centroids_match_jax(scheme, w):
    np.testing.assert_array_equal(code_centroids(CodeSpec(scheme, w)),
                                  jax_centroids(JaxSpec(scheme, w)))


@pytest.mark.parametrize("seed,step,n", [(17, 0, 1024), (17, 5, 1024),
                                         (3, 2**32 - 1, 777), (0, 9, 1)])
def test_rademacher_and_bernoulli_bit_exact(seed, step, n):
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), 0),
                            jnp.asarray(step, jnp.uint32))
    tk = prng.fold_in(prng.fold_in(prng.PRNGKey(seed), 0), step)
    want = np.asarray(jax.random.rademacher(jk, (n,), jnp.float32))
    got = prng.rademacher(tk, (n,)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(prng.bernoulli(tk, 0.3, (n,)).numpy(),
                                  np.asarray(jax.random.bernoulli(jk, 0.3,
                                                                  (n,))))


def _gc_template(lib):
    z = jnp.zeros if lib == "jax" else torch.zeros
    return {"w": z((300, 7)), "b": [z((13,)), (z((2, 2)),)]}


def _gc_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((300, 7)) * scale).astype(np.float32),
            "b": [(rng.standard_normal(13) * scale).astype(np.float32),
                  ((rng.standard_normal((2, 2)) * scale).astype(np.float32),)]}


def _to(tree, lib):
    leaf = jnp.asarray if lib == "jax" else torch.from_numpy
    if isinstance(tree, dict):
        return {k: _to(v, lib) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, lib) for v in tree)
    return leaf(tree)


def _flat_gc(tree):
    return {"w": tree["w"], "b0": tree["b"][0], "b1": tree["b"][1][0]}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def _close_trees(got, want):
    g, w = _leaves(got), _leaves(want)
    assert [a.shape for a in g] == [b.shape for b in w]
    top = max(float(np.abs(b).max()) for b in w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * top)


@functools.lru_cache(maxsize=None)
def _jax_gc(**cfg):
    """The reference's compressor (its R from an eager QR) per config."""
    return JaxGc(JaxGcCfg(**cfg), _gc_template("jax"))


@pytest.mark.parametrize("chunk,rate", [(256, 4), (1024, 8)])
def test_own_r_matches_jax(chunk, rate):
    jc = _jax_gc(rate=rate, chunk=chunk)
    tc = GradCompressor(GradCompressionConfig(rate=rate, chunk=chunk),
                        _gc_template("torch"), device="cpu")
    assert tc._r.shape == (chunk, chunk // rate)
    np.testing.assert_allclose(tc._r.numpy(), jc._r_np, rtol=0, atol=1e-5)
    assert (tc.wire_bytes(), tc.fp32_bytes()) == (jc.wire_bytes(),
                                                  jc.fp32_bytes())


def _compressor_pair(scheme, w):
    cfg = dict(scheme=scheme, w=w, **GC_CFG)
    jc = _jax_gc(**cfg)
    tc = convert.grad_compressor_from_numpy(
        GradCompressionConfig(**cfg), _gc_template("torch"), jc._r_np,
        None if jc._offsets is None else np.asarray(jc._offsets),
        device="cpu")
    return jc, tc


@pytest.mark.parametrize("scheme,w", GC_SPECS[:4])
def test_compressor_matches_jax(scheme, w):
    jc, tc = _compressor_pair(scheme, w)
    g, ef = _gc_tree(1), _gc_tree(2, 0.1)
    jv, tv = jc._flatten(_to(g, "jax")), tc._flatten(_to(g, "torch"))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jcodes, jscales = jc.encode(jv, step=5)
    tcodes, tscales = tc.encode(tv, step=5)
    np.testing.assert_allclose(tscales.numpy(), np.asarray(jscales),
                               rtol=1e-6)
    blocks = np.asarray(jv, np.float64).reshape(tc.n_chunks, -1)
    signs = tc._signs(5).numpy().astype(np.float64)
    z = (blocks * signs / np.linalg.norm(blocks, axis=1, keepdims=True)
         ) @ jc._r_np.astype(np.float64) * np.sqrt(GC_CFG["chunk"])
    q = None if jc._offsets is None else np.asarray(jc._offsets, np.float64)
    _codes_agree(tcodes.numpy(), jcodes, z, tc.cfg.spec, q)
    np.testing.assert_allclose(tc.decode(tcodes, tscales, 5).numpy(),
                               np.asarray(jc.decode(jcodes, jscales, 5)),
                               rtol=1e-5,
                               atol=1e-5 * float(np.abs(jv).max()))
    tg, tef = tc.sync_local(_to(g, "torch"), _to(ef, "torch"), step=5)
    jg, jef = jc.sync_local(_to(g, "jax"), _to(ef, "jax"), step=5)
    _close_trees(tg, jg)
    _close_trees(tef, jef)
    assert tc.init_ef(_gc_template("torch"))["b"][1][0].shape == (2, 2)


def test_sync_at_world_size_1_is_sync_local(mesh):
    _, tc = _compressor_pair("2bit", 0.75)
    g, ef = _to(_gc_tree(3), "torch"), _to(_gc_tree(4, 0.1), "torch")
    sg, sef = tc.sync(g, ef, mesh, step=7)
    lg, lef = tc.sync_local(g, ef, step=7)
    _close_trees(sg, lg)
    _close_trees(sef, lef)
    assert tc.sync(g, None, mesh)[1] is None


def test_error_feedback_converges_least_squares():
    """The reference's EF-SGD check (tests/test_grad_compression.py) on the
    port: compressed-gradient descent reaches the least-squares optimum."""
    gen = torch.Generator().manual_seed(1)
    a = torch.randn((64, 32), generator=gen) / 8.0
    b = torch.randn(64, generator=gen)
    x_star = torch.linalg.lstsq(a, b[:, None]).solution[:, 0]
    comp = GradCompressor(GradCompressionConfig(scheme="2bit", w=0.75,
                                                rate=4, chunk=32),
                          {"x": torch.zeros(32)}, device="cpu")
    x, ef = torch.zeros(32), comp.init_ef({"x": torch.zeros(32)})
    for i in range(300):
        g = {"x": 2.0 * a.T @ (a @ x - b)}
        g_hat, ef = comp.sync_local(g, ef, step=i)
        x = x - 0.05 * g_hat["x"]
    opt = float(((a @ x_star - b) ** 2).sum())
    assert float(((a @ x - b) ** 2).sum()) < 1.05 * opt + 1e-3
    assert float((x - x_star).norm()) < 0.15 * float(x_star.norm())


# -- world size 2 -----------------------------------------------------------------

_PORT_RANK = r"""
import os, sys
rank, world, store_path, inp, out = sys.argv[1:6]
rank, world = int(rank), int(world)
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import convert
from repro_torch.ann import AnnEngine, BandSpec, CodeStore
from repro_torch.core.gradient_compression import GradCompressionConfig
from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
from repro_torch.encode import encode_sharded
from repro_torch.launch import make_dp_mesh
from repro_torch.core.schemes import CodeSpec
from repro_torch.learn import feature_spec_for, packed_grads_sharded
from repro_torch.learn.linear import targets_pm

z = np.load(inp)
dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                        rank=rank, world_size=world)
try:
    mesh = make_dp_mesh(device_type="cpu")
    res = {}
    sk = dict(k=int(z["k"]), scheme="2bit", w=0.75, seed=7)
    tc = convert.sketch_from_numpy(SketchConfig(**sk), int(z["d"]), z["r"],
                                   device="cpu")
    tt = convert.rank_tables_from_numpy(tc.spec, sk["k"], z["pair"],
                                        z["rho_grid"], z["score_grid"],
                                        device="cpu")
    eng = AnnEngine(tc, convert.store_from_numpy(z["words"], sk["k"], 2,
                                                 device="cpu"),
                    BandSpec(4, 4), rank_tables=tt)
    res["q_codes"] = eng.encode_queries(z["queries"]).numpy()
    modes = {"count": dict(), "two-stage": dict(scored=True, fused=False,
                                                rerank_m=100),
             "fused-f32": dict(scored=True, table_dtype="f32", rerank_m=100),
             "fused-int8": dict(scored=True, table_dtype="int8",
                                rerank_m=100)}
    for name, kw in modes.items():
        ids, rho = eng.search_sharded(z["queries"], mesh, top_k=10, **kw)
        res[f"ids-{name}"], res[f"rho-{name}"] = ids.numpy(), rho.numpy()
    res["enc"] = encode_sharded(tc.stream_encoder(), z["x"], mesh).numpy()
    fspec = feature_spec_for(CodeSpec("2bit", 0.75), 32)
    loss, (dt, db) = packed_grads_sharded(
        (torch.from_numpy(z["tables"]), torch.zeros(1)),
        torch.from_numpy(z["gwords"].view(np.int32)),
        targets_pm(z["gy"], 1, "cpu"), fspec, mesh)
    res["loss"], res["dt"], res["db"] = loss.numpy(), dt.numpy(), db.numpy()
    tpl = {"w": torch.zeros((300, 7)), "b": [torch.zeros(13),
                                             (torch.zeros((2, 2)),)]}
    comp = convert.grad_compressor_from_numpy(
        GradCompressionConfig(rate=4, chunk=256), tpl, z["gc_r"],
        device="cpu")

    def tree(prefix):
        return {"w": torch.from_numpy(z[prefix + "w"][rank]),
                "b": [torch.from_numpy(z[prefix + "b0"][rank]),
                      (torch.from_numpy(z[prefix + "b1"][rank]),)]}

    g_hat, ef = comp.sync(tree("g_"), tree("ef_"), mesh, step=3)
    res["sync_w"], res["sync_b0"] = g_hat["w"].numpy(), g_hat["b"][0].numpy()
    res["sync_b1"] = g_hat["b"][1][0].numpy()
    res["ef_w"], res["ef_b0"] = ef["w"].numpy(), ef["b"][0].numpy()
    res["ef_b1"] = ef["b"][1][0].numpy()
    odd = CodeStore.from_words(torch.from_numpy(z["words"][:-1].view(
        np.int32)), sk["k"], 2)
    raised = []
    for call in (lambda: odd.shard(mesh),
                 lambda: AnnEngine(tc, odd, BandSpec(4, 4)).search_sharded(
                     z["queries"], mesh),
                 lambda: encode_sharded(tc.stream_encoder(), z["x"][:-1],
                                        mesh)):
        try:
            call()
            raised.append(False)
        except ValueError:
            raised.append(True)
    res["raised"] = np.asarray(raised)
    res["local_n"] = np.asarray(eng.store.shard(mesh).n)
    np.savez(out, **res)
finally:
    dist.destroy_process_group()
"""

_JAX_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
inp, out = sys.argv[1:3]
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import learn as jl
from repro.learn.linear import targets_pm
from repro.ann import AnnEngine, BandSpec, CodeStore
from repro.core.gradient_compression import (GradCompressionConfig,
                                             GradCompressor)
from repro.core.schemes import CodeSpec
from repro.core.sketch import CodedRandomProjection, SketchConfig
from repro.encode import StreamingEncoder, encode_sharded
from repro.launch.mesh import make_dp_mesh
from repro.parallel.sharding import shard_map_unchecked
from repro.rank import RankTables

assert len(jax.devices()) == 2
z = np.load(inp)
mesh = make_dp_mesh(2)
res = {}
k = int(z["k"])
jc = CodedRandomProjection(SketchConfig(k=k, scheme="2bit", w=0.75, seed=7),
                           int(z["d"]))
tables = RankTables(spec=jc.spec, k=k, pair=jnp.asarray(z["pair"]),
                    rho_grid=jnp.asarray(z["rho_grid"]),
                    score_grid=jnp.asarray(z["score_grid"]))
eng = AnnEngine(jc, CodeStore.from_words(z["words"], k, 2), BandSpec(4, 4),
                rank_tables=tables)
q = jnp.asarray(z["queries"])
res["q_codes"] = np.asarray(eng.encode_queries(q))
modes = {"two-stage": dict(scored=True, fused=False, rerank_m=100),
         "fused-f32": dict(scored=True, table_dtype="f32", rerank_m=100),
         "fused-int8": dict(scored=True, table_dtype="int8", rerank_m=100)}
for name, kw in modes.items():
    ids, rho = eng.search_sharded(q, mesh, top_k=10, **kw)
    res[f"ids-{name}"], res[f"rho-{name}"] = np.asarray(ids), np.asarray(rho)
res["enc"] = np.asarray(encode_sharded(StreamingEncoder(jc),
                                       jnp.asarray(z["x"]), mesh))
fspec = jl.feature_spec_for(CodeSpec("2bit", 0.75), 32)
loss, (dt, db) = jax.jit(lambda p, w_, y_: jl.packed_grads_sharded(
    p, w_, y_, fspec, mesh))((jnp.asarray(z["tables"]), jnp.zeros((1,))),
                             jnp.asarray(z["gwords"]),
                             targets_pm(jnp.asarray(z["gy"]), 1))
res["loss"], res["dt"], res["db"] = (np.asarray(loss), np.asarray(dt),
                                     np.asarray(db))
tpl = {"w": jnp.zeros((300, 7)), "b": [jnp.zeros((13,)),
                                       (jnp.zeros((2, 2)),)]}
comp = GradCompressor(GradCompressionConfig(rate=4, chunk=256), tpl)
assert np.array_equal(comp._r_np, z["gc_r"])


def tree(prefix):
    return {"w": jnp.asarray(z[prefix + "w"]),
            "b": [jnp.asarray(z[prefix + "b0"]),
                  (jnp.asarray(z[prefix + "b1"]),)]}


def local(g, ef):
    squeeze = lambda t: jax.tree.map(lambda a: a[0], t)
    g_hat, new_ef = comp.sync(squeeze(g), squeeze(ef), "data", step=3)
    return g_hat, jax.tree.map(lambda a: a[None], new_ef)


fn = shard_map_unchecked(local, mesh, in_specs=(P("data"), P("data")),
                         out_specs=(P(), P("data")))
g_hat, ef = jax.jit(fn)(tree("g_"), tree("ef_"))
res["sync_w"], res["sync_b0"] = np.asarray(g_hat["w"]), np.asarray(
    g_hat["b"][0])
res["sync_b1"] = np.asarray(g_hat["b"][1][0])
res["ef_w"], res["ef_b0"] = np.asarray(ef["w"]), np.asarray(ef["b"][0])
res["ef_b1"] = np.asarray(ef["b"][1][0])
np.savez(out, **res)
"""


@pytest.fixture(autouse=True, scope="module")
def world2_children(tmp_path_factory, inputs):
    """Starts the port's two gloo ranks and the reference on two host
    devices, on the same inputs, before the first test of the file, so
    that they run beside it; ``world2`` collects them."""
    tmp = tmp_path_factory.mktemp("world2")
    inp = str(tmp / "in.npz")
    np.savez(inp, **{k: v for k, v in inputs.items() if k != "corpus"})
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    cmds = [[_PORT_RANK, str(r), "2", str(tmp / "store"), inp,
             str(tmp / f"port{r}.npz")] for r in range(2)]
    cmds.append([_JAX_REF, inp, str(tmp / "ref.npz")])
    procs = [subprocess.Popen([sys.executable, "-c", *c], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        yield tmp, procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def world2(world2_children):
    """The children's outputs: {"port": [rank 0, rank 1], "ref": ...}."""
    tmp, procs = world2_children
    for p in procs:
        try:
            log = p.communicate(timeout=CHILD_TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            log = p.communicate()[0]
        assert p.returncode == 0, log[-3000:]
    return dict(port=[dict(np.load(tmp / f"port{r}.npz")) for r in range(2)],
                ref=dict(np.load(tmp / "ref.npz")))


def test_world2_ranks_agree_and_split_the_rows(world2):
    port = world2["port"]
    for key in port[0]:
        if not key.startswith("ef_"):     # each rank keeps its own EF
            np.testing.assert_array_equal(port[0][key], port[1][key], key)
    assert int(port[0]["local_n"]) == N // 2


def test_world2_indivisible_n_raises(world2):
    """shard, search_sharded and encode_sharded at odd n over 2 ranks."""
    port = world2["port"]
    assert port[0]["raised"].tolist() == [True, True, True]


@pytest.mark.parametrize("mode", ["two-stage", "fused-f32", "fused-int8"])
def test_world2_search_matches_jax(world2, mode):
    port, ref = world2["port"], world2["ref"]
    np.testing.assert_array_equal(port[0]["q_codes"], ref["q_codes"])
    np.testing.assert_array_equal(port[0][f"ids-{mode}"], ref[f"ids-{mode}"])
    np.testing.assert_allclose(port[0][f"rho-{mode}"], ref[f"rho-{mode}"],
                               rtol=1e-6)


def test_world2_count_search_equals_unsharded(world2, engines, inputs):
    """Count-ranked search does not depend on the split."""
    port = world2["port"]
    ids, rho = engines[1].search(inputs["queries"], top_k=10)
    np.testing.assert_array_equal(port[0]["ids-count"], ids.numpy())
    np.testing.assert_array_equal(port[0]["rho-count"], rho.numpy())


def test_world2_encode_matches_jax(world2, inputs):
    port, ref = world2["port"], world2["ref"]
    z = inputs["x"].astype(np.float64) @ inputs["r"].astype(np.float64)
    spec = CodeSpec("2bit", 0.75)
    _codes_agree(packing.unpack_codes(_i32(port[0]["enc"]), 2, K).numpy(),
                 np.asarray(jax_packing.unpack_codes(jnp.asarray(ref["enc"]),
                                                     2, K)), z, spec)


def test_world2_grads_match_jax(world2):
    port, ref = world2["port"], world2["ref"]
    np.testing.assert_allclose(port[0]["loss"], ref["loss"], rtol=1e-6)
    np.testing.assert_allclose(port[0]["dt"], ref["dt"], **GRAD_TOL)
    np.testing.assert_allclose(port[0]["db"], ref["db"], **GRAD_TOL)


def test_world2_compressor_sync_matches_jax(world2):
    port, ref = world2["port"], world2["ref"]
    _close_trees([port[0][f"sync_{n}"] for n in GC_LEAVES],
                 [ref[f"sync_{n}"] for n in GC_LEAVES])
    for r in range(2):   # each rank's own EF state
        _close_trees([port[r][f"ef_{n}"] for n in GC_LEAVES],
                     [ref[f"ef_{n}"][r] for n in GC_LEAVES])
