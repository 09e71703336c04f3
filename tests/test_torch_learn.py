"""Port parity for ``repro_torch.learn``: the packed-linear plain versions,
the feature geometry, margins, gradients and every training path, each
held to ``repro.learn`` on the same numpy inputs.

Tolerances and why:

* forward (raw margins), feature geometry, converters: bit-exact (the
  same float32 adds in the same (word, field) order);
* backward: bit-exact where g is integer-valued in [-4, 4], so that every
  partial sum is exact in any order; else each entry within 1e-5 of its
  value plus 1e-6 of the sum of its terms' magnitudes (the reference adds
  within a chunk through XLA's dot, the port row by row, and an entry
  that nearly cancels keeps the rounding of its large partial sums);
* ``raw * scale + bias``: bit-exact where the scale 1/sqrt(k) is a power
  of two (k = 16, 64, 256); at k = 24 within one rounding of the product
  and one of the sum, because XLA contracts the affine into one FMA
  under ``jit`` and the port multiplies, then adds;
* trained models: tables within rtol 1e-4, atol 1e-5
  (``tests/test_learn.py``'s tolerance for two summation orders), and
  equal predictions on the test rows. ``fit_log`` is held at k = 16: at
  a k whose scale is inexact the reference's own ``fit_log`` departs
  from its ``fit_words`` by about lr after the first Adam step
  (``test_fit_log_first_step_at_an_inexact_scale``).

JAX runs its oracles (``impl="ref"``) and, once each way, its Pallas
kernels in interpret mode. Sizes stay small (n <= 700, k <= 256, at most
20 steps); torch runs on one thread, as in ``tests/test_torch_encode.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import packing as jax_packing
from repro.core.schemes import CodeSpec as JaxSpec
from repro.core import svm as jax_svm
from repro.ann import CodeStore as JaxStore
from repro.index import SegmentLogStore as JaxLog
from repro.kernels import ref as jax_ref
from repro.kernels.packed_linear import (onehot_tile,
                                         packed_linear_bwd_masked_pallas,
                                         packed_linear_fwd_masked_pallas)
from repro import learn as jl
from repro.learn import linear as jlin
from repro_torch import convert
from repro_torch import learn as tl
from repro_torch.ann import CodeStore
from repro_torch.core import lsh, packing, schemes, svm
from repro_torch.core.schemes import CodeSpec
from repro_torch.core.sketch import SketchConfig
from repro_torch.index import SegmentLogStore
from repro_torch.kernels import ops, ref
from repro_torch.learn import linear as tlin

TABLES_TOL = dict(rtol=1e-4, atol=1e-5)
SPECS = [("sign", 1.0), ("2bit", 0.75), ("uniform", 1.0)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _i32(a):
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _words(rng, n, k, bits):
    """Random codes over the full 2^bits range -> (uint32 words, int32
    view); packed by the port, which takes zero rows (JAX's pack_codes
    raises there, ROADMAP queue C)."""
    w = packing.pack_codes(torch.from_numpy(
        rng.integers(0, 1 << bits, (n, k))), bits)
    return w.numpy().view(np.uint32), w


def _masks(rng, n):
    """Validity masks: all dead, none dead, 10 % and 90 % dead."""
    return [np.zeros(n, bool), np.ones(n, bool), rng.random(n) >= 0.1,
            rng.random(n) >= 0.9]


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got).view(np.int32),
                                  np.asarray(want).view(np.int32))


# -- the plain versions against JAX's oracles and Pallas kernels --------------

@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_plain_forward_matches_jax(bits):
    rng = np.random.default_rng(bits)
    cases = ((33, 3, 31),) + (
        ((33, 1, 0), (100, 9, 33), (256, 1, 300)) if bits == 2 else ())
    for k, c, n in cases:
        w, tw = _words(rng, n, k, bits)
        fp = w.shape[1] * (32 // bits) << bits
        tab = rng.standard_normal((c, fp)).astype(np.float32)
        got = ops.packed_linear_fwd(torch.from_numpy(tab), tw, bits)
        _eq(got.numpy(), jax_ref.packed_linear_fwd_ref(jnp.asarray(tab),
                                                       jnp.asarray(w), bits))
        for live in _masks(rng, n) if k < 256 else ():
            tv = packing.pack_bitmask(torch.from_numpy(live))
            jv = jax_packing.pack_bitmask(jnp.asarray(live))
            _eq(ops.packed_linear_fwd_masked(torch.from_numpy(tab), tw, tv,
                                             bits).numpy(),
                jax_ref.packed_linear_fwd_masked_ref(
                    jnp.asarray(tab), jnp.asarray(w), jv, bits))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_plain_backward_matches_jax(bits):
    rng = np.random.default_rng(10 + bits)
    for k, c, n in ((33, 3, 100),) + (((100, 1, 600),) if bits == 2 else ()):
        w, tw = _words(rng, n, k, bits)
        g_int = rng.integers(-4, 5, (c, n)).astype(np.float32)
        for block_n in (32, 512):
            kw = dict(block_n=block_n)
            _eq(ops.packed_linear_bwd(torch.from_numpy(g_int), tw, bits,
                                      **kw).numpy(),
                jax_ref.packed_linear_bwd_ref(jnp.asarray(g_int),
                                              jnp.asarray(w), bits, **kw))
            for live in _masks(rng, n)[:2 if block_n == 512 else 4]:
                tv = packing.pack_bitmask(torch.from_numpy(live))
                jv = jax_packing.pack_bitmask(jnp.asarray(live))
                _eq(ops.packed_linear_bwd_masked(
                        torch.from_numpy(g_int), tw, tv, bits, **kw).numpy(),
                    jax_ref.packed_linear_bwd_masked_ref(
                        jnp.asarray(g_int), jnp.asarray(w), jv, bits, **kw))
        g_f = rng.standard_normal((c, n)).astype(np.float32)
        got = ops.packed_linear_bwd(torch.from_numpy(g_f), tw, bits).numpy()
        want = np.asarray(jax_ref.packed_linear_bwd_ref(
            jnp.asarray(g_f), jnp.asarray(w), bits))
        terms = np.abs(g_f).astype(np.float64) @ \
            ref.onehot_rows(tw, bits, torch.float64).numpy()
        assert (np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-6 * terms).all()


def _bwd_in_order(g, codes, bits, block_n, live=None):
    """The backward's documented sum order in numpy float32: per chunk of
    ``block_n`` rows, each live row's g added in ascending row order onto
    a partial that starts at +0.0; the partials added onto an accumulator
    from +0.0 in chunk order."""
    c, n = g.shape
    p, f = 1 << bits, codes.shape[1]
    acc = np.zeros((c, f * p), np.float32)
    for lo in range(0, n, block_n):
        part = np.zeros((c, f * p), np.float32)
        for r in range(lo, min(lo + block_n, n)):
            if live is None or live[r]:
                idx = np.arange(f) * p + codes[r]
                part[:, idx] = part[:, idx] + g[:, r:r + 1]
        acc = acc + part
    return acc


def test_plain_backward_order_is_pinned():
    """``ref.packed_linear_bwd_ref`` (the order the kernel is held to bit
    for bit) equals a float32 loop in that order, on g whose sums change
    with the order (+-2^24 beside 1.0 and 3.0), at block_n 32 and 512,
    masked too (dead rows' g NaN: a dead row adds nothing); another
    block_n gives other bits, so the check can see an order change."""
    rng = np.random.default_rng(21)
    bits, k, c, n = 2, 16, 2, 1100
    codes = rng.integers(0, 4, (n, k))
    tw = packing.pack_codes(torch.from_numpy(codes), bits)
    g = rng.choice(np.float32([2.0 ** 24, -2.0 ** 24, 1.0, -1.0, 3.0]),
                   (c, n))
    live = rng.random(n) >= 0.1
    tv = packing.pack_bitmask(torch.from_numpy(live))
    g_dead = np.where(live, g, np.float32(np.nan)).astype(np.float32)
    got = {}
    for block_n in (32, 512):
        want = _bwd_in_order(g, codes, bits, block_n)
        got[block_n] = ref.packed_linear_bwd_ref(
            torch.from_numpy(g), tw, bits, block_n=block_n).numpy()
        _eq(got[block_n], want)
        _eq(ref.packed_linear_bwd_masked_ref(
                torch.from_numpy(g_dead), tw, tv, bits,
                block_n=block_n).numpy(),
            _bwd_in_order(g, codes, bits, block_n, live))
    assert not np.array_equal(got[32], got[512])


def _fwd_in_order(tab, u, bits):
    """The forward's documented sum order in numpy float32: per row and
    class, from +0.0, the entry each field slot's code selects, one
    rounded add at a time in (word, field) order."""
    p, cpw = 1 << bits, 32 // bits
    s = np.zeros((tab.shape[0], u.shape[0]), np.float32)
    for j in range(u.shape[1]):
        for f in range(cpw):
            code = (u[:, j] >> np.uint32(f * bits)) & np.uint32(p - 1)
            s = s + tab[:, (j * cpw + f) * p + code.astype(np.int64)]
    return s


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_plain_forward_order_is_pinned(bits):
    """``ref.packed_linear_fwd_ref`` and its masked form (the order the
    kernel is held to bit for bit) equal a float32 loop in (word, field)
    order from 0.0, on tables whose sums change with the order (+-2^24
    beside 1.0 and 3.0; k = 40 leaves phantom field slots at 8 bits);
    the fields added in reverse give other bits, so the check can see an
    order change. Dead rows are 0.0."""
    rng = np.random.default_rng(40 + bits)
    k, c, n = 40, 3, 300
    u, tw = _words(rng, n, k, bits)
    fp = u.shape[1] * (32 // bits) << bits
    tab = rng.choice(np.float32([2.0 ** 24, -2.0 ** 24, 1.0, 3.0]), (c, fp))
    want = _fwd_in_order(tab, u, bits)
    got = ref.packed_linear_fwd_ref(torch.from_numpy(tab), tw, bits).numpy()
    _eq(got, want)
    p, cpw = 1 << bits, 32 // bits
    rev = np.zeros_like(want)
    for slot in reversed(range(u.shape[1] * cpw)):
        j, f = divmod(slot, cpw)
        code = (u[:, j] >> np.uint32(f * bits)) & np.uint32(p - 1)
        rev = rev + tab[:, slot * p + code.astype(np.int64)]
    assert not np.array_equal(rev, want)
    live = rng.random(n) >= 0.1
    tv = packing.pack_bitmask(torch.from_numpy(live))
    _eq(ref.packed_linear_fwd_masked_ref(torch.from_numpy(tab), tw, tv,
                                         bits).numpy(),
        np.where(live, want, np.float32(0.0)))


@pytest.mark.parametrize(
    "n,w,bits,c,form,tile,smem,tiles,tpb,grid", [
        # the learn path's shapes: C = 1 and one-vs-rest's C = 8; 9,104
        # row tiles over the card's resident blocks (132 SMs x 8)
        (2_330_594, 16, 2, 1, "smem", 1, 4096, 9104, 9, (1056, 1)),
        (2_330_594, 16, 2, 8, "smem", 8, 32768, 9104, 9, (1056, 1)),
        # classify's 1,024 rows and a 65,536-row minibatch: a block a tile
        (1024, 16, 2, 1, "smem", 1, 4096, 4, 1, (4, 1)),
        (65_536, 16, 2, 1, "smem", 1, 4096, 256, 1, (256, 1)),
        (1000, 4, 1, 3, "smem", 3, 3072, 4, 1, (4, 1)),
        (3000, 13, 4, 9, "smem", 9, 59904, 12, 1, (12, 1)),
        # 8-bit rows of 9 words: 36 KB a class, two classes a tile; three
        # class tiles share the resident blocks
        (100_000, 9, 8, 5, "smem", 2, 73728, 391, 2, (352, 3)),
        # tables too wide for shared memory: 8-bit rows of 40 words (160
        # KB a class) and every 16-bit table
        (1000, 40, 8, 3, "mem", 0, 0, 4, None, (4, 1)),
        (300, 17, 16, 1, "mem", 0, 0, 2, None, (2, 1))])
def test_fwd_launch_plan(n, w, bits, c, form, tile, smem, tiles, tpb, grid):
    """Which forward form a call launches and how, by shape alone: the
    class tile whose tables fit SMEM_TABLE_MAX, the shared memory, the
    row tiles of FWD_THREADS rows and the grid (the card's resident
    blocks, here 132 SMs x 8, spread over the class tiles, or the tiles
    there are)."""
    from repro_torch.kernels import packed_linear as pl
    p = pl.fwd_plan(n, w, bits, c, sms=132, blocks_per_sm=8)
    fp = (w * (32 // bits)) << bits
    assert (p["form"], p["class_tile"], p["smem"], p["tiles"],
            p["grid"]) == (form, tile, smem, tiles, grid)
    assert p["threads"] == pl.FWD_THREADS and \
        (tiles - 1) * pl.FWD_THREADS < n <= tiles * pl.FWD_THREADS
    if form == "mem":
        assert pl.fwd_class_tile(fp) == 0
        return
    assert p["tiles_per_block"] == tpb
    assert tile == min(c, pl.fwd_class_tile(fp)) and \
        smem == 4 * tile * fp <= pl.SMEM_TABLE_MAX
    assert grid[1] == -(-c // tile)
    # every block walks a tile or more, within the resident blocks
    assert grid[0] <= tiles and tpb == -(-tiles // grid[0])
    assert grid[0] * grid[1] <= 132 * 8


def test_fwd_plan_cache_follows_limits(monkeypatch):
    """Forward plans are cached by shape, yet a shrunk limit plans anew:
    fewer blocks make each walk more row tiles, a smaller table budget
    gives the memory form, and the old limits the old plan."""
    from repro_torch.kernels import packed_linear as pl
    args = (3000, 16, 2, 1)
    kw = dict(sms=132, blocks_per_sm=8)
    first = pl.fwd_plan(*args, **kw)
    assert (first["form"], first["grid"], first["tiles_per_block"]) == \
        ("smem", (12, 1), 1)
    first["form"] = "changed"
    with monkeypatch.context() as m:
        m.setattr(pl, "FWD_BLOCKS_MAX", 2)
        p = pl.fwd_plan(*args, **kw)
        assert (p["grid"], p["tiles_per_block"]) == ((2, 1), 6)
    with monkeypatch.context() as m:
        m.setattr(pl, "SMEM_TABLE_MAX", 1024)
        assert pl.fwd_plan(*args, **kw)["form"] == "mem"
    again = pl.fwd_plan(*args, **kw)
    assert (again["form"], again["grid"]) == ("smem", (12, 1))


@pytest.mark.parametrize(
    "n,w,bits,c,block_n,form,ct,ft,threads,groups,gp,tr,tpc,cpb,grid", [
        # the learn path's shapes: C = 1 and one-vs-rest's C = 8
        (2_330_594, 16, 2, 1, 512, "tiled", 1, 8, 32, 1, 1, 128, 4, 5,
         (911, 1)),
        (2_330_594, 16, 2, 8, 512, "tiled", 8, 1, 256, 1, 8, 96, 6, 5,
         (911, 1)),
        # C = 9: eight classes a thread, two class groups over two blocks
        (2_330_594, 16, 2, 9, 512, "tiled", 8, 1, 256, 2, 8, 96, 6, 9,
         (506, 2)),
        (3000, 8, 1, 3, 32, "tiled", 8, 2, 128, 1, 8, 32, 1, 1, (94, 1)),
        (1000, 13, 4, 2, 100, "tiled", 2, 1, 128, 1, 2, 100, 1, 1,
         (10, 1)),
        # a chunk wider than a slot: 3,000 rows in tiles of 96
        (3000, 16, 2, 3, 5000, "tiled", 8, 1, 256, 1, 8, 96, 32, 1,
         (1, 1)),
        # block_n 1: a tile a row
        (100, 3, 2, 1, 1, "tiled", 1, 8, 32, 1, 1, 1, 1, 1, (100, 1)),
        # 8- and 16-bit fields keep the memory form, and so do rows whose
        # two one-row slots exceed a block's shared memory
        (1000, 9, 8, 3, 32, "mem", None, None, None, None, None, None,
         None, None, None),
        (1000, 8000, 4, 2, 512, "mem", None, None, None, None, None, None,
         None, None, None),
        (300, 17, 16, 1, 512, "mem", None, None, None, None, None, None,
         None, None, None)])
def test_bwd_launch_plan(n, w, bits, c, block_n, form, ct, ft, threads,
                         groups, gp, tr, tpc, cpb, grid):
    """Which backward form a call launches and how, by shape alone: the
    tiled partial kernel's classes and fields a thread, its block, g's
    class pitch, the row tiles of a chunk (a ring slot of at most
    SLOT_BYTES), the chunks a block walks (the card's resident blocks,
    here 132 SMs x 8, covered once) and the fold's slabs."""
    from repro_torch.kernels import packed_linear as pl
    p = pl.bwd_plan(n, w, bits, c, block_n, sms=132, blocks_per_sm=8)
    fp = (w * (32 // bits)) << bits
    n_chunks = -(-n // block_n)
    assert p["form"] == form
    assert p["group_chunks"] == pl.bwd_group_chunks(c, fp, n_chunks)
    assert (p["fold_slab"], p["fold_grid"]) == (8, c * fp // 8)
    if form == "mem":
        return
    assert (p["classes_per_thread"], p["fields_per_thread"], p["threads"],
            p["item_groups"], p["class_pitch"], p["tile_rows"],
            p["tiles_per_chunk"], p["chunks_per_block"], p["grid"]) == \
        (ct, ft, threads, groups, gp, tr, tpc, cpb, grid)
    assert ct == pl.bwd_classes_per_thread(bits, c)
    # every (class group, field group) item has a thread; FT * P * CT = 32
    # accumulators
    f_all = w * (32 // bits)
    assert p["items"] == -(-c // ct) * (f_all // ft) <= threads * groups
    assert ft * (1 << bits) * ct == 32
    # the tiles cover a chunk; a slot holds a tile and fits SLOT_BYTES
    rows = min(block_n, n)
    assert (tpc - 1) * tr < rows <= tpc * tr
    assert p["smem"] == 8 * pl._slot_words(tr, w, gp)
    assert p["smem"] <= 2 * pl.SLOT_BYTES or tr == 1
    # the blocks cover the group's chunks once, none empty
    assert (grid[0] - 1) * cpb < p["group_chunks"] <= grid[0] * cpb
    assert grid[0] * groups <= max(132 * 8, groups)


def test_bwd_plan_cache_follows_limits(monkeypatch):
    """Plans are cached by shape, yet a shrunk limit plans anew: a block's
    shared memory below two one-row slots gives the memory form, fewer
    partial bytes give smaller groups, and the old limits the old plan;
    a caller's change to a returned plan does not reach the cache."""
    from repro_torch.kernels import packed_linear as pl
    args = (3000, 16, 2, 1, 100)
    kw = dict(sms=132, blocks_per_sm=8)
    first = pl.bwd_plan(*args, **kw)
    assert (first["form"], first["group_chunks"]) == ("tiled", 30)
    first["form"] = "changed"
    with monkeypatch.context() as m:
        m.setattr(pl, "SMEM_BLOCK_MAX", 256)
        assert pl.bwd_plan(*args, **kw)["form"] == "mem"
    with monkeypatch.context() as m:
        m.setattr(pl, "PART_BYTES_MAX", 3 * 4 * 16 * 16 * 4)
        assert pl.bwd_plan(*args, **kw)["group_chunks"] == 3
    again = pl.bwd_plan(*args, **kw)
    assert (again["form"], again["group_chunks"]) == ("tiled", 30)


def test_plain_versions_match_pallas_interpret():
    """JAX's kernels themselves (interpret mode, block_c=2, block_n=32)
    against the port's plain versions: forward bit-exact, backward
    bit-exact on integer g, each with the 10 %-dead mask."""
    rng = np.random.default_rng(3)
    bits, k, c, n = 2, 40, 3, 64
    w, tw = _words(rng, n, k, bits)
    fp = w.shape[1] * (32 // bits) << bits
    tab = rng.standard_normal((c, fp)).astype(np.float32)
    g = rng.integers(-4, 5, (c, n)).astype(np.float32)
    live = rng.random(n) >= 0.1
    tv = packing.pack_bitmask(torch.from_numpy(live))
    jv = jax_packing.pack_bitmask(jnp.asarray(live))
    blocks = dict(block_c=2, block_n=32, interpret=True)
    jt, jw, jg = jnp.asarray(tab), jnp.asarray(w), jnp.asarray(g)
    tt, tg = torch.from_numpy(tab), torch.from_numpy(g)
    _eq(ops.packed_linear_fwd_masked(tt, tw, tv, bits).numpy(),
        packed_linear_fwd_masked_pallas(jt, jw, jv, bits, **blocks))
    _eq(ops.packed_linear_bwd_masked(tg, tw, tv, bits, block_n=32).numpy(),
        packed_linear_bwd_masked_pallas(jg, jw, jv, bits, **blocks))


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_onehot_rows_matches_jax(bits):
    rng = np.random.default_rng(20 + bits)
    w, tw = _words(rng, 8, 5 if bits == 16 else 37, bits)
    got = ref.onehot_rows(tw, bits).numpy()
    _eq(got, jax_ref._onehot_rows(jnp.asarray(w), bits))
    _eq(got, onehot_tile(jnp.asarray(w), bits))


# -- feature geometry ----------------------------------------------------------

@pytest.mark.parametrize("scheme,w", SPECS + [("uniform", 0.25)])
def test_feature_spec_matches_jax(scheme, w):
    k = 30
    jf = jl.feature_spec_for(JaxSpec(scheme, w), k)
    tf = tl.feature_spec_for(CodeSpec(scheme, w), k)
    for name in ("k", "bits", "n_codes", "n_words", "n_entries", "n_fields",
                 "table_width", "dense_dim", "scale"):
        assert getattr(tf, name) == getattr(jf, name), name
    _eq(tf.entry_mask("cpu").numpy(), jf.entry_mask())
    rng = np.random.default_rng(1)
    dense = rng.standard_normal((2, tf.dense_dim)).astype(np.float32)
    tables = tf.tables_from_dense(dense, device="cpu")
    _eq(tables.numpy(), jf.tables_from_dense(jnp.asarray(dense)))
    _eq(tf.dense_from_tables(tables).numpy(), dense)
    codes = rng.integers(0, tf.n_codes, (9, k))
    _eq(tl.expand_codes(torch.from_numpy(codes), CodeSpec(scheme, w)).numpy(),
        jl.expand_codes(jnp.asarray(codes), JaxSpec(scheme, w)))


def test_feature_spec_from_sketcher_and_errors():
    from repro_torch.core.sketch import CodedRandomProjection
    crp = CodedRandomProjection(SketchConfig(k=48, scheme="2bit", w=0.75),
                                16, device="cpu")
    assert tl.feature_spec_for(crp).k == 48
    assert tl.feature_spec_for(crp, 20).k == 20
    with pytest.raises(TypeError):
        tl.feature_spec_for(CodeSpec("2bit", 0.75))
    with pytest.raises(ValueError):
        tl.PackedFeatureSpec(k=8, bits=1, n_codes=4)


# -- margins and gradients -----------------------------------------------------

def _problem(seed, k, n, n_cls=1, scheme="2bit", w=0.75, sep=0.4):
    """Planted rows: binary labels ±1 (n_cls == 1) or class ids, codes of
    Gaussian projections shifted by a class mean -> (codes, uint32 words,
    labels), coded and packed by the port (equal to JAX's,
    ``tests/test_torch_schemes.py``)."""
    rng = np.random.default_rng(seed)
    if n_cls == 1:
        y = np.where(rng.random(n) < 0.5, 1, -1)
        mu = rng.standard_normal(k) * sep
        z = rng.standard_normal((n, k)) + y[:, None] * mu
    else:
        y = rng.integers(0, n_cls, n)
        mu = rng.standard_normal((n_cls, k)) * sep * 1.5
        z = rng.standard_normal((n, k)) + mu[y]
    spec = CodeSpec(scheme, w)
    codes = schemes.encode(torch.from_numpy(z.astype(np.float32)), spec)
    return (codes.numpy(),
            packing.pack_codes(codes, spec.bits).numpy().view(np.uint32), y)


@pytest.mark.parametrize("k", [16, 24])
def test_margins_and_the_fma_finding(k):
    """Raw margins bit-exact; after the affine bit-exact at k = 16 (scale
    1/4, as 1/16 at k = 256) and at k = 24 within one rounding of the
    product and one of the sum, where the
    jitted reference equals a fused multiply-add (emulated in float64)
    and the port a multiply, then an add."""
    _, w, _ = _problem(5, k, 500)
    jf = jl.feature_spec_for(JaxSpec("2bit", 0.75), k)
    tf = tl.feature_spec_for(CodeSpec("2bit", 0.75), k)
    rng = np.random.default_rng(6)
    tab = (rng.standard_normal((3, tf.table_width)).astype(np.float32)
           * np.asarray(jf.entry_mask()))
    bias = rng.standard_normal(3).astype(np.float32)
    raw_t = ops.packed_linear_fwd(torch.from_numpy(tab), _i32(w), 2).numpy()
    raw_j = np.asarray(jax_ref.packed_linear_fwd_ref(jnp.asarray(tab),
                                                     jnp.asarray(w), 2))
    _eq(raw_t, raw_j)
    got = tlin.packed_margins(torch.from_numpy(tab), torch.from_numpy(bias),
                              _i32(w), tf).numpy()
    want = np.asarray(jax.jit(jlin.packed_margins,
                              static_argnames=("fspec", "impl"))(
        jnp.asarray(tab), jnp.asarray(bias), jnp.asarray(w), jf))
    scale = np.float32(tf.scale)
    fma = (raw_j.astype(np.float64) * np.float64(scale)
           + bias[:, None]).astype(np.float32)
    mul_add = raw_j * scale + bias[:, None]
    _eq(got, mul_add)
    _eq(want, fma)
    if k == 16:
        _eq(got, want)
    else:
        assert (np.abs(got - want) <= np.spacing(np.abs(raw_j * scale))
                + np.spacing(np.abs(want))).all()
        assert (got != want).any()


@pytest.mark.parametrize("loss", ["sq_hinge", "logistic"])
@pytest.mark.parametrize("masked", [False, True])
def test_data_grads_match_jax(loss, masked):
    k, n = 48, 700
    _, w, y = _problem(7, k, n, n_cls=3)
    jf = jl.feature_spec_for(JaxSpec("2bit", 0.75), k)
    tf = tl.feature_spec_for(CodeSpec("2bit", 0.75), k)
    rng = np.random.default_rng(8)
    tab = (rng.standard_normal((3, tf.table_width)).astype(np.float32) * 0.1
           * np.asarray(jf.entry_mask()))
    bias = np.asarray([0.3, -0.1, 0.05], np.float32)
    live = rng.random(n) >= 0.1
    jv = jax_packing.pack_bitmask(jnp.asarray(live)) if masked else None
    tv = packing.pack_bitmask(torch.from_numpy(live)) if masked else None
    jl_, (jdt, jdb) = jlin.packed_data_grads(
        (jnp.asarray(tab), jnp.asarray(bias)), jnp.asarray(w),
        jlin.targets_pm(jnp.asarray(y), 3), jf, c=0.5, loss=loss,
        valid_words=jv)
    tl_, (tdt, tdb) = tlin.packed_data_grads(
        (torch.from_numpy(tab), torch.from_numpy(bias)), _i32(w),
        tlin.targets_pm(y, 3), tf, c=0.5, loss=loss, valid_words=tv)
    np.testing.assert_allclose(float(tl_), float(jl_), rtol=1e-6)
    np.testing.assert_allclose(tdt.numpy(), np.asarray(jdt), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tdb.numpy(), np.asarray(jdb), rtol=1e-5,
                               atol=1e-6)
    assert not tdt.numpy()[:, np.asarray(jf.entry_mask()) == 0].any()


# -- training paths ------------------------------------------------------------

def _close_models(tm, jm, words_u32, n_test=None):
    np.testing.assert_allclose(tm.tables.numpy(), np.asarray(jm.tables),
                               **TABLES_TOL)
    np.testing.assert_allclose(tm.bias.numpy(), np.asarray(jm.bias),
                               **TABLES_TOL)
    test = words_u32 if n_test is None else words_u32[-n_test:]
    np.testing.assert_array_equal(tm.predict(_i32(test)).numpy(),
                                  np.asarray(jm.predict(jnp.asarray(test))))


@pytest.mark.parametrize("case", ["train_packed_linear", "full_batch",
                                  "minibatch", "one_vs_rest", "logistic",
                                  "fit_store"])
def test_training_matches_jax(case):
    k, n, n_test = 32, 600, 100
    n_cls = 3 if case == "one_vs_rest" else 1
    codes, w, y = _problem(11, k, n + n_test, n_cls=n_cls)
    jw, tw = jnp.asarray(w[:n]), _i32(w[:n])
    jspec, tspec = JaxSpec("2bit", 0.75), CodeSpec("2bit", 0.75)
    steps = 20
    kw = dict(steps=steps, batch=128 if case == "minibatch" else 0, seed=3,
              loss="logistic" if case == "logistic" else "sq_hinge")
    jc, tc = jl.LearnConfig(**kw), tl.LearnConfig(**kw)
    if case == "train_packed_linear":
        jm = jl.train_packed_linear(jw, jnp.asarray(y[:n], jnp.float32),
                                    jl.feature_spec_for(jspec, k), jc)
        tm = tl.train_packed_linear(tw, y[:n].astype(np.float32),
                                    tl.feature_spec_for(tspec, k), tc)
    elif case == "fit_store":
        jm = jl.fit_store(JaxStore.from_codes(jnp.asarray(codes[:n]), k, 2),
                          jnp.asarray(y[:n]), jspec, jc)
        tm = tl.fit_store(CodeStore(words=tw, k=k, bits=2), y[:n], tspec, tc)
    else:
        jm = jl.fit_words(jw, jnp.asarray(y[:n]), jspec, jc, k=k,
                          n_outputs=n_cls)
        tm = tl.fit_words(tw, y[:n], tspec, tc, k=k, n_outputs=n_cls)
    assert tm.n_outputs == n_cls and tm.loss == kw["loss"]
    _close_models(tm, jm, w, n_test)
    assert tm.accuracy(_i32(w[-n_test:]), y[-n_test:]) > 0.75


def test_masked_fit_words_matches_jax():
    k, n = 32, 500
    _, w, y = _problem(12, k, n)
    live = np.random.default_rng(2).random(n) >= 0.2
    jm = jl.fit_words(jnp.asarray(w), jnp.asarray(y), JaxSpec("2bit", 0.75),
                      jl.LearnConfig(steps=20), k=k,
                      valid_words=jax_packing.pack_bitmask(jnp.asarray(live)))
    tm = tl.fit_words(_i32(w), y, CodeSpec("2bit", 0.75),
                      tl.LearnConfig(steps=20), k=k,
                      valid_words=packing.pack_bitmask(torch.from_numpy(live)))
    _close_models(tm, jm, w)


def _churned_logs(k, n=500):
    """One seeded churn (deletes, upserts with new codes and labels) in
    both packages' segment logs -> (JAX log, port log, labels by id)."""
    codes, _, y = _problem(13, k, n)
    js = JaxLog(k, 2, tail_rows=256)
    ts = SegmentLogStore(k, 2, tail_rows=256, device="cpu")
    ids = js.add_codes(jnp.asarray(codes))
    np.testing.assert_array_equal(ts.add_codes(codes), ids)
    labels = {int(i): int(y[j]) for j, i in enumerate(ids)}
    dead = [int(i) for i in ids[::5]]
    js.delete(dead)
    ts.delete(dead)
    for i in dead:
        labels.pop(i)
    up = ids[3::50]
    new_codes, _, _ = _problem(17, k, len(up))
    js.upsert_codes(up, jnp.asarray(new_codes))
    ts.upsert_codes(up, new_codes)
    for i in up:
        labels[int(i)] = -1
    return js, ts, labels


def test_fit_log_on_churned_log_matches_jax():
    """fit_log over a churned log agrees with JAX's, and with the port's
    fit_words over live_words() and the live labels (k = 16: the scale
    1/4 is exact, see the next test)."""
    k = 16
    js, ts, labels = _churned_logs(k)
    spec, cfg = CodeSpec("2bit", 0.75), tl.LearnConfig(steps=20)
    jm = jl.fit_log(js, labels, JaxSpec("2bit", 0.75),
                    jl.LearnConfig(steps=20))
    tm = tl.fit_log(ts, labels, spec, cfg)
    live_words = ts.live_words()
    _close_models(tm, jm, live_words.numpy().view(np.uint32))
    fresh = tl.fit_words(live_words, [labels[int(i)] for i in ts.live_ids()],
                         spec, cfg, k=k)
    np.testing.assert_allclose(tm.tables.numpy(), fresh.tables.numpy(),
                               **TABLES_TOL)
    np.testing.assert_array_equal(tm.predict(live_words).numpy(),
                                  fresh.predict(live_words).numpy())
    by_id = tl.fit_log(ts, lambda q: [labels[int(i)] for i in q], spec,
                       tl.LearnConfig(steps=5))
    _eq(by_id.tables.numpy(), tl.fit_log(ts, labels, spec,
                                         tl.LearnConfig(steps=5)).tables)


def test_fit_log_first_step_at_an_inexact_scale():
    """At k = 32 (scale 1/sqrt(32)) the first gradient of a table entry is
    an integer times the scale. Summed over the whole store it can be an
    exact 0.0, while the per-segment products round and their sum is a
    few ulps off 0.0; Adam's first step moves such an entry by lr either
    way. So fit_log departs from fit_words by about lr after one step, in
    the reference as in the port (ROADMAP queue C)."""
    k = 32
    js, ts, labels = _churned_logs(k, n=700)
    live_words = ts.live_words()
    y_live = [labels[int(i)] for i in ts.live_ids()]
    spec, cfg = CodeSpec("2bit", 0.75), tl.LearnConfig(steps=1)
    jspec, jcfg = JaxSpec("2bit", 0.75), jl.LearnConfig(steps=1)
    gap_j = np.abs(np.asarray(jl.fit_log(js, labels, jspec, jcfg).tables)
                   - np.asarray(jl.fit_words(
                       jnp.asarray(live_words.numpy().view(np.uint32)),
                       jnp.asarray(y_live), jspec, jcfg, k=k).tables)).max()
    gap_t = float((tl.fit_log(ts, labels, spec, cfg).tables
                   - tl.fit_words(live_words, y_live, spec, cfg,
                                  k=k).tables).abs().max())
    assert gap_j > 0.05 and gap_t > 0.05


def test_dense_paths_match_jax():
    """train_dense_linear (sq_hinge and logistic) and the core.svm
    wrapper against JAX's, on one-hot features."""
    k, n = 24, 300
    codes, _, y = _problem(19, k, n)
    xj = jl.expand_codes(jnp.asarray(codes), JaxSpec("2bit", 0.75))
    xt = tl.expand_codes(torch.from_numpy(codes), CodeSpec("2bit", 0.75))
    _eq(xt.numpy(), xj)
    yf = y.astype(np.float32)
    for loss in ("sq_hinge", "logistic"):
        cfg = dict(steps=20, loss=loss)
        wj, bj = jl.train_dense_linear(xj, jnp.asarray(yf),
                                       jl.LearnConfig(**cfg))
        wt, bt = tl.train_dense_linear(xt, torch.from_numpy(yf),
                                       tl.LearnConfig(**cfg))
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), **TABLES_TOL)
        np.testing.assert_allclose(float(bt), float(bj), **TABLES_TOL)
    wj, bj = jax_svm.train_linear_svm(xj, jnp.asarray(yf),
                                      jax_svm.SVMConfig(steps=20))
    wt, bt = svm.train_linear_svm(xt, torch.from_numpy(yf),
                                  svm.SVMConfig(steps=20))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), **TABLES_TOL)
    assert float(svm.svm_accuracy(wt, bt, xt, yf)) == \
        float(jax_svm.svm_accuracy(wj, bj, xj, jnp.asarray(yf)))


def test_jax_model_converts_with_identical_margins():
    k = 16
    codes, w, y = _problem(23, k, 400, n_cls=3)
    jm = jl.fit_words(jnp.asarray(w), jnp.asarray(y), JaxSpec("2bit", 0.75),
                      jl.LearnConfig(steps=10), k=k, n_outputs=3)
    tm = convert.linear_model_from_numpy(jm.fspec, np.asarray(jm.tables),
                                         np.asarray(jm.bias), jm.loss,
                                         device="cpu")
    _eq(ops.packed_linear_fwd(tm.tables, _i32(w), 2).numpy(),
        jax_ref.packed_linear_fwd_ref(jm.tables, jnp.asarray(w), 2))
    _eq(tm.margins(_i32(w)).numpy(), jm.margins(jnp.asarray(w)))
    np.testing.assert_array_equal(tm.predict(_i32(w)).numpy(),
                                  np.asarray(jm.predict(jnp.asarray(w))))
    _eq(tm.dense_weights().numpy(), jm.dense_weights())
    with pytest.raises(ValueError):
        convert.linear_model_from_numpy(jm.fspec, np.zeros((1, 5)),
                                        np.zeros(1), device="cpu")


def test_lsh_wrapper_over_the_engine():
    """core.lsh.LSHIndex answers from the engine's band candidates and
    packed re-rank (both held to JAX in tests/test_torch_scored.py):
    candidates are the rows sharing a band, a query returns them by
    rho_hat, and a near duplicate comes back first."""
    from repro_torch.core.sketch import CodedRandomProjection
    d, k, n = 32, 64, 200
    rng = np.random.default_rng(29)
    x = rng.standard_normal((n, d)).astype(np.float32)
    crp = CodedRandomProjection(SketchConfig(k=k), d, device="cpu")
    index = lsh.LSHIndex(crp, n_tables=8, band_width=4)
    with pytest.raises(RuntimeError):
        index.engine
    index.build(torch.from_numpy(x))
    q = x[3] + 0.05 * rng.standard_normal(d).astype(np.float32)
    q_codes = index.engine.encode_queries(torch.from_numpy(q)[None])[0]
    cand = index.candidates(q_codes)
    counts = index.engine.band_match_counts(q_codes[None])[0]
    assert cand == np.flatnonzero(counts.numpy() > 0).tolist() and 3 in cand
    hits = index.query(q, top=5)
    _, rho = index.engine.rerank(q_codes, torch.as_tensor(cand))
    order = np.argsort(-rho.numpy(), kind="stable")[:5]
    assert [i for i, _ in hits] == [cand[i] for i in order]
    assert hits[0][0] == 3
    np.testing.assert_array_equal([r for _, r in hits], rho.numpy()[order])
    with pytest.raises(ValueError):
        lsh.LSHIndex(crp, n_tables=20, band_width=4)


def test_config_errors_and_left_out_arguments():
    _, w, y = _problem(31, 16, 64)
    tw, spec = _i32(w), CodeSpec("2bit", 0.75)
    with pytest.raises(ValueError):
        tl.LearnConfig(loss="hinge")
    with pytest.raises(ValueError):
        tl.fit_words(tw, y, spec, tl.LearnConfig(steps=2, batch=32), k=16,
                     valid_words=packing.pack_bitmask(torch.ones(64)))
    with pytest.raises(ValueError):
        tl.fit_words(tw, y, spec, tl.LearnConfig(steps=2, batch=128), k=16)
    with pytest.raises(ValueError):
        tl.fit_store(CodeStore(words=tw, k=16, bits=2), y, CodeSpec("sign", 1.0))
    store = SegmentLogStore(16, 2, tail_rows=32, device="cpu")
    with pytest.raises(ValueError, match="no live rows"):
        tl.fit_log(store, {}, spec)
    store.add_words(w)
    with pytest.raises(ValueError):
        tl.fit_log(store, lambda ids: [1] * len(ids), spec,
                   tl.LearnConfig(steps=2, batch=4))
    # quality= feeds the post-fit margins (tests/test_torch_health.py);
    # a bundle whose registry is off takes nothing
    from repro_torch.obs import MetricsRegistry, QualityConfig, QualityMonitors
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
    off = QualityMonitors(CodedRandomProjection(
        SketchConfig(k=16), 4, device="cpu"), QualityConfig(grid_size=16),
        registry=MetricsRegistry(enabled=False))
    tl.fit_words(tw, y, spec, tl.LearnConfig(steps=1), k=16, quality=off)
    tl.fit_log(store, lambda ids: [1] * len(ids), spec,
               tl.LearnConfig(steps=1), quality=off)
    assert off.margins.moments.n == 0
    model = tl.PackedLinearModel.zeros(tl.feature_spec_for(spec, 16), 2,
                                       device="cpu")
    with pytest.raises(ValueError, match="binary-only"):
        model.decision(tw)
