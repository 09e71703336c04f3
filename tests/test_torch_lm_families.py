"""Port parity for the MoE, hybrid (Mamba2 + shared attention) and SSM
(RWKV6) families (``repro_torch.models.moe``, ``mamba2``, ``rwkv6`` and
their blocks in ``lm``).

Weights go across from the reference's ``init_params`` through
``convert.lm_params_from_numpy``. The reference keys its leaves by
Python's salted ``hash`` (ROADMAP C), so its draw changed from process to
process, and on four draws of 21 a per-head scalar's gradient
(zamba2's ``a_log`` or ``d_skip``, two entries, sums with much
cancellation) came out beyond its bound; this file keys them by
``zlib.crc32`` of the same path (``_stable_reference_init``), one draw in
every process. Smoke configs at two layers (zamba2 at four:
one ``AMMM`` group and an ``M`` tail), float32, the reference under
``jax.jit`` compiled at XLA's LLVM optimisation level 0 (``_o0``: the
same arithmetic but for fused multiply-adds, which the tolerances cover)
with remat off, the port with remat on where it takes gradients.

Tolerances, as ``tests/test_torch_lm.py``'s: rtol 1e-4 plus a fraction
of the compared tensor's largest magnitude, 2e-5 for hidden states,
states and caches, 1e-5 for logits, 5e-5 for gradients; the loss and the
aux loss relative 1e-5; expert ids, tokens and kept masks equal; decode
against the full forward the reference's own bound, error over scale
below 0.08 (``tests/test_models_smoke.py``).

The file keeps to ten items (xdist's ``--dist loadfile`` queues files
with more tests ahead of the suite's longest file) and to one torch
thread.
"""
import gc
import zlib
from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as JC
from repro.models import attention as JA
from repro.models import lm as JL
from repro.models import mamba2 as JM
from repro.models import moe as JMOE
from repro.models import nn as JNN
from repro.models import rwkv6 as JR
from repro.models.nn import count_params as jax_count
from repro.models.nn import init_params as jax_init
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.models import attention as TA
from repro_torch.models import lm as TL
from repro_torch.models import mamba2 as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import rwkv6 as TR
from repro_torch.models.nn import (count_params, init_params, tree_items,
                                   tree_leaves)
from repro_torch.serve import generate
from repro_torch.train.train_loop import loss_and_grads

FAMILIES = ["olmoe_1b_7b", "qwen3_moe_235b_a22b", "zamba2_1_2b", "rwkv6_7b"]
B, S, PROMPT = 2, 20, 12
_O0 = {"xla_backend_optimization_level": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; torch's intra-op threads would
    compete with them, so this file runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _stable_reference_init():
    """The reference's ``init_params`` keys a leaf by ``hash`` of its path,
    which Python salts in every process: here by ``zlib.crc32`` of it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JNN, "hash", lambda s: zlib.crc32(s.encode()),
                   raising=False)
        yield


def _o0(fn, *args):
    """``fn(*args)`` under ``jax.jit``, compiled at LLVM optimisation level
    0."""
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    return jitted.lower(*args).compile(compiler_options=_O0)(*args)


def _close(got, want, frac, rtol=1e-4, what=""):
    """|got - want| <= rtol |want| + frac max|want|, entry by entry."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = rtol * np.abs(want) + frac * np.abs(want).max()
    err = np.abs(got - want)
    assert np.all(err <= bound), (f"{what}: {int((err > bound).sum())} of "
                                  f"{err.size} beyond, max {err.max():.3e}")


def _np(t):
    return t.detach().float().numpy()


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(x, np.float32))
            for p, x in leaves]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _cfgs(arch, **kw):
    """(reference, port) float32 smoke configs at two layers (zamba2 at
    four), remat off in the reference."""
    n = 4 if arch == "zamba2_1_2b" else 2
    jc = replace(JC.get_smoke_config(arch), n_layers=n, remat=False,
                 dtype="float32", **kw)
    tc = replace(TC.get_smoke_config(arch), n_layers=n, dtype="float32", **kw)
    return jc, tc


# -- the MoE FFN ---------------------------------------------------------------
def _kept(expert, e, cap):
    """The reference's kept mask, from its expert ids: an assignment is
    kept while fewer than ``cap`` earlier ones went to its expert."""
    seen, keep = np.zeros(e, np.int64), []
    for x in expert:
        keep.append(seen[x] < cap)
        seen[x] += 1
    return np.asarray(keep)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "qwen3_moe_235b_a22b"])
def test_moe_matches_reference(arch):
    """olmoe (gates as the softmax gives them) and qwen3 (renormalised) at
    capacity factor 0.5, where half of the assignments drop: routing,
    ids and kept masks equal; output, aux and gradients within bounds."""
    jc, tc = _cfgs(arch, capacity_factor=0.5)
    jm, tm = jc.moe_cfg(), tc.moe_cfg()
    assert tm == TMOE.MoEConfig(**vars(jm))
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, 24, jm.d_model)).astype(np.float32)
    specs = JMOE.moe_param_specs(jm)
    jp = _o0(lambda: jax_init(specs, seed=3))
    tp = {k: _t(v) for k, v in jp.items()}
    t = B * 24
    cap = TMOE.capacity(t, tm)
    assert cap == int(max(4, np.ceil(t * jm.n_per_token / jm.n_experts
                                     * jm.capacity_factor)))

    def ref(p, x):
        route = JMOE._route(x.reshape(t, -1), p["w_router"], jm)
        loss = lambda p, x: (lambda o, a: jnp.sum(o * o) + a)(  # noqa: E731
            *JMOE.moe(p, x, jm))
        return route, JMOE.moe(p, x, jm), jax.grad(loss, (0, 1))(p, x)

    (jg, je, jtok, jprobs), (jout, jaux), (jgp, jgx) = _o0(
        ref, jp, jnp.asarray(x))
    tg, te, ttok, tprobs = TMOE._route(_t(x).reshape(t, -1), tp["w_router"],
                                       tm)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _close(_np(tg), jg, 1e-6, what="gates")
    _close(_np(tprobs), jprobs, 1e-6, what="probs")
    keep = TMOE._slots(te, jm.n_experts, cap)[2].numpy()
    np.testing.assert_array_equal(keep, _kept(np.asarray(je),
                                              jm.n_experts, cap))
    assert 0.3 < keep.mean() < 0.9          # assignments do drop

    xt = _t(x).requires_grad_(True)
    for v in tp.values():
        v.requires_grad_(True)
    out, aux = TMOE.moe(tp, xt, tm)
    _close(_np(out), jout, 2e-5, what="out")
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5)
    (torch.sum(out * out) + aux).backward()
    _close(_np(xt.grad), jgx, 5e-5, what="d x")
    for k, g in jgp.items():
        _close(_np(tp[k].grad), g, 5e-5, what=f"d {k}")


# -- the chunked scans ---------------------------------------------------------
def _ssd_inputs(rng, b, s, h, p, n, a=None):
    xdt = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a = (-np.abs(rng.standard_normal((b, s, h))) * 0.3).astype(np.float32) \
        if a is None else np.full((b, s, h), a, np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    s0 = (rng.standard_normal((b, h, n, p)) * 0.5).astype(np.float32)
    return xdt, a, bm, cm, s0


def _wkv_inputs(rng, b, s, h, k, lw=None):
    r, kk, v = (rng.standard_normal((b, s, h, k)).astype(np.float32)
                for _ in range(3))
    lw = (-np.abs(rng.standard_normal((b, s, h, k))) * 0.5).astype(
        np.float32) if lw is None else np.full((b, s, h, k), lw, np.float32)
    u = rng.standard_normal((h, k)).astype(np.float32)
    s0 = (rng.standard_normal((b, h, k, k)) * 0.5).astype(np.float32)
    return r, kk, v, lw, u, s0


def test_chunked_scans_match_reference(monkeypatch):
    """``_ssd_chunked`` and ``_wkv_chunked`` at chunks that divide the
    sequence, leave a ragged last chunk, equal it and exceed it, from a
    non-zero initial state; the WKV scan also a chunk a block (its
    blocking of the intra-chunk term)."""
    rng = np.random.default_rng(0)
    ssd = _ssd_inputs(rng, 2, 37, 3, 4, 5)
    for chunk in (1, 4, 8, 37, 64):
        jy, js = _o0(lambda *a: JM._ssd_chunked(*a, chunk), *ssd)
        ty, ts = TM._ssd_chunked(*(_t(a) for a in ssd), chunk)
        _close(_np(ty), jy, 2e-5, what=f"ssd y, chunk {chunk}")
        _close(_np(ts), js, 2e-5, what=f"ssd state, chunk {chunk}")
    wkv = _wkv_inputs(rng, 2, 29, 2, 4)
    for chunk in (1, 4, 16, 29):
        jo, js = _o0(lambda *a: JR._wkv_chunked(*a, chunk), *wkv)
        for block in (TR.BLOCK_BYTES, 1):
            monkeypatch.setattr(TR, "BLOCK_BYTES", block)
            to, ts = TR._wkv_chunked(*(_t(a) for a in wkv), chunk)
            _close(_np(to), jo, 2e-5, what=f"wkv o, chunk {chunk}")
            _close(_np(ts), js, 2e-5, what=f"wkv state, chunk {chunk}")


def _ssd_naive(xdt, a, bm, cm, s0):
    st, ys = s0, []
    for t in range(xdt.shape[1]):
        st = torch.exp(a[:, t])[:, :, None, None] * st + torch.einsum(
            "bn,bhp->bhnp", bm[:, t], xdt[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", cm[:, t], st))
    return torch.stack(ys, 1), st


def _wkv_naive(r, k, v, lw, u, s0):
    st, os_ = s0, []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        os_.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                st + u[None, :, :, None] * kv))
        st = torch.exp(lw[:, t])[..., None] * st + kv
    return torch.stack(os_, 1), st


def test_strong_decay_gradients_are_finite():
    """At a strong decay (SSD: a = -10, a chunk of 32 steps; WKV: lw = -8,
    chunk 16) the reference's forward is finite but its gradients are not:
    it takes ``exp`` of the masked pairs' positive exponents (up to 310 and
    120), which overflow, and the backward multiplies the masked zero by
    inf (ROADMAP C). The port masks the exponent first: its forward equals
    the reference's, and its gradients are finite and agree with a float64
    step-by-step recurrence's."""
    for scan in ("ssd", "wkv"):
        rng = np.random.default_rng(0)
        if scan == "ssd":
            args = _ssd_inputs(rng, 1, 32, 2, 4, 3, a=-10.0)
            jfn, tfn, naive, chunk, da = JM._ssd_chunked, TM._ssd_chunked, \
                _ssd_naive, 64, 1
        else:
            args = _wkv_inputs(rng, 1, 32, 2, 4, lw=-8.0)
            jfn, tfn, naive, chunk, da = JR._wkv_chunked, TR._wkv_chunked, \
                _wkv_naive, 16, 3

        def ref(*a):
            out = jfn(*a, chunk)
            return out, jax.grad(lambda *b: jnp.sum(jfn(*b, chunk)[0]),
                                 argnums=da)(*a)

        (jo, js), jgrad = _o0(ref, *args)
        assert np.isfinite(np.asarray(jo)).all()
        assert not np.isfinite(np.asarray(jgrad)).all()   # the reference
        ta = [_t(a).requires_grad_(True) for a in args]
        to, ts = tfn(*ta, chunk)
        _close(_np(to), jo, 2e-5, what=f"{scan} forward")
        _close(_np(ts), js, 2e-5, what=f"{scan} state")
        grads = torch.autograd.grad(to.sum(), ta)
        assert all(bool(torch.isfinite(g).all()) for g in grads), scan
        # against float64: the decay's gradient is a difference of terms
        # as large as the other inputs' gradients (the cumulative sums'
        # backward), so every gradient is held within rtol 1e-4 plus 1e-6
        # of the largest entry of any of them (measured: at most 9.5e-8)
        wa = [_t(a).double().requires_grad_(True) for a in args]
        want = [w.numpy() for w in torch.autograd.grad(
            naive(*wa)[0].sum(), wa)]
        top = max(np.abs(w).max() for w in want)
        for i, (g, w) in enumerate(zip(grads, want)):
            err = np.abs(_np(g) - w)
            assert np.all(err <= 1e-4 * np.abs(w) + 1e-6 * top), \
                (scan, i, err.max())


def test_flash_attention_masks_padded_keys():
    """A KV length that ``chunk_kv`` does not divide is padded with keys at
    position -1e9, which the causal test ``q >= k`` keeps: the reference
    attends to them (zero keys, zero values: its softmax is diluted;
    ROADMAP C), the port masks them. Its attention over 40 keys in chunks
    of 32 equals one chunk of 64, the reference's does not; and a model
    whose prefill and forward pad (qwen2's and zamba2's smoke widths at
    S = 64 > chunk_kv 32, float32) decodes within 1e-5 of its forward
    (with the reference's mask, 2.6e-2 and 4.6e-2 away on one draw of
    tokens)."""
    rng = np.random.default_rng(5)
    jac = JC.get_smoke_config("qwen2_0_5b").attn_cfg(False)
    q, k, v = (rng.standard_normal((2, 40, n, 16)).astype(np.float32)
               for n in (4, 2, 2))
    pos = np.arange(40)
    outs = {}
    for ck in (32, 64):
        outs[ck] = (
            np.asarray(_o0(lambda q, k, v: JA.flash_attention(
                q, k, v, replace(jac, chunk_kv=ck), jnp.asarray(pos),
                jnp.asarray(pos)), q, k, v)),
            _np(TA.flash_attention(_t(q), _t(k), _t(v), TA.AttnConfig(
                **vars(replace(jac, chunk_kv=ck))), torch.from_numpy(pos),
                torch.from_numpy(pos))))
    _close(outs[32][1], outs[64][1], 1e-6, what="port, chunks of 32")
    _close(outs[64][1], outs[64][0], 2e-5, what="one chunk, both")
    assert np.abs(outs[32][0] - outs[64][0]).max() > 1e-2   # the reference
    for arch, kw in (("qwen2_0_5b", {}), ("zamba2_1_2b",
                                         {"shared_attn_every": 1})):
        cfg = replace(TC.get_smoke_config(arch), n_layers=2, dtype="float32",
                      **kw)
        p = init_params(TL.model_param_specs(cfg), seed=0, device="cpu")
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
        with torch.no_grad():
            _, cache = TL.prefill(p, tok[:, :-1], cfg, max_len=64)
            dec = TL.decode_step(p, cache, tok[:, -1:], 63, cfg)[0]
            full = TL.lm_logits(TL.forward(p, tok, cfg)[0][:, -1:], p, cfg)
        assert float((dec - full).abs().max() / full.abs().max()) < 1e-5, \
            arch


# -- each family through lm ----------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_matches_reference(arch):
    """forward, logits, the loss with aux, gradients (remat on in the
    port), a 12-token prefill into caches of 20 and 8 decode steps, every
    cache against the reference's, the last step against the full
    forward; then ``generate``, a train step and ``launch.train --smoke``
    in the port."""
    jc, tc = _cfgs(arch)
    specs = JL.model_param_specs(jc)
    jp = _o0(lambda: jax_init(specs, seed=0))
    tp = convert.lm_params_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                      device="cpu")
    tok = np.random.default_rng(1).integers(0, jc.vocab_size, (B, S)).astype(
        np.int32)

    def ref(p, t):
        h = JL.forward(p, t, jc)[0]
        (loss, metrics), grads = jax.value_and_grad(
            lambda q: JL.lm_loss(q, t, jc), has_aux=True)(p)
        return (h, JL.lm_logits(h, p, jc), loss, metrics, grads,
                JL.prefill(p, t[:, :PROMPT], jc, max_len=S))

    jh, jlog, jloss, jmet, jgrads, (jlast, jcache) = _o0(
        ref, jp, jnp.asarray(tok))
    tt = torch.from_numpy(tok)
    with torch.no_grad():
        h = TL.forward(tp, tt, tc)[0]
        logits = TL.lm_logits(h, tp, tc)
        last, cache = TL.prefill(tp, tt[:, :PROMPT], tc, max_len=S)
    _close(_np(h), jh, 2e-5, what="hidden")
    _close(_np(logits), jlog, 1e-5, what="logits")
    _close(_np(last), jlast, 1e-5, what="prefill")
    loss, metrics, grads = loss_and_grads(tp, tt, tc)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert sorted(metrics) == sorted(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(metrics[k]), float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    if tc.n_experts:
        assert float(metrics["aux"]) > 0
    want = dict(_flat(jgrads))
    got = [(p, _np(g)) for p, g in tree_items(grads)]
    assert [p for p, _ in got] == list(want)
    for p, g in got:
        _close(g, want[p], 5e-5, what=p)

    jdec = jax.jit(lambda p, c, t, pos: JL.decode_step(p, c, t, pos, jc)
                   ).lower(jp, jcache, jnp.asarray(tok[:, :1]),
                           jnp.int32(0)).compile(compiler_options=_O0)
    with torch.no_grad():
        for pos in range(PROMPT, S):
            t = tok[:, pos:pos + 1]
            jl, jcache = jdec(jp, jcache, jnp.asarray(t), jnp.int32(pos))
            tl, cache = TL.decode_step(tp, cache, torch.from_numpy(t), pos,
                                       tc)
            _close(_np(tl), jl, 1e-5, what=f"decode at {pos}")
    want = dict(_flat(jcache))
    got = tree_items(cache)
    assert [p for p, _ in got] == list(want)
    for p, c in got:
        _close(_np(c), want[p], 2e-5, what=p)
    err = np.abs(_np(tl) - _np(logits[:, -1:])).max()
    assert err / (np.abs(_np(logits[:, -1:])).max() + 1e-6) < 0.08

    out = generate(tp, tt[:, :8], tc, n_tokens=4)
    assert out.shape == (B, 12) and torch.equal(out[:, :8], tt[:, :8])
    from repro_torch.launch import train as launch
    from repro_torch.train import Trainer
    hist = launch.main(["--arch", arch, "--smoke", "--steps", "2", "--seq",
                        "16", "--batch", "2", "--device", "cpu"])
    assert len(hist) == 2 and all(np.isfinite(float(v))
                                  for m in hist for v in m.values())
    # no SIGTERM handler keeps the trainer, and with it its parameters and
    # optimizer state, alive after its run
    gc.collect()
    assert not [o for o in gc.get_objects() if type(o) is Trainer]
    if tc.n_experts:
        assert "aux" in hist[-1]


# -- init ----------------------------------------------------------------------
def test_expert_weights_take_the_contracted_fan_in():
    """The experts' ``w_gate``/``w_up`` [E, d, f] are drawn at sigma
    1/sqrt(d) and ``w_down`` [E, f, d] at 1/sqrt(f), as the reference's
    ``shape[-2]`` gives them (the experts are a stacking dim, as the
    layers are); at olmoe's full width d is 2048, f 1024, E 64. And the
    parameter counts phase 17 of ``chip_smoke.py`` checks are the
    reference's."""
    trunc = 0.8796            # std of a unit normal truncated at +-2
    full = TL.model_param_specs(TC.get_config("olmoe_1b_7b"))
    moe = full["blocks"]["p0"]["moe"]
    assert (moe["w_gate"].fan_in, moe["w_up"].fan_in, moe["w_down"].fan_in,
            moe["w_router"].fan_in) == (2048, 2048, 1024, 2048)
    cfg = replace(TC.get_smoke_config("olmoe_1b_7b"), moe_d_ff=256)
    p = init_params(TL.model_param_specs(cfg), seed=0,
                    device="cpu")["blocks"]["p0"]["moe"]
    for name, fan in (("w_gate", 64), ("w_up", 64), ("w_down", 256)):
        w = p[name].float()
        assert abs(float(w.std()) / (trunc / fan ** 0.5) - 1) < 0.05, name
        assert float(w.abs().max()) <= 2.0 / fan ** 0.5 + 1e-6, name
    for arch, n, want in (("olmoe_1b_7b", 16, 6_919_100_416),
                          ("olmoe_1b_7b", 4, 1_884_310_528),
                          ("qwen3_moe_235b_a22b", 2, 6_220_173_824),
                          ("zamba2_1_2b", 38, 1_057_589_376),
                          ("rwkv6_7b", 32, 7_534_546_944),
                          ("rwkv6_7b", 2, 974_229_504)):
        got = count_params(TL.model_param_specs(
            replace(TC.get_config(arch), n_layers=n)))
        assert got == want == jax_count(JL.model_param_specs(
            replace(JC.get_config(arch), n_layers=n))), arch
    assert all(not t.requires_grad for t in tree_leaves(p))
