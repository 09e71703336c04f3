"""Port parity for the dense LM path (``repro_torch.models``, ``configs``,
``optim``, ``data``, ``serve.serving``, ``train``, ``launch.train``).

Weights go across from the reference's ``init_params`` through
``convert.lm_params_from_numpy``, never by seed: the reference keys each
leaf by Python's salted ``hash`` of its path, which changes from process
to process (ROADMAP C). The reference runs under ``jax.jit`` at the smoke
configs, two layers where the pattern allows, float32 unless stated,
compiled at XLA's LLVM optimisation level 0 (``_o0``: a third to a sixth
of the compile time on one core; the arithmetic is the same but for the
fused multiply-adds, which the tolerances cover) but for the bit-exact
draws (``prng``, the pipeline) and ``generate``'s own jits, compiled as
the reference compiles them. qwen2's forward, loss, gradients and train
step come from one compile (``_qwen_ref``).

Tolerances, and why:
* configs, parameter specs, ``split``/``randint``/``categorical``, the
  token pipeline given its tables, and greedy and temperature-1 tokens:
  equal (integer or bit-level results of the same draws);
* float32 logits, hidden states and gradients: rtol 1e-4 plus an atol
  that is a fraction of the compared tensor's largest magnitude: 1e-5 for
  logits, 2e-5 for the final hidden states, 5e-5 of each gradient leaf.
  Both packages' float32 results lie about 3e-6 (logits) and up to 3.4e-5
  (gradients) of that magnitude from a float64 evaluation of the same
  model (measured on qwen2's smoke config), so an absolute 1e-5 on
  logits or 1e-6 on gradients fails on one or two of 10^4 entries near
  zero whichever package is nearer the exact value; the loss: relative
  1e-5 (float32 sums and XLA's fused multiply-adds in another order);
* bf16 logits: within 2e-2 of the largest logit, the reference's weights
  rescaled to the contracted fan-in (ROADMAP C). XLA keeps float32
  between the bf16 ops it fuses where torch rounds each op to bf16; with
  the reference's own fan-in the attention is an argmax that those
  roundings flip, and the packages lay 1.0-6.1 % apart over 24 draws
  (measured), against 0.7-1.3 % rescaled;
* decode against the full forward: the reference's own bound, error over
  scale below 0.08;
* AdamW, the schedule and a train step: rtol 1e-4 / 1e-6 (XLA contracts
  the moment updates into FMAs under ``jit``; the port multiplies, then
  adds);
* the compressed step: as the sharded tests hold the compressor, but at
  chunks whose codes a float32 rounding can flip (see the test).
"""
import dataclasses
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from repro import configs as JC
from repro.core.gradient_compression import (
    GradCompressionConfig as JaxGcCfg, GradCompressor as JaxGc)
from repro.data import DataConfig as JaxDataCfg
from repro.data import TokenPipeline as JaxPipeline
from repro.models import lm as JL
from repro.models.nn import ParamSpec as JaxSpec
from repro.models.nn import init_params as jax_init
from repro.optim import AdamWConfig as JaxAdamCfg
from repro.optim import adamw_update as jax_adamw
from repro.optim import init_opt_state as jax_opt_init
from repro.optim import schedule as jax_schedule
from repro.parallel.sharding import ShardingRules
from repro.serve import generate as jax_generate
from repro.train import make_compressed_train_step as jax_compressed_step
from repro.train import make_train_step as jax_train_step
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.checkpoint import latest_step
from repro_torch.core import prng
from repro_torch.core.gradient_compression import GradCompressionConfig
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import make_dp_mesh
from repro_torch.models import lm as TL
from repro_torch.models.nn import (count_params, init_params, tree_items,
                                   tree_leaves)
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state, \
    schedule
from repro_torch.serve import generate
from repro_torch.train import (Trainer, TrainState, make_compressed_train_step,
                               make_train_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE = ["qwen2_0_5b", "phi3_mini_3_8b", "gemma2_9b", "gemma3_27b",
         "chameleon_34b", "musicgen_medium"]
OTHER = ["olmoe_1b_7b", "qwen3_moe_235b_a22b", "zamba2_1_2b", "rwkv6_7b"]
# forward/loss parity: gemma2 and gemma3 at S = 20 > their smoke window of
# 8 (banded attention; gemma3's local rope base), chameleon (qk-norm, an
# untied head), musicgen (4 codebooks)
FORWARD = ["qwen2_0_5b", "gemma2_9b", "gemma3_27b", "chameleon_34b",
           "musicgen_medium"]
B, S = 2, 20


def _close(got, want, frac, rtol=1e-4, what=""):
    """|got - want| <= rtol |want| + frac max|want|, entry by entry."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = rtol * np.abs(want) + frac * np.abs(want).max()
    err = np.abs(got - want)
    assert np.all(err <= bound), (f"{what}: {int((err > bound).sum())} of "
                                  f"{err.size} beyond, max {err.max():.3e}")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; torch's intra-op threads would
    compete with them, so this file runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32", **kw):
    """(reference, port) smoke configs at two layers (gemma3's LLLLLG
    pattern then has no group: two L layers in the unscanned tail), remat
    off in the reference."""
    jc = replace(JC.get_smoke_config(arch), n_layers=2, remat=False,
                 dtype=dtype, **kw)
    tc = replace(TC.get_smoke_config(arch), n_layers=2, remat=False,
                 dtype=dtype, **kw)
    return jc, tc


def _tokens(cfg, seed=0, s=S, b=B):
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b, s)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


_O0 = {"xla_backend_optimization_level": 0}
_CACHE = {}


def _o0(fn, *args):
    """``fn(*args)`` under ``jax.jit`` (``fn`` jitted or not), compiled at
    LLVM optimisation level 0."""
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    return jitted.lower(*args).compile(compiler_options=_O0)(*args)


def _contracted_fan_in(tree, cfg):
    """The reference's weights rescaled from its fan-in (``shape[-2]``) to
    the contracted dims' (``ParamSpec.fan_in``; ROADMAP C): only the
    attention weights change."""
    specs = dict(tree_items(TL.model_param_specs(cfg)))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = []
    for path, a in leaves:
        spec = specs[jax.tree_util.keystr(path)]
        if spec.init == "fan_in":
            a = a * np.float32((spec.shape[-2] / spec.fan_in) ** 0.5)
        out.append(a)
    return jax.tree_util.tree_unflatten(treedef, out)


def _weights(arch, dtype="float32"):
    """(reference params, port params): the reference's ``init_params``
    carried across as numpy (bf16: its float32 draws at the contracted
    fan-in, cast)."""
    key = ("w", arch, dtype)
    if key not in _CACHE:
        jc, tc = _cfgs(arch, dtype)
        if dtype == "float32":
            specs = JL.model_param_specs(jc)
            jp = _o0(lambda: jax_init(specs, seed=0))
        else:
            jp = jax.tree.map(lambda a: a.astype(dtype), _contracted_fan_in(
                _weights(arch)[0], tc))
        _CACHE[key] = (jp, convert.lm_params_from_numpy(
            tc, jax.tree.map(np.asarray, jp), device="cpu"))
    return _CACHE[key]


def _qwen_opt():
    # eps 1 keeps Adam's first step smooth in the gradient: at 1e-8 it is
    # lr times the gradient's sign, which a rounding of a near-zero entry
    # (a key bias's, here) flips; the gradients are held on their own
    return _opt_pair(lr_peak=1e-3, warmup_steps=2, weight_decay=0.1, eps=1.0)


def _qwen_ref():
    """qwen2's reference results at one batch, from one compile: hidden
    states, logits, loss, loss and gradients, and one ``make_train_step``
    step (the reference's jitted step, inlined)."""
    if "qwen" not in _CACHE:
        jc, _ = _cfgs("qwen2_0_5b")
        jp, _ = _weights("qwen2_0_5b")
        jcfg, _ = _qwen_opt()
        jstep = jax_train_step(jc, jcfg, ShardingRules(None), donate=False)
        tok = _tokens(jc, seed=1)

        def ref(p, t):
            h = JL.forward(p, t, jc)[0]
            lg = jax.value_and_grad(lambda q: JL.lm_loss(q, t, jc)[0])(p)
            return (h, JL.lm_logits(h, p, jc), JL.lm_loss(p, t, jc)[0], lg,
                    jstep(p, jax_opt_init(p, jcfg), t))

        _CACHE["qwen"] = (tok, _o0(ref, jp, jnp.asarray(tok)))
    return _CACHE["qwen"]


def _np(t):
    return t.detach().float().numpy()


# -- configs and specs --------------------------------------------------------
@pytest.mark.parametrize("arch", JC.ARCHS)
def test_configs_match_reference(arch):
    assert TC.ARCHS == JC.ARCHS and TC.ALIASES == JC.ALIASES
    assert dataclasses.asdict(TC.get_config(arch)) == \
        dataclasses.asdict(JC.get_config(arch))
    assert dataclasses.asdict(TC.get_smoke_config(arch)) == \
        dataclasses.asdict(JC.get_smoke_config(arch))
    assert TC.shapes_for(arch) == JC.shapes_for(arch)


def _spec_rows(specs, is_leaf):
    leaves, _ = jax.tree_util.tree_flatten_with_path(specs, is_leaf=is_leaf)
    return [(jax.tree_util.keystr(p), s.shape, s.axes, s.dtype, s.init,
             s.scale) for p, s in leaves]


@pytest.mark.parametrize("arch", DENSE)
def test_param_specs_match_reference(arch):
    for full in (True, False):
        get = "get_config" if full else "get_smoke_config"
        want = _spec_rows(JL.model_param_specs(getattr(JC, get)(arch)),
                          lambda x: isinstance(x, JaxSpec))
        specs = TL.model_param_specs(getattr(TC, get)(arch))
        got = [(p, s.shape, s.axes, s.dtype, s.init, s.scale)
               for p, s in tree_items(specs)]
        assert got == want
    if arch == "qwen2_0_5b":
        assert count_params(TL.model_param_specs(TC.get_config(arch))) == \
            494_032_768


@pytest.mark.parametrize("arch", OTHER)
def test_other_families_raise(arch):
    cfg = TC.get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="A.13.2"):
        TL.model_param_specs(cfg)
    with pytest.raises(NotImplementedError, match="A.13.2"):
        TL.forward({}, torch.zeros((1, 4), dtype=torch.int32), cfg)


# -- forward, logits, loss, gradients -----------------------------------------
@pytest.mark.parametrize("arch", FORWARD)
def test_forward_logits_loss_match_reference(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _weights(arch)
    if arch == "qwen2_0_5b":
        tok, (jh, jlog, jloss, _, _) = _qwen_ref()
    else:
        tok = _tokens(jc)

        def ref(p, t):
            h = JL.forward(p, t, jc)[0]
            return h, JL.lm_logits(h, p, jc), JL.lm_loss(p, t, jc)[0]

        jh, jlog, jloss = _o0(ref, jp, jnp.asarray(tok))
    jh, jlog, jloss = (np.asarray(a) for a in (jh, jlog, jloss))
    with torch.no_grad():
        tt = torch.from_numpy(tok)
        h = TL.forward(tp, tt, tc)[0]
        logits = TL.lm_logits(h, tp, tc)
        loss = TL.lm_loss(tp, tt, tc)[0]
    _close(_np(h), jh, 2e-5, what="hidden")
    _close(_np(logits), jlog, 1e-5, what="logits")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_value_and_grad_matches_reference():
    """qwen2 with remat on in the port (each group, KV step and loss
    chunk recomputed in the backward pass)."""
    _, tc = _cfgs("qwen2_0_5b")
    _, tp = _weights("qwen2_0_5b")
    tok, (_, _, _, (jloss, jg), _) = _qwen_ref()
    from repro_torch.train.train_loop import loss_and_grads
    loss, _, g = loss_and_grads(tp, torch.from_numpy(tok),
                                replace(tc, remat=True))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = dict(_flat(jg))
    got = [(p, _np(x)) for p, x in tree_items(g)]
    assert [p for p, _ in got] == list(want)
    for p, x in got:
        _close(x, want[p], 5e-5, what=p)
    assert all(not t.requires_grad for t in tree_leaves(tp))


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(x, np.float32))
            for p, x in leaves]


def test_bf16_logits_match_reference():
    jc, tc = _cfgs("qwen2_0_5b", "bfloat16")
    jp, tp = _weights("qwen2_0_5b", "bfloat16")
    assert tree_leaves(tp)[0].dtype == torch.bfloat16
    tok = _tokens(jc, seed=2)
    want = np.asarray(_o0(lambda p, t: JL.lm_logits(
        JL.forward(p, t, jc)[0], p, jc), jp, jnp.asarray(tok)))
    with torch.no_grad():
        got = _np(TL.lm_logits(TL.forward(tp, torch.from_numpy(tok), tc)[0],
                               tp, tc))
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


# -- prefill, decode, generate ------------------------------------------------
def test_prefill_and_decode_match_reference():
    """gemma2 (LG, window 8): a 12-token prompt prefilled into caches of
    24, then 10 decode steps, the L layer's ring wrapping past its window;
    logits and every cache against the reference's, and the last step
    against the full forward (the reference's own bound)."""
    jc, tc = _cfgs("gemma2_9b")
    jp, tp = _weights("gemma2_9b")
    seq = _tokens(jc, seed=3, s=22)
    s0, max_len = 12, 24
    jlog, jcache = _o0(lambda p, t: JL.prefill(p, t, jc, max_len=max_len),
                       jp, jnp.asarray(seq[:, :s0]))
    jdec = jax.jit(lambda p, c, t, pos: JL.decode_step(p, c, t, pos, jc)).lower(
        jp, jcache, jnp.asarray(seq[:, :1]), jnp.int32(0)).compile(
            compiler_options=_O0)
    with torch.no_grad():
        tlog, tcache = TL.prefill(tp, torch.from_numpy(seq[:, :s0]), tc,
                                  max_len=max_len)
        assert tcache["groups"]["p0"]["kv"]["k"].shape[2] == 8   # the ring
        _close(_np(tlog), np.asarray(jlog), 1e-5, what="prefill")
        for pos in range(s0, seq.shape[1]):
            t = seq[:, pos:pos + 1]
            jlog, jcache = jdec(jp, jcache, jnp.asarray(t), jnp.int32(pos))
            tlog, tcache = TL.decode_step(tp, tcache, torch.from_numpy(t),
                                          pos, tc)
            _close(_np(tlog), np.asarray(jlog), 1e-5, what=f"pos {pos}")
        want = dict(_flat(jcache))
        for p, x in tree_items(tcache):
            _close(_np(x), want[p], 2e-5, what=p)
        full = TL.lm_logits(TL.forward(tp, torch.from_numpy(seq), tc)[0][:, -1:],
                            tp, tc)
    err = np.abs(_np(tlog) - _np(full)).max()
    assert err / (np.abs(_np(full)).max() + 1e-6) < 0.08


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_generate_matches_reference(temperature):
    jc, tc = _cfgs("qwen2_0_5b")
    jp, tp = _weights("qwen2_0_5b")
    prompt = _tokens(jc, seed=4, s=8)
    want = np.asarray(jax_generate(jp, jnp.asarray(prompt), jc, n_tokens=6,
                                   temperature=temperature, seed=0))
    got = generate(tp, torch.from_numpy(prompt), tc, n_tokens=6,
                   temperature=temperature, seed=0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# -- AdamW, the schedule, the pipeline ----------------------------------------
def _opt_pair(**kw):
    return JaxAdamCfg(**kw), AdamWConfig(**kw)


def test_adamw_update_matches_reference():
    """Two steps with clipping active and the master copy, over a bf16
    and a float32 leaf."""
    jcfg, tcfg = _opt_pair(lr_peak=1e-2, warmup_steps=1, decay_steps=10,
                           clip_norm=0.5)
    rng = np.random.default_rng(5)
    p0 = {"a": rng.standard_normal((6, 5)).astype(np.float32),
          "b": rng.standard_normal((7,)).astype(np.float32)}
    grads = [{"a": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal((7,)).astype(np.float32)}
             for _ in range(2)]
    jparams = {"a": jnp.asarray(p0["a"], jnp.bfloat16),
               "b": jnp.asarray(p0["b"])}
    tparams = {"a": torch.from_numpy(p0["a"]).bfloat16(),
               "b": torch.from_numpy(p0["b"].copy())}
    jstate, tstate = jax_opt_init(jparams, jcfg), init_opt_state(tparams, tcfg)
    upd = jax.jit(lambda p, g, s: jax_adamw(p, g, s, jcfg))
    for g in grads:
        jparams, jstate, jm = upd(jparams, {"a": jnp.asarray(g["a"],
                                                            jnp.bfloat16),
                                            "b": jnp.asarray(g["b"])},
                                  jstate)
        tparams, tstate, tm = adamw_update(
            tparams, {"a": torch.from_numpy(g["a"]).bfloat16(),
                      "b": torch.from_numpy(g["b"])}, tstate, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(tstate["step"]) == 2 and tstate["step"].device.type == "cpu"
    for name in ("m", "v", "master"):
        for k in ("a", "b"):
            np.testing.assert_allclose(_np(tstate[name][k]),
                                       np.asarray(jstate[name][k]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name}/{k}")
    for k in ("a", "b"):
        np.testing.assert_allclose(_np(tparams[k]),
                                   np.asarray(jparams[k], np.float32),
                                   rtol=1e-2 if k == "a" else 1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 9, 10, 11, 55, 99, 100, 101, 200])
def test_schedule_matches_reference(step):
    jcfg, tcfg = _opt_pair(warmup_steps=10, decay_steps=100)
    want = float(jax_schedule(jcfg, jnp.asarray(step, jnp.int32)))
    np.testing.assert_allclose(float(schedule(tcfg, step)), want, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 77])
def test_split_randint_categorical_bit_exact(seed):
    key = jax.random.PRNGKey(seed)
    assert [tuple(int(w) for w in k) for k in
            np.asarray(jax.random.split(key, 4))] == \
        prng.split(prng.PRNGKey(seed), 4)
    for shape, lo, hi in (((), 0, 32), ((5,), 0, 32), ((3, 4), -7, 70_000)):
        np.testing.assert_array_equal(
            prng.randint(prng.PRNGKey(seed), shape, lo, hi).numpy(),
            np.asarray(jax.random.randint(key, shape, lo, hi)))
    logits = np.random.default_rng(seed).standard_normal(
        (4, 3, 50)).astype(np.float32) * 3
    np.testing.assert_array_equal(
        prng.categorical(prng.PRNGKey(seed), torch.from_numpy(logits)).numpy(),
        np.asarray(jax.random.categorical(key, jnp.asarray(logits))))


@pytest.mark.parametrize("n_codebooks", [1, 4])
def test_pipeline_bit_exact_given_tables(n_codebooks):
    kw = dict(vocab_size=64, seq_len=16, global_batch=3,
              n_codebooks=n_codebooks)
    jpipe = JaxPipeline(JaxDataCfg(**kw))
    tpipe_ = convert.token_pipeline_from_numpy(
        DataConfig(**kw), np.asarray(jpipe._trans),
        np.asarray(jpipe._emit_logits), device="cpu")
    batch_at = jax.jit(jpipe.batch_at).lower(jnp.int32(0)).compile(
        compiler_options=_O0)                # one compile for both steps
    for step in (0, 5):
        got = tpipe_.batch_at(step)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(batch_at(jnp.int32(step))))
    # the port's own tables: the emission table is the reference's draw,
    # the transition rows are numpy's Dirichlet draw (ROADMAP C)
    own = TokenPipeline(DataConfig(**kw), device="cpu")
    np.testing.assert_array_equal(own.emit_logits.numpy(),
                                  np.asarray(jpipe._emit_logits))
    np.testing.assert_allclose(own.trans.sum(-1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(own.batch_at(3).numpy(),
                                  own.batch_at(3).numpy())


def test_pipeline_emission_is_the_full_argmax(monkeypatch):
    """The emission's candidates-then-exact argmax equals the argmax over
    the whole vocabulary of XLA-log Gumbel noise plus the logits (V =
    3,000, far past the candidates); with a margin no estimate can meet,
    the device check fails the call."""
    cfg = DataConfig(vocab_size=3000, seq_len=5, global_batch=2, seed=9)
    pipe = TokenPipeline(cfg, device="cpu")
    k1 = torch.tensor([3, 2 ** 32 - 5, 77])
    k2 = torch.tensor([11, 9, 2 ** 31 + 1])
    states = torch.tensor([[0], [5], [31]])
    got = pipe._emit(k1, k2, states)
    for r in range(3):
        noise = prng.gumbel((int(k1[r]), int(k2[r])), (1, 3000))
        want = torch.argmax(noise + pipe.emit_logits[states[r]], dim=-1)
        assert int(got[r, 0]) == int(want[0])
    monkeypatch.setattr(tpipe, "_EPS", 1e9)
    with pytest.raises(RuntimeError):
        pipe._emit(k1, k2, states)


# -- train steps and the trainer ----------------------------------------------
def test_train_step_matches_reference():
    _, tc = _cfgs("qwen2_0_5b")
    tp = _copy(_weights("qwen2_0_5b")[1])
    _, tcfg = _qwen_opt()
    tok, (_, _, _, _, (jnew, jopt, jm)) = _qwen_ref()
    step = make_train_step(tc, tcfg)
    new, opt, m = step(tp, init_opt_state(tp, tcfg), torch.from_numpy(tok))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    want = dict(_flat(jnew))
    for p, x in tree_items(new):
        np.testing.assert_allclose(_np(x), want[p], rtol=1e-4, atol=1e-6,
                                   err_msg=p)


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.clone()


@pytest.fixture(scope="module")
def gloo_mesh(tmp_path_factory):
    """A world-size-1 gloo group on a FileStore and its CPU mesh."""
    path = str(tmp_path_factory.mktemp("gloo") / "store")
    dist.init_process_group("gloo", store=dist.FileStore(path, 1), rank=0,
                            world_size=1)
    try:
        yield make_dp_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def _codes_may_differ(comp, grads, ref_flat, tol=1e-4):
    """Which of ``comp``'s chunks the two packages may code differently at
    step 0: those where the codes of the port's gradient ``grads`` and of
    the reference's (``ref_flat``, its leaves flattened) differ, or where
    either lies within ``tol`` of a bin edge (the reference's step compiles
    its own gradient). Returns the chunks and each differing code's
    distance from an edge."""
    from repro_torch.core import schemes

    def rotated(vec):
        blocks = vec.reshape(comp.n_chunks, comp.cfg.chunk)
        scales = torch.linalg.vector_norm(blocks, dim=1) + 1e-12
        return (blocks * comp._signs(0) / scales[:, None]) @ comp._r \
            * comp.cfg.chunk ** 0.5

    zp = rotated(comp._flatten(grads))
    zr = rotated(torch.nn.functional.pad(torch.from_numpy(ref_flat),
                                         (0, comp.padded - comp.total)))
    w = comp.cfg.w

    def edge(z):
        return torch.stack([(z + w).abs(), z.abs(), (z - w).abs()]).amin(0)

    differ = schemes.encode(zp, comp.cfg.spec) != \
        schemes.encode(zr, comp.cfg.spec)
    near = torch.minimum(edge(zp), edge(zr)) < tol
    return (differ | near).any(dim=1).numpy(), edge(zr)[differ].numpy()


def test_compressed_train_step_matches_reference(gloo_mesh):
    """One step through the coded-gradient sync at world size 1 (2-bit,
    rate 4, chunk 256), the compressor's R carried across; Adam's eps at
    1 keeps the first step smooth in the gradient (at 1e-8 it is the
    gradient's sign, which a rounding of a near-zero entry flips). The
    packages' gradients differ by float32 rounding (the reference step's
    own is its EF state plus its decoded gradient), so a rotated value near
    a bin edge may code differently: the chunks whose codes of the two
    gradients differ (each such code within 0.05 of an edge) or lie within
    1e-4 of one, a few per cent, are left out. Elsewhere the decoded
    gradient moves with its chunk's norm: the first moment is held within
    twice the chunk's relative gradient difference plus 1e-5 (and 1e-6 of
    the chunk's largest entry), and the EF state and the parameters within
    what that and the gradient's own difference allow."""
    jc, tc = _cfgs("qwen2_0_5b")
    jp, tp = _weights("qwen2_0_5b")
    tp = _copy(tp)
    jcfg, tcfg = _opt_pair(lr_peak=1e-2, warmup_steps=1, eps=1.0,
                           clip_norm=None)   # m is then (1 - b1) g
    gc = dict(scheme="2bit", rate=4, chunk=256)
    jcomp = JaxGc(JaxGcCfg(**gc), jp)
    tcomp = convert.grad_compressor_from_numpy(
        GradCompressionConfig(**gc), tp, jcomp._r_np, device="cpu")
    tok = _tokens(jc, seed=7, b=4)
    jstep = jax_compressed_step(jc, jcfg, Mesh(np.asarray(jax.devices()[:1]),
                                               ("data",)), jcomp)
    # the reference's step donates its arguments, and a float32 master
    # copy is the parameters' own buffer: hand it fresh copies
    own = jax.tree.map(jnp.copy, jp)
    jopt0 = jax_opt_init(own, jcfg)
    jopt0["master"] = jax.tree.map(jnp.copy, jopt0["master"])
    jnew, jopt, jef, jm = _o0(jstep, own, jopt0, jcomp.init_ef(jp),
                              jnp.asarray(tok))
    step = make_compressed_train_step(tc, tcfg, gloo_mesh, tcomp)
    new, opt, ef, m = step(tp, init_opt_state(tp, tcfg), tcomp.init_ef(tp),
                           torch.from_numpy(tok))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    from repro_torch.train.train_loop import loss_and_grads
    g_port = loss_and_grads(_weights("qwen2_0_5b")[1], torch.from_numpy(tok),
                            tc)[2]
    # the reference step's own gradient: its EF state plus its decoded
    # gradient (its first moment over 1 - b1)
    g_ref = np.concatenate([a.ravel() for _, a in _flat(jef)]) + \
        np.concatenate([a.ravel() for _, a in _flat(jopt["m"])]) / \
        np.float32(1 - jcfg.b1)
    out, edge = _codes_may_differ(tcomp, g_port, g_ref)
    assert out.mean() < 0.1 and np.all(edge < 0.05), (out.mean(), edge)
    keep = ~np.repeat(out, tcomp.cfg.chunk)[:tcomp.total]
    # where the codes agree, the decoded gradient moves with its chunk's
    # norm: allow each entry twice its chunk's measured relative gradient
    # difference plus 1e-5 of itself...
    dg = (tcomp._flatten(g_port).numpy() - np.pad(
        g_ref, (0, tcomp.padded - tcomp.total))).reshape(tcomp.n_chunks, -1)
    rel = np.linalg.norm(dg, axis=1) / (np.linalg.norm(np.pad(
        g_ref, (0, tcomp.padded - tcomp.total)).reshape(
            tcomp.n_chunks, -1), axis=1) + 1e-30)
    rel = np.repeat(2 * rel + 1e-5, tcomp.cfg.chunk)[:tcomp.total]
    flat = {name: (np.concatenate([_np(x).ravel() for x in tree_leaves(a)]),
                   np.concatenate([w.ravel() for _, w in _flat(b)]))
            for name, a, b in (("m", opt["m"], jopt["m"]), ("ef", ef, jef),
                               ("params", new, jnew))}
    m_p, m_r = flat["m"]
    # ... plus 1e-6 of the chunk's largest entry (the decode's float32
    # sums of products in another order)
    top = np.abs(np.pad(m_r, (0, tcomp.padded - tcomp.total))).reshape(
        tcomp.n_chunks, -1).max(axis=1)
    m_bound = rel * np.abs(m_r) + 1e-6 * np.repeat(
        top, tcomp.cfg.chunk)[:tcomp.total]
    lr = float(jm["lr"])
    for name, bound in (
            ("m", m_bound),
            # EF = gradient - decoded (10 m at the first step)
            ("ef", 2 * np.abs(g_ref - tcomp._flatten(g_port).numpy()[
                :tcomp.total]) + 10 * m_bound + 1e-7),
            # with eps 1 the first step moves a parameter by lr m_hat
            ("params", 10 * lr * m_bound + 1e-6 * np.abs(flat["params"][1]))):
        got, want = flat[name]
        err = np.abs(got - want)[keep]
        assert np.all(err <= bound[keep]), (
            name, int((err > bound[keep]).sum()), float(err.max()))
    plain = make_compressed_train_step(tc, tcfg, gloo_mesh, None)
    tp2 = _copy(_weights("qwen2_0_5b")[1])
    _, _, ef2, m2 = plain(tp2, init_opt_state(tp2, tcfg), None,
                          torch.from_numpy(tok))
    assert ef2 is None and float(m2["loss"]) == float(m["loss"])


def _tiny():
    return replace(TC.get_smoke_config("qwen2_0_5b"), n_layers=2,
                   dtype="float32", loss_chunk=8)


def _trainer(cfg, tcfg, ckpt_dir=None, log_fn=None, **kw):
    params = init_params(TL.model_param_specs(cfg), seed=3, device="cpu")
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    global_batch=2), device="cpu")
    return Trainer(make_train_step(cfg, tcfg),
                   TrainState(params, init_opt_state(params, tcfg)), pipe,
                   ckpt_dir=ckpt_dir, log_fn=log_fn or (lambda *a: None),
                   **kw)


def test_trainer_resume_equals_uninterrupted(tmp_path):
    cfg, tcfg = _tiny(), AdamWConfig(lr_peak=3e-3, warmup_steps=2)
    whole = _trainer(cfg, tcfg)
    whole.run(4)
    first = _trainer(cfg, tcfg, ckpt_dir=str(tmp_path), ckpt_every=2)
    first.run(2)
    assert latest_step(str(tmp_path)) == 2
    second = _trainer(cfg, tcfg, ckpt_dir=str(tmp_path), ckpt_every=2)
    second.maybe_resume()
    assert second.state.step == 2
    assert second.state.opt_state["step"].device.type == "cpu"
    second.run(4)
    for (p, a), (_, b) in zip(tree_items(whole.state.params),
                              tree_items(second.state.params)):
        assert torch.equal(a, b), p
    for a, b in zip(tree_leaves(whole.state.opt_state),
                    tree_leaves(second.state.opt_state)):
        assert torch.equal(a, b)


class _Probe:
    """A metric that counts its conversions to float."""
    reads = 0

    def __float__(self):
        _Probe.reads += 1
        return 1.0


def test_trainer_reads_the_host_only_to_log():
    """The trainer converts metrics to floats only on the steps it logs
    (loss and grad_norm, every ``log_every``); its history keeps the
    step's values as they came."""
    lines = []

    def step_fn(params, opt, tokens):
        return params, opt, {"loss": _Probe(), "grad_norm": _Probe()}

    tr = Trainer(step_fn, TrainState({}, {}), TokenPipeline(
        DataConfig(vocab_size=16, seq_len=4, global_batch=1), device="cpu"),
        log_every=3, log_fn=lines.append)
    _Probe.reads = 0
    hist = tr.run(7)
    assert len(hist) == 7 and all(isinstance(m["loss"], _Probe) for m in hist)
    assert len(lines) == 2 and _Probe.reads == 4


def test_init_params_is_stable_across_processes():
    """The port keys each leaf by crc32 of its path: a child process with
    another ``PYTHONHASHSEED`` draws the same weights as this one (the
    reference's ``hash`` does not; ROADMAP C)."""
    code = ("import hashlib, torch\n"
            "from repro_torch import configs as C\n"
            "from repro_torch.models import lm as L\n"
            "from repro_torch.models.nn import init_params, tree_items\n"
            "p = init_params(L.model_param_specs(C.get_smoke_config("
            "'gemma2_9b')), seed=5, device='cpu')\n"
            "h = hashlib.sha256()\n"
            "for k, v in tree_items(p):\n"
            "    h.update(k.encode()); h.update(v.float().numpy().tobytes())\n"
            "print(h.hexdigest())\n")
    mine = os.environ.get("PYTHONHASHSEED", "random")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PYTHONHASHSEED="2" if mine == "1" else "1")
    child = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, check=True,
                           timeout=120).stdout
    p = init_params(TL.model_param_specs(TC.get_smoke_config("gemma2_9b")),
                    seed=5, device="cpu")
    import hashlib
    h = hashlib.sha256()
    for k, v in tree_items(p):
        h.update(k.encode())
        h.update(v.float().numpy().tobytes())
    assert child.strip() == h.hexdigest()
    w = p["blocks"]["p0"]["ffn"]["w_up"].float()
    assert w.abs().max() <= 2.0 * 64 ** -0.5 + 1e-6           # +-2 sigma
    assert 0.8 < float(w.std() * 64 ** 0.5) / 0.88 < 1.2      # truncated
    assert torch.equal(p["ln_f"], torch.zeros(64, dtype=torch.bfloat16))


def test_attention_init_takes_the_contracted_fan_in():
    """The port's fan-in is the product of the dims a weight contracts:
    d_model for wq/wk/wv, heads x head_dim for wo, as shape[-2] for the
    [in, out] matrices. The reference takes shape[-2] for every weight, so
    its wq's sigma is 1/sqrt(heads) (ROADMAP C): at the smoke config
    (d_model 64, 4 heads, 2 KV heads, head_dim 16) its q weights are 4x,
    its k and v weights 5.7x and its wo 2x the port's."""
    trunc = 0.8796            # std of a unit normal truncated at +-2
    specs = TL.model_param_specs(TC.get_smoke_config("qwen2_0_5b"))
    attn = specs["blocks"]["p0"]["attn"]
    assert (attn["wq"].fan_in, attn["wk"].fan_in, attn["wo"].fan_in) == \
        (64, 64, 64)
    assert specs["blocks"]["p0"]["ffn"]["w_down"].fan_in == 128
    p = init_params(specs, seed=0, device="cpu")["blocks"]["p0"]["attn"]
    jp = _weights("qwen2_0_5b")[0]["blocks"]["p0"]["attn"]
    for name, mine, ref in (("wq", 64, 4), ("wk", 64, 2), ("wo", 64, 16)):
        got = float(p[name].float().std())
        want = float(np.asarray(jp[name]).std())
        assert abs(got / (trunc / mine ** 0.5) - 1) < 0.1, name
        assert abs(want / (trunc / ref ** 0.5) - 1) < 0.15, name


@pytest.mark.parametrize("make", [
    lambda: init_params(TL.model_param_specs(TC.get_smoke_config(
        "qwen2_0_5b"))),
    lambda: TokenPipeline(DataConfig(vocab_size=16, seq_len=4)),
    lambda: convert.lm_params_from_numpy(
        TC.get_smoke_config("qwen2_0_5b"), {}),
], ids=["init-params", "token-pipeline", "lm-params-numpy"])
def test_lm_entry_points_need_the_card_unless_asked(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


def test_launch_train_runs_and_refuses_meshes(tmp_path):
    from repro_torch.launch import train as launch
    hist = launch.main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "2",
                        "--seq", "16", "--batch", "2", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path)])
    assert len(hist) == 2 and np.isfinite(float(hist[-1]["loss"]))
    assert latest_step(str(tmp_path)) == 2
    with pytest.raises(NotImplementedError, match="A.13.3"):
        launch.main(["--arch", "qwen2-0.5b", "--mesh", "single"])
