"""The GEMM kernels' arithmetic on the CPU: the TF32 split and 3xTF32.

The coded-projection kernels (``csrc/coded_gemm.cu``) run only on the
card. What they compute is held here: ``ref.tf32_split`` against an
exact model of ``cvt.rna.tf32.f32`` (round to 11 significant bits, ties
away from zero), ``split_r``'s operand layout, and the 3xTF32 product
(lo_x hi_r + hi_x lo_r + hi_x hi_r, lo_x lo_r dropped) emulated in
float64 and rounded to float32, against JAX's ``coded_project_ref`` and
``encode_fused_ref`` on the same seeded inputs. Codes may differ only
where JAX's projection lies within ``EDGE_TOL`` of a bin edge, the rule
the kernels are held to on the card.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schemes as jsch
from repro.kernels import ref as jref
from repro_torch.core import packing as tpk
from repro_torch.core import schemes as tsch
from repro_torch.kernels import ops, ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; torch's intra-op threads would
    compete with them, so this file runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EDGE_TOL = 1e-5
# Largest |z_3xtf32 - z_float64| allowed for unit rows and N(0, 1) R. Each
# term x_i r_i loses the dropped lo_x lo_r and the rounding of the two lo
# parts, at most 3 * 2^-22 of |x_i r_i| with a sign that varies from term
# to term, so the error on z has a spread of about 2^-22 * sqrt(sum of
# (x_i r_i)^2) = 2.4e-7 for unit rows; 2e-6 is 8 of those (and the
# float32 rounding of z, 2^-24 |z|, is smaller still).
MAX_Z_ERR = 2e-6
SCHEMES = [("sign", 1.0), ("2bit", 0.75), ("uniform", 0.75), ("offset", 1.0)]
# one compile per shape and scheme is cheaper than op-by-op dispatch
J_CODED = jax.jit(jref.coded_project_ref, static_argnums=2)
J_FUSED = jax.jit(jref.encode_fused_ref, static_argnums=2)
J_DOT = jax.jit(lambda x, r: jnp.dot(x, r, preferred_element_type=jnp.float32))


def _rna_tf32_exact(bits: int) -> int:
    """float32 bit pattern -> the bit pattern of the nearest TF32 value
    (8-bit exponent, 10-bit mantissa, subnormals kept), ties away from
    zero, by exact rational arithmetic; overflow gives infinity."""
    sign, mag = bits & 0x80000000, bits & 0x7FFFFFFF
    exp, man = mag >> 23, mag & 0x7FFFFF
    if exp == 0:
        value, ulp = Fraction(man, 1 << 149), Fraction(1, 1 << 136)
    else:
        value = Fraction((1 << 23) | man, 1 << 23) * Fraction(2) ** (exp - 127)
        ulp = Fraction(2) ** (exp - 127 - 10)
    n, rest = divmod(value, ulp)
    if rest * 2 >= ulp:
        n += 1
    out = np.float32(float(n * ulp)) if n * ulp < Fraction(2) ** 128 \
        else np.float32(np.inf)
    return sign | int(out.view(np.uint32))


def _patterns() -> np.ndarray:
    """Crafted float32 bit patterns: zeros, ties and their neighbours in
    the low 13 bits, carries into the exponent, subnormals, the largest
    finite value, both signs; then seeded random ones."""
    base = [0x00000000, 0x3F800000, 0x3F801000, 0x3F800FFF, 0x3F801001,
            0x3F803000, 0x3F802FFF, 0x3FFFF000, 0x3FFFEFFF, 0x3F7FF000,
            0x00000001, 0x00001000, 0x00000FFF, 0x00003000, 0x007FF000,
            0x007FFFFF, 0x00800000, 0x00801000, 0x7F7FE000, 0x7F7FEFFF,
            0x7F7FF000, 0x7F7FFFFF, 0x3EAAAAAB, 0x40490FDB]
    rng = np.random.default_rng(17)
    rand = rng.integers(0, 0x7F800000, size=2000, dtype=np.uint32)
    mags = np.concatenate([np.array(base, np.uint32), rand])
    return np.concatenate([mags, mags | np.uint32(0x80000000)])


def test_tf32_split_matches_cvt_rna():
    pats = _patterns()
    t = torch.from_numpy(pats.view(np.float32).copy())
    hi, lo = ref.tf32_split(t)
    want = np.array([_rna_tf32_exact(int(b)) for b in pats], np.uint32)
    got = hi.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    finite = np.isfinite(hi.numpy())
    # hi is TF32 (low 13 bits zero), t - hi exact, lo its TF32 rounding
    assert not np.any(got & 0x1FFF)
    rest = (t - hi).numpy()[finite]
    np.testing.assert_array_equal(
        rest.astype(np.float64),
        pats.view(np.float32)[finite].astype(np.float64)
        - hi.numpy()[finite].astype(np.float64))
    want_lo = np.array([_rna_tf32_exact(int(b))
                        for b in rest.view(np.uint32)], np.uint32)
    np.testing.assert_array_equal(lo.numpy()[finite].view(np.uint32), want_lo)
    # ties go away from zero, in both signs
    ties = np.array([0x3F801000, 0xBF801000], np.uint32).view(np.float32)
    tie_hi, _ = ref.tf32_split(torch.from_numpy(ties))
    assert tie_hi.tolist() == [1 + 2 ** -10, -(1 + 2 ** -10)]


def test_tf32_split_of_bf16_is_exact():
    t = torch.from_numpy(np.random.default_rng(3).standard_normal(
        4096).astype(np.float32)).to(torch.bfloat16)
    hi, lo = ref.tf32_split(t)
    assert torch.equal(hi, t.to(torch.float32))
    assert not bool(lo.any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [33, 96])
def test_split_r_layout(dtype, d):
    """split_r: R^T's planes [P, K, Dp], Dp = D up to a multiple of 4 with
    zero columns; P = 2 (hi, lo) for float32 R, 1 for bf16."""
    r = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (d, 17)).astype(np.float32)).to(dtype)
    got = ops.split_r(r)
    planes = 1 if dtype == torch.bfloat16 else 2
    assert got.shape == (planes, 17, -(-d // 4) * 4)
    assert got.dtype == torch.float32 and got.is_contiguous()
    hi, lo = ref.tf32_split(r)
    assert torch.equal(got[0, :, :d], hi.t())
    if planes == 2:
        assert torch.equal(got[1, :, :d], lo.t())
    assert not bool(got[:, :, d:].any())


def _emulate_3xtf32(x: np.ndarray, r: np.ndarray) -> np.ndarray:
    """z = lo_x hi_r + hi_x lo_r + hi_x hi_r, each product and their sum
    in float64, then rounded to float32 (the kernels' arithmetic, with
    exact accumulation)."""
    hx, lx = (t.numpy().astype(np.float64)
              for t in ref.tf32_split(torch.from_numpy(x)))
    hr, lr = (t.numpy().astype(np.float64)
              for t in ref.tf32_split(torch.from_numpy(r)))
    return (lx @ hr + hx @ lr + hx @ hr).astype(np.float32)


def _edge_distance(z, scheme, w, q):
    if scheme == "sign":
        return np.abs(z)
    if scheme == "2bit":
        return np.min(np.abs(z[None] - np.array([-w, 0.0, w])[:, None, None]),
                      axis=0)
    v = (z + q if scheme == "offset" else z) / w
    return np.abs(v - np.round(v)) * w


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("scheme,w", SCHEMES)
@pytest.mark.parametrize("m,d,k", [(129, 1024, 256), (7, 33, 17)])
def test_emulated_3xtf32_codes_match_jax(m, d, k, scheme, w, bf16, capsys):
    rng = np.random.default_rng(m * d + k)
    x = rng.standard_normal((m, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    r = rng.standard_normal((d, k)).astype(np.float32)
    if bf16:   # R as a bf16 sketch holds it, widened exactly
        r = torch.from_numpy(r).to(torch.bfloat16).to(torch.float32).numpy()
    q = rng.uniform(0, w, size=k).astype(np.float32)
    jspec, tspec = jsch.CodeSpec(scheme, w), tsch.CodeSpec(scheme, w)
    jr = jnp.asarray(r, dtype=jnp.bfloat16) if bf16 else jnp.asarray(r)
    want = np.asarray(J_CODED(jnp.asarray(x), jr, jspec, jnp.asarray(q)))
    want_w = np.array(J_FUSED(jnp.asarray(x), jr, jspec, jnp.asarray(q)))
    z_jax = np.asarray(J_DOT(jnp.asarray(x), jr))

    z = _emulate_3xtf32(x, r)
    err = float(np.abs(z.astype(np.float64)
                       - x.astype(np.float64) @ r.astype(np.float64)).max())
    with capsys.disabled():
        print(f"\n3xTF32 {m}x{d}x{k} {scheme} bf16={bf16}: max |z - z_f64| "
              f"= {err:.3e}")
    assert err < MAX_Z_ERR
    if bf16:   # one TF32 part of R: lo_r is zero, two products suffice
        hx, lx = (t.numpy().astype(np.float64)
                  for t in ref.tf32_split(torch.from_numpy(x)))
        two = ((lx @ r.astype(np.float64)) + hx @ r.astype(np.float64))
        np.testing.assert_array_equal(two.astype(np.float32), z)

    codes = tsch.encode(torch.from_numpy(z), tspec,
                        torch.from_numpy(q)).numpy()
    far = _edge_distance(z_jax, scheme, w, q) > EDGE_TOL
    assert not np.any((codes != want) & far)
    got_w = ref.pack_codes_ref(torch.from_numpy(codes), tspec.bits).numpy()
    assert got_w.shape == want_w.shape
    want_c = tpk.unpack_codes(torch.from_numpy(want_w.view(np.int32)),
                              tspec.bits, k).numpy()
    assert not np.any((codes != want_c) & far)
