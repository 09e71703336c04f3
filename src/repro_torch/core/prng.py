"""Threefry-2x32 counter-based generator, bit-compatible with ``jax.random``.

The canonical projection matrix R of ``repro`` is a pure function of the
seed: unit u is ``jax.random.normal(fold_in(PRNGKey(seed), u), shape)``.
This module rebuilds that function in integer PyTorch so the port draws
the same R without JAX. It follows JAX's default threefry2x32
implementation with ``jax_threefry_partitionable=True`` and 64-bit types
off:

* ``PRNGKey(seed)`` is the pair (0, seed mod 2^32);
* ``fold_in(key, d)`` hashes the count pair (0, d) under ``key``;
* ``random_bits`` hashes the 64-bit flat index of every element, split
  into (hi, lo) words, and XORs the two output words;
* ``uniform`` puts the top 23 bits into the mantissa of a float in
  [1, 2) and shifts it to the range; ``bernoulli`` is ``uniform < p``
  and ``rademacher`` ``2b - 1`` of it, in float32;
* ``normal`` is ``sqrt(2) * erfinv(max(lo, 2f + lo))`` with
  ``lo = nextafter(-1, 0)``;
* ``split(key, n)[i]`` hashes the count pair (0, i) under ``key``
  (JAX's fold-like split), so it equals ``fold_in(key, i)``;
  ``randint`` draws two words a value from the two keys of
  ``split(key)`` and reduces them modulo the span as JAX does;
  ``categorical`` is the argmax of Gumbel noise plus the logits, the
  noise ``-log(-log(u))`` of a ``uniform`` on [tiny, 1) with XLA's log;
* ``normal(..., dtype=torch.bfloat16)`` follows JAX's bf16 draw: its
  uniform takes one of 128 values from bits 1-7 of the same 32-bit bits
  (f = m/128, u = max(lo, 2f + lo) with lo = -255/256, exact in bf16),
  then erfinv in float32 rounded to bf16, times bf16(sqrt 2) rounded to
  bf16 (``bf16_normal_of_index``). Held to ``jax.random.normal(key,
  shape, bfloat16)`` bit for bit (``tests/test_torch_serve.py``).

The f32 ``erfinv`` is XLA's CPU lowering, term for term: Giles'
polynomial in ``w = -log1p(-x^2)`` with fused multiply-adds, where
``log1p`` is Cephes' rational form below sqrt(2)-1 and ``log(1+x)``
above, and ``log`` is the Cephes polynomial. A fused multiply-add is
computed in float64 and rounded once to float32. The normal draw depends
only on the 23 mantissa bits, so the agreement is checked on all 2^23
of them. ``torch.special.erfinv``, ``torch.log1p`` and the CPU's
vectorised float32 ``torch.sqrt`` each differ from XLA's on some inputs.

These are the plain versions: they run on the device of their inputs
(``device=`` for ``random_bits`` and ``normal``), the CPU tests use them,
and the sketch draws R with them on the CPU. On the card R's units come
from the CUDA kernel ``kernels/csrc/normal_unit.cu``, held bit for bit
to ``normal`` here.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["PRNGKey", "fold_in", "split", "threefry2x32", "threefry2x32_i32",
           "random_bits", "random_bits_of", "uniform", "bernoulli",
           "rademacher", "randint", "gumbel", "categorical", "normal",
           "normal_from_bits", "bf16_normal_of_index", "erfinv_xla",
           "log_xla", "log2_xla"]

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _M


def threefry2x32(k1: int, k2: int, x1, x2):
    """Threefry-2x32 (20 rounds) of count words x1, x2 (int64 tensors
    holding uint32 values, or Python ints) under key (k1, k2) -> two of
    the same holding uint32 values."""
    ks = (k1 & _M, k2 & _M, (k1 ^ k2 ^ 0x1BD11BDA) & _M)
    x1 = (x1 + ks[0]) & _M
    x2 = (x2 + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M
    return x1, x2


def _i32(v):
    """A uint32 value (int or int64 tensor) as the int32 of its bits."""
    if isinstance(v, torch.Tensor):
        return (v & _M).to(torch.int32) if v.dtype != torch.int32 else v
    v &= _M
    return v - (1 << 32) if v >= 1 << 31 else v


def threefry2x32_i32(k1, k2, x1, x2):
    """``threefry2x32`` in int32 arithmetic: keys and counts are int32
    tensors (or ints) holding uint32 bits, the sums wrap modulo 2^32 and
    a logical right shift is an arithmetic one masked. Bit-identical to
    the int64 form at less than half its memory traffic; the bulk draws
    (``random_bits_of``) use it."""
    k1, k2 = _i32(k1), _i32(k2)
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = _i32(x1) + ks[0]
    x2 = _i32(x2) + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = x1 + x2
            x2 = ((x2 << r) | ((x2 >> (32 - r)) & ((1 << r) - 1))) ^ x1
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + ks[(i + 2) % 3] + (i + 1)
    return x1, x2


def random_bits_of(k1, k2, counts: torch.Tensor) -> torch.Tensor:
    """The uint32 bits of flat indices ``counts`` (int64, below 2^32)
    under keys (k1, k2) (ints, or int64 tensors that broadcast against
    ``counts``, one key a row), as int32 bit patterns: what
    ``random_bits`` gives at those indices."""
    b1, b2 = threefry2x32_i32(k1, k2, 0, counts)
    return b1 ^ b2


def PRNGKey(seed: int) -> tuple:
    """Key of an integer seed, as ``jax.random.PRNGKey`` with 64-bit
    types off: (0, seed mod 2^32)."""
    return (0, int(seed) & _M)


def fold_in(key: tuple, data: int) -> tuple:
    """New key from ``key`` and a uint32 ``data``, as ``jax.random.fold_in``."""
    if not 0 <= int(data) <= _M:
        raise ValueError(f"fold_in data {data} out of bounds for uint32")
    # Python ints: one hash, no tensor ops (a sketch folds once a unit)
    return threefry2x32(key[0], key[1], 0, int(data))


def split(key: tuple, num: int = 2) -> list:
    """``num`` new keys, as ``jax.random.split`` (fold-like): key i
    hashes the count pair (0, i)."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def random_bits(key: tuple, shape, device=None) -> torch.Tensor:
    """uint32 bits (int64 tensor on ``device``, the CPU by default) of
    ``shape``, as ``jax.random.bits``."""
    n = math.prod(shape)
    counts = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], counts >> 32, counts & _M)
    return (b1 ^ b2).reshape(shape)


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """Floats in [0, 1) from the top 23 of uint32 ``bits`` (the mantissa
    of [1, 2) - 1)."""
    fb = ((bits >> 9) & 0x7FFFFF) | 0x3F800000   # int64 or int32 bits
    return fb.to(torch.int32).view(torch.float32) - 1.0


def _f32(v, like: torch.Tensor = None) -> torch.Tensor:
    """0-dim float32 constant, on ``like``'s device when given (made by a
    fill there, not copied from the host: no synchronisation)."""
    return torch.full((), float(np.float32(v)), dtype=torch.float32,
                      device=None if like is None else like.device)


def uniform(key: tuple, shape, minval: float = 0.0, maxval: float = 1.0,
            dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """float32 or bf16 in [minval, maxval) on ``device`` (the CPU by
    default), as ``jax.random.uniform`` (bf16: f = m/128 from bits 1-7,
    the bounds and their span rounded to bf16, f * span + lo rounded once
    to bf16; exact for the draw's and the offsets' bounds)."""
    bits = random_bits(key, shape, device)
    if dtype == torch.bfloat16:
        bf = torch.bfloat16
        lo = torch.full((), minval, dtype=bf, device=bits.device).float()
        span = (torch.full((), maxval, dtype=bf, device=bits.device).float()
                - lo).to(bf).float()
        f = ((bits >> 1) & 127).to(torch.float32) / 128
        return torch.maximum(lo, (f * span + lo).to(bf).float()).to(bf)
    if dtype != torch.float32:
        raise ValueError(f"uniform draws float32 or bfloat16, got {dtype}")
    lo, hi = _f32(minval, bits), _f32(maxval, bits)
    f = _unit_floats(bits)
    # XLA contracts f * (hi - lo) + lo into one fused multiply-add
    return torch.maximum(lo, _fma(f, (hi - lo).expand_as(f), lo.expand_as(f)))


def bernoulli(key: tuple, p: float = 0.5, shape=(),
              device=None) -> torch.Tensor:
    """bool draws on ``device`` (the CPU by default), as
    ``jax.random.bernoulli``: a float32 ``uniform`` below float32 ``p``."""
    u = uniform(key, shape, device=device)
    return u < _f32(p, u)


def rademacher(key: tuple, shape, dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
    """+-1 draws on ``device`` (the CPU by default), as
    ``jax.random.rademacher``: 2b - 1 of ``bernoulli(key, 0.5, shape)``."""
    return (2 * bernoulli(key, 0.5, shape, device).to(dtype) - 1).to(dtype)


def randint(key: tuple, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """int32 draws in [minval, maxval) on ``device``, as
    ``jax.random.randint`` with int32: a high and a low word from the
    keys of ``split(key)``, reduced modulo the span as (hi % span) *
    (2^32 % span) + lo % span, modulo the span again."""
    span = maxval - minval
    if not (-(1 << 31) <= minval and maxval <= (1 << 31) - 1 and
            0 < span <= _M):
        raise ValueError(f"randint needs int32 bounds with minval < maxval, "
                         f"got {minval}, {maxval}")
    k1, k2 = split(key)
    mult = ((((1 << 16) % span) ** 2) & _M) % span    # uint32 products wrap
    hi = random_bits(k1, shape, device) % span
    lo = random_bits(k2, shape, device) % span
    return (minval + ((hi * mult + lo) & _M) % span).to(torch.int32)


def gumbel(key: tuple, shape, device=None) -> torch.Tensor:
    """float32 Gumbel draws, as ``jax.random.gumbel`` (mode "low"):
    ``-log(-log(u))`` of a ``uniform`` on [tiny, 1), XLA's log twice."""
    u = uniform(key, shape, float(np.finfo(np.float32).tiny), 1.0,
                device=device)
    return -_log_xla(-_log_xla(u))


def categorical(key: tuple, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """int32 draws from softmax(``logits``) along ``axis``, as
    ``jax.random.categorical``: the first argmax of Gumbel noise of the
    logits' shape plus the float32 logits."""
    logits = logits.to(torch.float32)
    g = gumbel(key, tuple(logits.shape), logits.device)
    return torch.argmax(g + logits, dim=axis).to(torch.int32)


def _fma(a, b, c) -> torch.Tensor:
    """float32 fused multiply-add: exact product and sum in float64,
    one rounding to float32."""
    return (a.double() * b.double() + c.double()).float()


_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _log_xla(v: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 log (Cephes logf, FMA-contracted)."""
    v = torch.clamp(v, min=float(np.float32(1.17549435e-38)))
    bits = v.view(torch.int32)
    e = ((bits >> 23) - 0x7E).float()
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < _f32(0.707106781186547524, v)
    e = torch.where(small, e - 1.0, e)
    x = torch.where(small, m + m - 1.0, m - 1.0)
    x2 = x * x
    x3 = x2 * x
    c = [_f32(p, x).expand_as(x) for p in _LOG_P]
    y = _fma(_fma(c[0], x, c[1]), x, c[2])
    y1 = _fma(_fma(c[3], x, c[4]), x, c[5])
    y2 = _fma(_fma(c[6], x, c[7]), x, c[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _f32(-2.12194440e-4, x))
    x = x - x2 * _f32(0.5, x)
    x = x + y
    return x + e * _f32(0.693359375, x)


def log_xla(v: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 log (``jnp.log`` under the reference)."""
    return _log_xla(v)


def log2_xla(v: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 log2: its log times float32(1/ln 2), each
    rounded to float32 (not correctly rounded near powers of two)."""
    return _log_xla(v) * _f32(1.0 / math.log(2.0), v)


_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p: Cephes rational below sqrt(2)-1, else
    log(1 + x)."""
    def poly(coeffs):
        p = torch.zeros_like(x)
        for c in coeffs:
            p = _fma(p, x, _f32(c, x).expand_as(x))
        return p

    x2 = x * x
    small = _fma(_f32(-0.5, x).expand_as(x), x2,
                 (x * x2) * (poly(_LOG1P_NUM) / poly(_LOG1P_DEN)))
    small = x + small
    large = _log_xla(x + 1.0)
    return torch.where(x.abs() < _f32(0.41421356237309504880, x), small,
                       large)


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv (Giles' single-precision polynomial)."""
    w = -_log1p_xla(-x * x)
    lt = w < 5.0
    # float64 sqrt rounded once is the correctly rounded float32 sqrt, as
    # XLA's is; torch's vectorised float32 sqrt on the CPU is not
    ww = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LT5[0], x), _f32(_ERFINV_GE5[0], x))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, ww, torch.where(lt, _f32(a, x), _f32(b, x)))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 ``bits`` (int64 tensor) -> the standard normal float32 that
    ``jax.random.normal`` makes of them; a function of the top 23 bits."""
    lo = _f32(np.nextafter(np.float32(-1.0), np.float32(0.0)), bits)
    u = torch.maximum(lo, _unit_floats(bits) * (_f32(1.0, bits) - lo) + lo)
    return _f32(np.sqrt(2.0), bits) * erfinv_xla(u)


def bf16_normal_of_index(m: torch.Tensor) -> torch.Tensor:
    """The bf16 standard normal of JAX's bf16 draw for uniform index
    ``m`` in [0, 128) (any integer tensor): u = m/64 - 255/256 (exact in
    bf16), erfinv in float32 rounded to bf16, times bf16(sqrt 2), the
    exact float32 product rounded to bf16."""
    u = m.to(torch.float32) / 64.0 - 255.0 / 256.0
    e = erfinv_xla(u).to(torch.bfloat16).to(torch.float32)
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=torch.bfloat16,
                         device=m.device).to(torch.float32)
    return (e * sqrt2).to(torch.bfloat16)


def normal(key: tuple, shape, device=None,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard normal draws in ``dtype`` (float32 or bf16) on ``device``
    (the CPU by default), as ``jax.random.normal``."""
    bits = random_bits(key, shape, device)
    if dtype == torch.bfloat16:
        return bf16_normal_of_index((bits >> 1) & 127)
    if dtype != torch.float32:
        raise ValueError(f"normal draws float32 or bfloat16, got {dtype}")
    return normal_from_bits(bits)
