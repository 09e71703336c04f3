"""Parameters as plain trees of tensors, declared by ``ParamSpec``s.

Counterpart of ``repro/models/nn.py``. A parameter tree is a nested dict
of tensors; a parallel tree of ``ParamSpec`` declares each leaf's shape,
dtype, init and logical axes. Trees flatten in JAX's order (dict keys
sorted), and a leaf's path is written as ``jax.tree_util.keystr`` writes
it (``"['blocks']['p0']['attn']['wq']"``), so that checkpoints and the
gradient compressor see the reference's leaves.

``init_params`` keys each leaf by ``prng.fold_in(PRNGKey(seed),
crc32(path))``: a stable digest, the same in every process and on every
device (the reference keys by Python's salted ``hash`` of the path, which
changes from process to process; ROADMAP C). A leaf's values are a pure
function of that key and the flat index (the port's threefry bits, one
uniform a value, then ``erfinv``), so the CPU and the card draw the same
weights but at the last ulp of ``torch.special.erfinv``. They are not
the reference's draws: parity tests carry weights across with
``convert.lm_params_from_numpy``. Sharded layouts (``param_shardings``)
are ROADMAP A.13.3.

``fan_in`` is the product of the dims a weight contracts, read from its
logical axes: the first dim of an [in, ...] weight, every dim but the
last of a [..., embed] one, stacking dims (``layers``, ``codebooks``,
``experts``) aside. For [in, out] matrices, stacked or not, that is the
reference's ``shape[-2]``: d_model for the experts' ``w_gate``/``w_up``
[E, d, f] and their hidden width for ``w_down`` [E, f, d]. For the
weights with a head dim it is d_model for wq/wk/wv (and Mamba2's and
RWKV6's [d, heads, head_dim] projections) and heads x head_dim for wo
and their ``w_out``, where the reference's ``shape[-2]`` takes the heads
or head_dim (ROADMAP C): its q and k are then 8x too large at
qwen2-0.5B, the attention an argmax, and decode against the full forward
ill-conditioned in depth.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device

__all__ = ["ParamSpec", "init_params", "abstract_params", "rms_norm",
           "count_params", "torch_dtype", "tree_leaves", "tree_map",
           "tree_items", "tree_unflatten"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}
_CHUNK = 1 << 24           # values drawn a pass (bounds the int32 temporaries)
_STACKED = ("layers", "codebooks", "experts")
_SQRT2 = math.sqrt(2.0)


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of a spec's dtype name (or a torch dtype)."""
    return name if isinstance(name, torch.dtype) else DTYPES[str(name)]


# -- trees ---------------------------------------------------------------------
def tree_items(tree, path: str = "") -> list:
    """[(keystr path, leaf)] in JAX's flattening order (dict keys sorted,
    lists and tuples in order); None is an empty subtree."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree)
                for x in tree_items(tree[key], f"{path}[{key!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, sub in enumerate(tree)
                for x in tree_items(sub, f"{path}[{i}]")]
    if tree is None:
        return []
    return [(path, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterable ``leaves``."""
    return _unflatten(like, iter(leaves))


def _unflatten(t, it):
    # a function of the module, not a closure that calls itself: such a
    # closure and its cell form a cycle that keeps the leaves alive until
    # the garbage collector next runs
    if isinstance(t, dict):
        return {k: _unflatten(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_unflatten(s, it) for s in t)
    return None if t is None else next(it)


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


# -- specs ---------------------------------------------------------------------
@dataclass(frozen=True)
class ParamSpec:
    """A leaf's shape, logical axes (one name or None a dim), dtype name,
    init (fan_in | normal | embed | zeros | ones) and scale."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: str = "bfloat16"
    init: str = "fan_in"
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    @property
    def fan_in(self) -> int:
        """The product of the dims the weight contracts (see the module's
        docstring); a vector's length."""
        dims = [(n, a) for n, a in zip(self.shape, self.axes)
                if a not in _STACKED]
        if len(dims) < 2:
            return self.shape[-1]
        if dims[-1][1] == "embed":
            return math.prod(n for n, _ in dims[:-1])
        return dims[0][0]

    def initialize(self, key: tuple, device=None) -> torch.Tensor:
        """The leaf drawn from ``key`` on ``device``: ``fan_in`` a normal
        truncated at +-2 sigma with sigma = scale / sqrt(fan_in),
        ``normal`` and ``embed`` a normal of standard deviation
        ``scale``."""
        dev = resolve_device(device)
        dt = torch_dtype(self.dtype)
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dt, device=dev)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dt, device=dev)
        if self.init in ("normal", "embed"):
            lo, hi, std = -1.0, 1.0, self.scale
        elif self.init == "fan_in":
            lo, hi = math.erf(-2.0 / _SQRT2), math.erf(2.0 / _SQRT2)
            std = self.scale / math.sqrt(max(self.fan_in, 1))
        else:
            raise ValueError(self.init)
        n = math.prod(self.shape)
        out = torch.empty(n, dtype=dt, device=dev)
        for a in range(0, n, _CHUNK):
            counts = torch.arange(a, min(a + _CHUNK, n), dtype=torch.int64,
                                  device=dev)
            # a uniform strictly inside (lo, hi): the bin midpoints of the
            # top 23 bits, so erfinv never meets +-1
            f = prng._unit_floats(prng.random_bits_of(key[0], key[1], counts))
            u = (f + 2.0 ** -24) * (hi - lo) + lo
            z = torch.special.erfinv(u) * _SQRT2
            if self.init == "fan_in":
                z = z.clamp(-2.0, 2.0)
            out[a:a + counts.numel()] = (z * std).to(dt)
        return out.reshape(self.shape)


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def _spec_items(specs) -> list:
    if _is_spec(specs):
        return [("", specs)]
    return tree_items(specs)


def init_params(specs, seed: int = 0, device=None):
    """The parameter tree of ``specs`` on ``device`` (the card by
    default): leaf ``path`` is drawn from ``fold_in(PRNGKey(seed),
    crc32(path) & 0x7FFFFFFF)``, the same in every process."""
    dev = resolve_device(device)
    root = prng.PRNGKey(seed)
    leaves = [spec.initialize(prng.fold_in(
        root, zlib.crc32(path.encode()) & 0x7FFFFFFF), dev)
        for path, spec in _spec_items(specs)]
    return tree_unflatten(specs, leaves)


def abstract_params(specs):
    """The tree of ``specs`` as tensors on the ``meta`` device (shapes
    and dtypes, no storage)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=torch_dtype(s.dtype),
                                          device="meta"), specs)


def count_params(specs) -> int:
    return sum(math.prod(s.shape) for _, s in _spec_items(specs))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm accumulated in float32, the result in ``x``'s dtype; the
    gemma family scales by (1 + w)."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    w = weight.to(torch.float32)
    if plus_one:
        w = 1.0 + w
    return (xf * w).to(x.dtype)
