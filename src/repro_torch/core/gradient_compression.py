"""Coded-sketch gradient compression for data-parallel training.

Counterpart of ``repro/core/gradient_compression.py``: instead of
all-reducing float32 gradients, each data-parallel rank

1. adds its error-feedback residual (EF-SGD),
2. splits the flat gradient into ``chunk``-sized blocks, flips their
   signs by a per-step Rademacher vector and rotates each unit block into
   a column-orthonormal basis R [chunk, k] (k = chunk / rate, from the
   seed: the first k columns of the QR factor of a Gaussian
   [chunk, chunk]), scaled by sqrt(chunk) so that its coordinates are
   about N(0, 1),
3. codes each rotated value with one of the paper's schemes,
4. all-gathers the packed codes and the per-block scales over the mesh's
   data dim,
5. decodes each code to the N(0, 1) conditional mean of its cell,
   averages over ranks and back-projects.

The gradient is a nested dict, list or tuple of tensors (dict leaves in
sorted key order, as JAX flattens them). R is drawn with the port's
threefry generator (bit-identical to ``jax.random.normal``) and factored
by ``torch.linalg.qr`` once, at construction, on the compressor's device;
the QR itself is LAPACK's on the CPU and cuSOLVER's on the card, so R
agrees with the reference's only to rounding (``convert.
grad_compressor_from_numpy`` carries the reference's R across). The
rotations ``z @ R`` and ``z_hat @ R^T`` are plain float32 products, as in
the reference, which computes them outside any Pallas kernel: they are
IEEE float32 only with TF32 off (``torch.backends.cuda.matmul.
allow_tf32``, off by default). Codes travel packed by
``core.packing.pack_codes``, the plain packer, as the reference's do.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import packing as _packing
from repro_torch.core import prng
from repro_torch.core import schemes as _schemes
from repro_torch.core.schemes import CodeSpec
from repro_torch.device import resolve_device
from repro_torch.parallel.collectives import all_gather_stack

__all__ = ["GradCompressionConfig", "GradCompressor", "code_centroids"]


@dataclass(frozen=True)
class GradCompressionConfig:
    """The compressor's scheme, bin width, rate (k = chunk / rate),
    rotation block, error feedback and seed."""
    scheme: str = "2bit"        # sign | 2bit | uniform | offset
    w: float = 0.75             # paper-recommended bin width (section 8)
    rate: int = 1               # subspace compression: k = chunk / rate
    chunk: int = 1024           # rotation block (QR'd once at init)
    error_feedback: bool = True
    seed: int = 17
    cutoff: float = 6.0

    @property
    def k(self) -> int:
        return self.chunk // self.rate

    @property
    def spec(self) -> CodeSpec:
        return CodeSpec(scheme=self.scheme, w=self.w, cutoff=self.cutoff)


def _norm_cdf(x: float) -> float:
    return 0.5 * math.erfc(-x / math.sqrt(2.0))


def _norm_pdf(x: float) -> float:
    return math.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


def code_centroids(spec: CodeSpec, offsets=None) -> np.ndarray:
    """E[z | code] under z ~ N(0, 1) for each code cell (float32 [n_codes]):
    the MMSE dequantizer. The offset scheme uses the zero-offset table, as
    the reference does."""
    def trunc_mean(a, b):
        pa, pb = _norm_cdf(a), _norm_cdf(b)
        if pb - pa < 1e-12:
            return 0.5 * (max(a, -spec.cutoff) + min(b, spec.cutoff))
        return (_norm_pdf(a) - _norm_pdf(b)) / (pb - pa)

    inf = math.inf
    if spec.scheme == "sign":
        cells = [(-inf, 0.0), (0.0, inf)]
    elif spec.scheme == "2bit":
        w = spec.w
        cells = [(-inf, -w), (-w, 0.0), (0.0, w), (w, inf)]
    elif spec.scheme in ("uniform", "offset"):
        n = spec.n_bins_side
        edges = np.arange(-n, n + 1) * spec.w
        cells = [(float(edges[i]), float(edges[i + 1]))
                 for i in range(2 * n)]
    else:
        raise ValueError(spec.scheme)
    return np.asarray([trunc_mean(a, b) for a, b in cells], np.float32)


def _tree_flatten(tree) -> tuple:
    """(leaves, structure) of a nested dict/list/tuple of tensors."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_tree_flatten(tree[k]) for k in keys]
        return ([leaf for p in parts for leaf in p[0]],
                ("dict", keys, [p[1] for p in parts]))
    if isinstance(tree, (list, tuple)):
        parts = [_tree_flatten(t) for t in tree]
        return ([leaf for p in parts for leaf in p[0]],
                (type(tree), None, [p[1] for p in parts]))
    if isinstance(tree, torch.Tensor):
        return [tree], None
    raise TypeError(f"a gradient tree holds dicts, lists, tuples and "
                    f"tensors, not {type(tree).__name__}")


def _tree_unflatten(structure, leaves):
    """Inverse of ``_tree_flatten`` over an iterator of leaves."""
    if structure is None:
        return next(leaves)
    kind, keys, subs = structure
    if kind == "dict":
        return {k: _tree_unflatten(s, leaves) for k, s in zip(keys, subs)}
    return kind(_tree_unflatten(s, leaves) for s in subs)


class GradCompressor:
    """Compressor bound to a gradient tree's layout, on one device
    (``cuda`` by default; ``device="cpu"`` runs it on the CPU)."""

    def __init__(self, cfg: GradCompressionConfig, grad_template,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        leaves, self._structure = _tree_flatten(grad_template)
        self.shapes = [tuple(x.shape) for x in leaves]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.total = sum(self.sizes)
        self.n_chunks = (self.total + cfg.chunk - 1) // cfg.chunk
        self.padded = self.n_chunks * cfg.chunk
        self._centroids = torch.from_numpy(code_centroids(cfg.spec)).to(
            self.device)
        key = prng.PRNGKey(cfg.seed)
        self._rkey = prng.fold_in(key, 0)
        # every rank regenerates the same R from the seed: nothing is sent
        g = prng.normal(self._rkey, (cfg.chunk, cfg.chunk),
                        device=self.device)
        self._r = torch.linalg.qr(g)[0][:, :cfg.k].contiguous()
        self._offsets = None
        if cfg.scheme == "offset":
            self._offsets = _schemes.sample_offsets(
                prng.fold_in(key, 1), cfg.k, cfg.w).to(self.device)

    # -- layout ---------------------------------------------------------------
    def _flatten(self, tree) -> torch.Tensor:
        """Tree -> float32 [padded] on the compressor's device (leaves
        elsewhere raise: nothing is copied across devices)."""
        leaves, _ = _tree_flatten(tree)
        for x in leaves:
            if x.device != self.device:
                raise ValueError(f"gradient leaf on {x.device}, compressor "
                                 f"on {self.device}")
        flat = torch.cat([x.reshape(-1).to(torch.float32) for x in leaves])
        return torch.nn.functional.pad(flat, (0, self.padded - self.total))

    def _unflatten(self, vec: torch.Tensor):
        parts = torch.split(vec[:self.total], self.sizes)
        return _tree_unflatten(self._structure, iter(
            p.reshape(s) for p, s in zip(parts, self.shapes)))

    def _signs(self, step: int) -> torch.Tensor:
        """The step's Rademacher sign flips [chunk]: with a fixed subspace
        the EF residual's orthogonal part would never be sent."""
        key = prng.fold_in(self._rkey, int(step) & 0xFFFFFFFF)
        return prng.rademacher(key, (self.cfg.chunk,)).to(self.device)

    # -- encode / decode ------------------------------------------------------
    def encode(self, g_vec: torch.Tensor, step: int = 0) -> tuple:
        """[padded] -> (codes int32 [n_chunks, k], scales [n_chunks])."""
        c = self.cfg
        blocks = g_vec.reshape(self.n_chunks, c.chunk)
        scales = torch.linalg.vector_norm(blocks, dim=1) + 1e-12
        blocks = blocks * self._signs(step)
        z = (blocks / scales[:, None]) @ self._r * math.sqrt(c.chunk)
        return _schemes.encode(z, c.spec, self._offsets), scales

    def decode(self, codes: torch.Tensor, scales: torch.Tensor,
               step: int = 0) -> torch.Tensor:
        """codes -> z_hat -> gradient blocks -> flat [padded]."""
        z_hat = self._centroids[codes]
        g_blocks = (z_hat @ self._r.T) / math.sqrt(self.cfg.chunk) \
            * scales[:, None]
        return (g_blocks * self._signs(step)).reshape(-1)

    # -- distributed sync -----------------------------------------------------
    def sync(self, grads, ef, mesh, step: int = 0, *, axis: str = "data"):
        """Over the data dim ``axis`` of ``mesh`` (every rank calls it with
        its own gradient): returns (synced gradient tree, new EF tree or
        None), the gradient the same on every rank. The packed codes and
        the scales are all-gathered, then averaged as the reference's
        ``einsum("pnk,pn->nk") / p``."""
        g = self._flatten(grads)
        if ef is not None:
            g = g + self._flatten(ef)
        codes, scales = self.encode(g, step)
        g_local_hat = self.decode(codes, scales, step)
        new_ef = self._unflatten(g - g_local_hat) if ef is not None else None

        bits = self.cfg.spec.bits
        packed = _packing.pack_codes(codes, bits)           # [nc, words]
        all_packed = all_gather_stack(packed, mesh, axis)   # [P, nc, words]
        all_scales = all_gather_stack(scales, mesh, axis)   # [P, nc]
        p = all_packed.shape[0]
        all_codes = _packing.unpack_codes(all_packed, bits, self.cfg.k)
        z_hat = self._centroids[all_codes]                  # [P, nc, k]
        z_mean = torch.einsum("pnk,pn->nk", z_hat, all_scales) / p
        g_hat = (z_mean @ self._r.T) / math.sqrt(self.cfg.chunk)
        g_hat = g_hat * self._signs(step)[None, :]
        return self._unflatten(g_hat.reshape(-1)), new_ef

    def sync_local(self, grads, ef, step: int = 0):
        """Single-rank path (no collective): compress -> decode, with error
        feedback; ``sync`` at world size 1 up to the order of its
        products."""
        g = self._flatten(grads)
        if ef is not None:
            g = g + self._flatten(ef)
        codes, scales = self.encode(g, step)
        g_hat = self.decode(codes, scales, step)
        new_ef = self._unflatten(g - g_hat) if ef is not None else None
        return self._unflatten(g_hat), new_ef

    def init_ef(self, grad_template):
        """Zero EF state shaped as the template (None without EF)."""
        if not self.cfg.error_feedback:
            return None
        leaves, structure = _tree_flatten(grad_template)
        return _tree_unflatten(structure, iter(
            torch.zeros(x.shape, dtype=torch.float32, device=self.device)
            for x in leaves))

    # -- accounting -----------------------------------------------------------
    def wire_bytes(self) -> int:
        """Payload bytes per rank per sync (codes packed + scales)."""
        bits = self.cfg.spec.bits
        return self.n_chunks * (self.cfg.k * bits // 8 + 4)

    def fp32_bytes(self) -> int:
        return self.total * 4
