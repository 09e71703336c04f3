"""Coded random-projection sketches: the paper's pipeline on PyTorch.

Counterpart of ``repro/core/sketch.py:46-207``:

    X [n, D] --(seeded Gaussian R [D, k])--> [n, k]
             --(b-bit coding scheme)-->      codes [n, k]
             --(bit packing)-->              words [n, ceil(k*b/32)]

R is canonical: unit u (rows u*r_unit .. u*r_unit + width) is
``normal(fold_in(PRNGKey(seed), u), (width, k))`` from ``core.prng``,
bit-identical to the JAX reference. Units are drawn on the CPU; the
streaming encoder caches the whole R on the sketcher's device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import packing as _packing
from repro_torch.core import prng
from repro_torch.core import schemes as _schemes
from repro_torch.core.estimators import CollisionEstimator
from repro_torch.core.schemes import CodeSpec
from repro_torch.device import resolve_device

__all__ = ["SketchConfig", "CodedRandomProjection", "OFFSET_KEY_TAG"]

# unit keys take fold_in(key, u) for u < n_units < 2^32 - 1; the offset
# vector draws from fold_in(key, 2^32 - 1), disjoint from every unit
OFFSET_KEY_TAG = 2 ** 32 - 1


@dataclass(frozen=True)
class SketchConfig:
    """Sketch identity: k projections, coding scheme and seed."""
    k: int = 256                    # number of projections
    scheme: str = "2bit"            # paper-recommended default (§8)
    w: float = 0.75                 # paper-recommended first bin width (§8)
    cutoff: float = 6.0
    seed: int = 0
    block_d: int = 4096             # config compatibility; never read
    dtype: str = "float32"
    r_unit: int = 4096              # canonical R generation granularity

    @property
    def code_spec(self) -> CodeSpec:
        """The scheme as a ``CodeSpec``."""
        return CodeSpec(scheme=self.scheme, w=self.w, cutoff=self.cutoff)


class CodedRandomProjection:
    """Sketching engine for a fixed input dimensionality D on one device
    (``cuda`` unless ``device`` names another)."""

    def __init__(self, cfg: SketchConfig, d: int, device=None):
        if cfg.dtype != "float32":
            raise NotImplementedError("the port draws R in float32 only")
        if cfg.r_unit <= 0:
            raise ValueError(f"r_unit must be positive, got {cfg.r_unit}")
        self.cfg = cfg
        self.d = int(d)
        self.device = resolve_device(device)
        if self.n_units >= OFFSET_KEY_TAG:
            raise ValueError(f"D={d} needs {self.n_units} projection units; "
                             f"key domain holds < {OFFSET_KEY_TAG}")
        self.spec = cfg.code_spec
        self._key = prng.PRNGKey(cfg.seed)
        self._offsets = None
        if cfg.scheme == "offset":
            self._offsets = _schemes.sample_offsets(
                self.offset_key(), cfg.k, cfg.w).to(self.device)
        self._estimator = CollisionEstimator(cfg.scheme, cfg.w)
        self._stream_encoder = None

    # -- projection ---------------------------------------------------------
    @property
    def n_units(self) -> int:
        """Canonical R generation units: ceil(D / r_unit)."""
        return (self.d + self.cfg.r_unit - 1) // self.cfg.r_unit

    def unit_width(self, u: int) -> int:
        """Rows of unit ``u``: r_unit except a ragged final unit."""
        return min(self.cfg.r_unit, self.d - u * self.cfg.r_unit)

    def offset_key(self) -> tuple:
        """Key of the offset vector q (a tag fold disjoint from units)."""
        return prng.fold_in(self._key, OFFSET_KEY_TAG)

    def _block_r(self, u: int, width: int) -> torch.Tensor:
        """Gaussian unit R[u*r_unit : u*r_unit + width, :k], float32 on the
        CPU: the only generator of projection entries."""
        return prng.normal(prng.fold_in(self._key, u), (width, self.cfg.k))

    def as_input(self, x) -> torch.Tensor:
        """Dense rows (tensor or array) as float32 on the sketcher's device."""
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            raise NotImplementedError(
                f"{type(x).__name__} input: sparse (CSR) ingest is ROADMAP "
                f"queue A item 3, not yet ported")
        x = torch.as_tensor(x, device=self.device)
        if x.dim() != 2 or x.shape[1] != self.d:
            raise ValueError(f"x {tuple(x.shape)} != [n, {self.d}]")
        return x.to(torch.float32)

    def project(self, x) -> torch.Tensor:
        """x [n, D] -> [n, k] float32, accumulated unit by unit in order:
        acc += x_u @ R_u for u = 0, 1, ..."""
        x = self.as_input(x)
        ru = self.cfg.r_unit
        acc = torch.zeros((x.shape[0], self.cfg.k), dtype=torch.float32,
                          device=self.device)
        for u in range(self.n_units):
            r = self._block_r(u, self.unit_width(u)).to(self.device)
            acc = acc + x[:, u * ru:u * ru + r.shape[0]] @ r
        return acc

    # -- coding -------------------------------------------------------------
    def encode(self, x) -> torch.Tensor:
        """x [n, D] -> int32 codes [n, k] (oracle path)."""
        return _schemes.encode(self.project(x), self.spec, self._offsets)

    def encode_projected(self, z: torch.Tensor) -> torch.Tensor:
        """Pre-projected z [n, k] -> int32 codes."""
        return _schemes.encode(z, self.spec, self._offsets)

    def pack(self, codes: torch.Tensor) -> torch.Tensor:
        """int32 codes [n, k] -> int32 words [n, W]."""
        return _packing.pack_codes(codes, self.spec.bits)

    def stream_encoder(self):
        """The sketcher's ``encode.StreamingEncoder`` (built once, shared by
        ``sketch`` and every query coder, so R is cached once)."""
        from repro_torch.encode.encoder import StreamingEncoder
        if self._stream_encoder is None:
            self._stream_encoder = StreamingEncoder(self)
        return self._stream_encoder

    def sketch(self, x, impl: str = "auto") -> torch.Tensor:
        """x [n, D] -> packed words [n, W] through the fused ingest kernel;
        agrees with ``sketch_oracle`` except at bin-edge sum-order flips."""
        return self.stream_encoder().encode_packed(x, impl=impl)

    def sketch_oracle(self, x) -> torch.Tensor:
        """Unfused project -> encode -> pack (the semantics oracle)."""
        return self.pack(self.encode(x))

    # -- estimation ---------------------------------------------------------
    def estimate_rho(self, codes_a: torch.Tensor,
                     codes_b: torch.Tensor) -> torch.Tensor:
        """rho_hat from code arrays [..., k] (table inversion, §3)."""
        return self._estimator.estimate(codes_a, codes_b)

    def estimate_rho_packed(self, words_a: torch.Tensor,
                            words_b: torch.Tensor) -> torch.Tensor:
        """rho_hat from packed words [..., W]."""
        ca = _packing.unpack_codes(words_a, self.spec.bits, self.cfg.k)
        cb = _packing.unpack_codes(words_b, self.spec.bits, self.cfg.k)
        return self.estimate_rho(ca, cb)
