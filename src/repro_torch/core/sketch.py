"""Coded random-projection sketches: the paper's pipeline on PyTorch.

Counterpart of ``repro/core/sketch.py:46-207``:

    X [n, D] --(seeded Gaussian R [D, k])--> [n, k]
             --(b-bit coding scheme)-->      codes [n, k]
             --(bit packing)-->              words [n, ceil(k*b/32)]

R is canonical: unit u (rows u*r_unit .. u*r_unit + width) is
``normal(fold_in(PRNGKey(seed), u), (width, k))`` in the config's dtype
(float32 or bfloat16), bit-identical to the JAX reference. Units are drawn on the sketcher's device: by the CUDA
kernel ``kernels/csrc/normal_unit.cu`` on the card, by ``core.prng``'s
plain version on the CPU. Below the residency cap the streaming encoder
caches the whole R; above it every unit is drawn again where it is used.

A bf16 sketch (``SketchConfig(dtype="bfloat16")``) draws R and the
offsets in bf16 and streams dense projections in bf16 as the
reference's ``project`` does: each unit's product x_u @ R_u of the
bf16-rounded rows, accumulated in float32 and rounded once to bf16, is
added to the bf16 accumulator with one more rounding. Codes then differ
from the reference's only where a projection lies within bf16 rounding
of a bin edge.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core import packing as _packing
from repro_torch.core import prng
from repro_torch.core import schemes as _schemes
from repro_torch.core.estimators import CollisionEstimator
from repro_torch.core.schemes import CodeSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as _ops

__all__ = ["SketchConfig", "CodedRandomProjection", "OFFSET_KEY_TAG"]

# unit keys take fold_in(key, u) for u < n_units < 2^32 - 1; the offset
# vector draws from fold_in(key, 2^32 - 1), disjoint from every unit
OFFSET_KEY_TAG = 2 ** 32 - 1
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
        if cfg.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got "
                             f"{cfg.dtype!r}")
        if cfg.r_unit <= 0:
            raise ValueError(f"r_unit must be positive, got {cfg.r_unit}")
        self.cfg = cfg
        self.d = int(d)
        self.device = resolve_device(device)
        if self.n_units >= OFFSET_KEY_TAG:
            raise ValueError(f"D={d} needs {self.n_units} projection units; "
                             f"key domain holds < {OFFSET_KEY_TAG}")
        self.spec = cfg.code_spec
        self.dtype = _DTYPES[cfg.dtype]
        self._key = prng.PRNGKey(cfg.seed)
        self._offsets = None
        if cfg.scheme == "offset":
            self._offsets = _schemes.sample_offsets(
                self.offset_key(), cfg.k, cfg.w, self.dtype).to(self.device)
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

    def _block_r(self, u: int, width: int, impl: str = "auto") -> torch.Tensor:
        """Gaussian unit R[u*r_unit : u*r_unit + width, :k] in the
        config's dtype on the sketcher's device: the only generator of
        projection entries."""
        return _ops.normal_unit(prng.fold_in(self._key, u), width,
                                self.cfg.k, self.device, impl=impl,
                                dtype=self.dtype)

    def _draw_units(self, units: list, out: torch.Tensor,
                    impl: str = "auto") -> torch.Tensor:
        """Units ``units`` (ascending, within ``out.shape[0]`` of the
        first) drawn in one launch into out [G, r_unit, k], unit u at
        slot u - units[0], each bit-identical to ``_block_r(u)``."""
        return _ops.normal_unit_group(
            [prng.fold_in(self._key, u) for u in units],
            [self.unit_width(u) for u in units], out,
            [u - units[0] for u in units], impl=impl)

    def as_input(self, x) -> torch.Tensor:
        """Dense rows (tensor or array) as float32 on the sketcher's device
        (CSR input is routed by the streaming encoder)."""
        self._check_dense(x)
        return torch.as_tensor(x, device=self.device).to(torch.float32)

    def _check_dense(self, x) -> None:
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            raise TypeError(f"dense input is a tensor or an array, got "
                            f"{type(x).__name__}")
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"x {tuple(x.shape)} != [n, {self.d}]")

    def project(self, x, impl: str = "auto") -> torch.Tensor:
        """Dense x [n, D] -> [n, k] in the config's dtype, streamed unit by
        unit in order (acc += x_u @ R_u for u = 0, 1, ...; R is never
        built; bf16 as the module docstring says). A host array (numpy,
        memmap) is sliced on the host and sent one unit slab at a time,
        so device memory stays O(n * r_unit + n * k); a tensor is sliced
        where it lies."""
        self._check_dense(x)
        ru = self.cfg.r_unit
        acc = torch.zeros((x.shape[0], self.cfg.k), dtype=self.dtype,
                          device=self.device)
        for u in range(self.n_units):
            r = self._block_r(u, self.unit_width(u), impl=impl)
            xu = torch.as_tensor(x[:, u * ru:u * ru + r.shape[0]],
                                 device=self.device)
            if self.dtype == torch.float32:
                acc += xu.to(torch.float32) @ r
            else:
                xr = xu.to(self.dtype).float() @ r.float()
                acc = (acc.float() + xr.to(self.dtype).float()).to(
                    self.dtype)
        return acc

    # -- coding -------------------------------------------------------------
    def encode(self, x) -> torch.Tensor:
        """Dense x [n, D] -> int32 codes [n, k] (oracle path)."""
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
        """x [n, D] (dense or ``encode.CsrMatrix``) -> packed words [n, W]
        through the streaming encoder: the fused ingest kernel below the
        residency cap, unit streaming above it; agrees with
        ``sketch_oracle`` except at bin-edge sum-order flips."""
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

    def asymptotic_std(self, rho) -> torch.Tensor:
        """Predicted std of rho_hat at k projections, float64."""
        return self._estimator.asymptotic_std(rho, self.cfg.k)

    # -- storage accounting (the paper's headline economy) -------------------
    def bytes_per_vector(self) -> int:
        """Bytes of one packed code row."""
        return 4 * _packing.packed_width(self.cfg.k, self.spec.bits)

    def fp32_bytes_per_vector(self) -> int:
        """Bytes of one float32 projection row."""
        return 4 * self.cfg.k

    def with_scheme(self, scheme: str, w: float = None):
        """A sketcher with another coding scheme on the same R: the seed,
        D and device carry over."""
        cfg = replace(self.cfg, scheme=scheme,
                      w=self.cfg.w if w is None else w)
        return CodedRandomProjection(cfg, self.d, device=self.device)
