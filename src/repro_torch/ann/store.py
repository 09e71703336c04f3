"""Device-resident corpus of bit-packed codes.

Counterpart of ``repro/ann/store.py:29-96``: an immutable array of words
(int32 bit-views of uint32) [n, ceil(k*b/32)] on one device; ``add`` and
``merge`` return new stores. The row axis is the shard axis:
``shard``/``row_sharding`` split the store over a mesh's data dim for
the row-sharded search (``AnnEngine.search_sharded``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import packing as _packing
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as _ops
from repro_torch.parallel.collectives import axis_group

__all__ = ["CodeStore"]


@dataclass(frozen=True)
class CodeStore:
    """Immutable packed-code corpus: ``words`` int32 [n, n_words]."""
    words: torch.Tensor
    k: int
    bits: int

    def __post_init__(self):
        want = _packing.packed_width(self.k, self.bits)
        if self.words.dim() != 2 or self.words.shape[1] != want \
                or self.words.dtype != torch.int32:
            raise ValueError(
                f"words {self.words.dtype} {tuple(self.words.shape)} != "
                f"int32 [n, {want}] for k={self.k}, bits={self.bits}")

    @classmethod
    def from_codes(cls, codes: torch.Tensor, k: int, bits: int,
                   impl: str = "auto") -> "CodeStore":
        """Pack int32 codes [n, k] (the kernel for CUDA tensors)."""
        if codes.shape[-1] != k:
            raise ValueError(f"codes {tuple(codes.shape)} do not have k={k}")
        return cls(words=_ops.pack_codes(codes, bits, impl=impl), k=k,
                   bits=bits)

    @classmethod
    def from_words(cls, words, k: int, bits: int, device=None) -> "CodeStore":
        """Wrap packed words [n, W]: an int32 tensor stays where it is;
        anything else is placed on ``device`` (``cuda`` by default)."""
        if not isinstance(words, torch.Tensor):
            words = torch.as_tensor(words, device=resolve_device(device))
        return cls(words=words, k=k, bits=bits)

    def add(self, codes: torch.Tensor, impl: str = "auto") -> "CodeStore":
        """New store with packed ``codes`` [m, k] appended (ids n..n+m)."""
        return self.merge(CodeStore.from_codes(codes, self.k, self.bits,
                                               impl=impl))

    def add_words(self, words: torch.Tensor) -> "CodeStore":
        """New store with packed rows [m, W] appended."""
        return self.merge(CodeStore(words=words, k=self.k, bits=self.bits))

    def merge(self, other: "CodeStore") -> "CodeStore":
        """New store: self's rows then other's (same k and bits)."""
        if (self.k, self.bits) != (other.k, other.bits):
            raise ValueError(f"incompatible stores: k/bits "
                             f"{(self.k, self.bits)} vs {(other.k, other.bits)}")
        return CodeStore(words=torch.cat([self.words, other.words]),
                         k=self.k, bits=self.bits)

    @property
    def n(self) -> int:
        """Corpus rows."""
        return self.words.shape[0]

    @property
    def n_words(self) -> int:
        """Words per row: ceil(k / (32/bits))."""
        return self.words.shape[1]

    @property
    def nbytes(self) -> int:
        """Device bytes of the packed corpus (4 per word)."""
        return self.n * self.n_words * 4

    def unpack(self) -> torch.Tensor:
        """int32 codes [n, k] (debug and compatibility path)."""
        return _packing.unpack_codes(self.words, self.bits, self.k)

    def take(self, ids: torch.Tensor) -> torch.Tensor:
        """Gather rows -> int32 words [..., n_words]."""
        return self.words[ids.to(self.words.device, torch.int64)]

    # -- device placement ----------------------------------------------------
    def row_sharding(self, mesh, axis: str = "data") -> list:
        """The store's layout on ``mesh`` as DTensor placements: rows
        split over dim ``axis`` (``[Shard(0)]`` on a 1-D mesh),
        replicated over any other dim."""
        from torch.distributed.tensor import Replicate, Shard
        axis_group(mesh, axis)
        return [Shard(0) if name == axis else Replicate()
                for name in mesh.mesh_dim_names]

    def shard(self, mesh, axis: str = "data") -> "CodeStore":
        """This rank's block of rows along ``mesh[axis]``: rows
        [r * n / world, (r + 1) * n / world) of rank r (n must divide).
        Every rank holds the whole store; the block is a view of it."""
        _, rank, world = axis_group(mesh, axis, self.words)
        if self.n % world != 0:
            raise ValueError(
                f"n={self.n} not divisible by mesh axis {axis} ({world})")
        n_local = self.n // world
        return CodeStore(words=self.words[rank * n_local:
                                          (rank + 1) * n_local],
                         k=self.k, bits=self.bits)
