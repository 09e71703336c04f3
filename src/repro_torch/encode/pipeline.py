"""Chunked ingest: raw corpus -> packed words -> store, streamed.

Counterpart of ``repro/encode/pipeline.py``'s ``IngestPipeline``: it
walks a corpus in chunks of ``chunk_rows`` rows: a dense [n, D] tensor,
a dense host array (each chunk stays on the host; the encoder sends it
to the device as a whole below the residency cap, one unit slab at a
time above it) or an ``encode.CsrMatrix`` (``row_slice`` chunks). It
encodes each chunk straight to packed words (no [n, k] codes) and
appends them to a store: a ``SegmentLogStore`` (in-place tail writes,
through ``add_words``) or a ``CodeStore`` (rebound on ``self.store`` a
chunk; read it back after ``ingest``). The reference pads each chunk to
a power of two to bound its jit compiles; the port compiles nothing and
does not pad.

``encode_sharded`` is the data-parallel twin for a dense corpus: rows
split over a ``DeviceMesh`` dim, each rank projecting its block through
the sketcher's canonical unit stream (R's units drawn from the seed on
every rank, nothing broadcast) and coding and packing it with
``ops.code_pack``; the blocks are all-gathered into the whole [n, W].

Observability, under the reference's names: counters ``encode.rows``,
``encode.chunks`` and ``encode.packed_bytes`` and the ``encode.chunk_s``
histogram in the pipeline's registry (its own unless one is injected;
``stats`` reads the counters), ``encode.ingest`` and ``encode.chunk``
spans, and an ``encode.ingest`` flight event a call.
"""
from __future__ import annotations

import time
from types import MappingProxyType

import numpy as np
import torch

from repro_torch.encode.encoder import StreamingEncoder
from repro_torch.encode.sparse import CsrMatrix
from repro_torch.kernels import ops as _ops
from repro_torch.obs import (MetricsRegistry, deep_tracing_active,
                             default_flight_recorder, span)
from repro_torch.parallel.collectives import all_gather_stack, axis_group

__all__ = ["IngestPipeline", "encode_sharded"]


class IngestPipeline:
    """Stream a corpus into a store in encoder-sized chunks; ``stats``
    counts rows, chunks and packed bytes across calls."""

    def __init__(self, encoder: StreamingEncoder, store, *,
                 chunk_rows: int = 2048, impl: str = "auto",
                 registry: MetricsRegistry = None):
        if chunk_rows <= 0:
            raise ValueError(f"chunk_rows must be positive: {chunk_rows}")
        self.encoder = encoder
        self.store = store
        self.chunk_rows = int(chunk_rows)
        self.impl = impl
        self.registry = registry if registry is not None \
            else MetricsRegistry(enabled=True)
        self._c_rows = self.registry.counter("encode.rows")
        self._c_chunks = self.registry.counter("encode.chunks")
        self._c_bytes = self.registry.counter("encode.packed_bytes")
        self._h_chunk = self.registry.histogram("encode.chunk_s")

    @property
    def stats(self):
        """Read-only view of the ingest counters (plain ints)."""
        return MappingProxyType({"rows": self._c_rows.value,
                                 "chunks": self._c_chunks.value,
                                 "packed_bytes": self._c_bytes.value})

    def ingest(self, x, ids=None) -> np.ndarray:
        """Encode and append every row of ``x`` (dense [n, D] or
        ``CsrMatrix``); returns the external ids int64 [n] (for a
        ``CodeStore``, the appended row positions). Explicit ids are
        validated for the whole batch before the first chunk is
        appended."""
        csr = isinstance(x, CsrMatrix)
        if not (csr or isinstance(x, (torch.Tensor, np.ndarray))):
            raise TypeError(f"a corpus is a tensor, an array or a CsrMatrix, "
                            f"got {type(x).__name__}")
        n = x.n if csr else int(x.shape[0])
        mutable = hasattr(self.store, "add_codes")
        if ids is not None:
            if not mutable:
                raise ValueError(
                    "explicit ids need an id-aware store (SegmentLogStore); "
                    "CodeStore rows are addressed by position only")
            ids = np.asarray(ids, np.int64)
            if ids.shape != (n,):
                raise ValueError(f"ids {ids.shape} != ({n},)")
            # a clash found mid-loop would leave earlier chunks ingested
            if np.unique(ids).size != n:
                raise ValueError("duplicate ids within one ingest")
            clash = [i for i in ids.tolist() if i in self.store]
            if clash:
                raise ValueError(f"ids already live (upsert instead): "
                                 f"{clash[:5]}")
        out_ids = []
        t_ing = time.perf_counter()
        with span("encode.ingest", rows=n) as sp:
            for lo in range(0, n, self.chunk_rows):
                hi = min(lo + self.chunk_rows, n)
                chunk = x.row_slice(lo, hi) if csr else x[lo:hi]
                t0 = time.perf_counter()
                with span("encode.chunk", rows=hi - lo) as csp:
                    words = csp.sync(self.encoder.encode_packed(
                        chunk, impl=self.impl))
                self._h_chunk.observe(time.perf_counter() - t0)
                if mutable:
                    out_ids.append(self.store.add_words(
                        words, ids=None if ids is None else ids[lo:hi]))
                else:
                    start = self.store.n
                    self.store = self.store.add_words(words)
                    out_ids.append(np.arange(start, start + hi - lo,
                                             dtype=np.int64))
                self._c_rows.inc(hi - lo)
                self._c_chunks.inc()
                self._c_bytes.inc(words.numel() * 4)
            sp.set(chunks=self._c_chunks.value)
        default_flight_recorder().record(
            "encode.ingest", t_ing, time.perf_counter(), batch=n,
            generation=getattr(self.store, "generation", -1),
            synced=deep_tracing_active())
        return (np.concatenate(out_ids) if out_ids
                else np.zeros(0, np.int64))


def encode_sharded(encoder: StreamingEncoder, x, mesh, axis: str = "data",
                   impl: str = "auto") -> torch.Tensor:
    """Data-parallel encode of a dense x [n, D] (a tensor or host array)
    row-sharded over ``mesh[axis]`` (n must divide) -> int32 words
    [n, W], the same on every rank.

    Rank r takes rows [r * n / world, (r + 1) * n / world), runs the
    sketcher's ``project`` on them (the unit-ordered float32 stream, as
    the reference's shard-local scan) and ``ops.code_pack``; the blocks
    are all-gathered in rank order. The words equal the unsharded
    ``project`` + ``code_pack`` of x at any world size; against
    ``encode_packed`` (the 3xTF32 GEMM kernel on the card) they agree
    but at fields within about 1e-6 of a bin edge. A CSR corpus shards
    at the pipeline level instead: one ``IngestPipeline`` per rank over
    its row slice."""
    if isinstance(x, CsrMatrix):
        raise TypeError("encode_sharded takes a dense corpus; run one "
                        "IngestPipeline per rank over its CSR row slice")
    s = encoder.sketcher
    _, rank, world = axis_group(mesh, axis, s.device)
    n = int(x.shape[0])
    if n % world:
        raise ValueError(f"n={n} not divisible by mesh axis {axis} "
                         f"({world})")
    n_local = n // world
    xs = x[rank * n_local:(rank + 1) * n_local]
    words = _ops.code_pack(s.project(xs, impl=impl), s.spec, s._offsets,
                           impl=impl)
    return all_gather_stack(words, mesh, axis).reshape(n, -1)
