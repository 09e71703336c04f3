"""Ingest: raw vectors (dense or CSR) -> packed words through the
kernels, and the chunked pipeline into a store."""
from repro_torch.encode.encoder import R_CAP_ELEMS, StreamingEncoder  # noqa: F401
from repro_torch.encode.pipeline import IngestPipeline, encode_sharded  # noqa: F401
from repro_torch.encode.sparse import CsrMatrix, unit_buckets  # noqa: F401
