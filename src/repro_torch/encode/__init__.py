"""Ingest: raw vectors -> packed words through the fused kernels."""
from repro_torch.encode.encoder import R_CAP_ELEMS, StreamingEncoder  # noqa: F401
