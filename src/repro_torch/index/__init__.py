"""Mutable index over packed codes (counterpart of ``repro.index``).

segment_log  ``SegmentLogStore``: append-only log of segments whose rows
             never change, an in-place tail buffer (O(batch) ingest),
             packed tombstone bitmasks, the id -> row map
compaction   size-tiered rewrite of adjacent runs: merges small segments
             and drops tombstoned rows, keeping the row order
snapshot     save and restore through ``checkpoint``, in the reference's
             format (either package restores the other's)
engine       ``MutableAnnEngine``: search across segments with the masked
             kernels and a cross-segment merge
"""
from repro_torch.index.compaction import (CompactionPolicy, compact,  # noqa: F401
                                          plan_compaction)
from repro_torch.index.engine import MutableAnnEngine  # noqa: F401
from repro_torch.index.segment_log import Segment, SegmentLogStore  # noqa: F401
from repro_torch.index.snapshot import restore_index, save_index  # noqa: F401
