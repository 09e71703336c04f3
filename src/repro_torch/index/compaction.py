"""Size-tiered compaction for the segment log.

Counterpart of ``repro/index/compaction.py``. Churn leaves many
tail-sized sealed segments with a growing share of tombstones: each
query pays one kernel launch a segment, and dead rows still cost their
popcounts. Compaction rewrites *adjacent runs* of sealed segments into
one dense segment. Adjacency keeps the log's iteration order, which is
the search tie-break order, so count-ranked results do not change.

Policy, greedy over the log:

* adjacent sealed segments accumulate while the merged output stays
  under ``target_rows`` live rows;
* a run is rewritten when it has more than one segment, or when its one
  segment holds more than ``max_dead_fraction`` tombstones;
* the tail is never touched.

A rewrite gathers the run's live rows on the device (``index_select``:
O(run), never the whole corpus) into a fully live segment. ``compact``
mutates the store and returns a report dict; it runs under an
``index.compact`` span and reports through the store's registry
(``index.compactions``, ``index.compact_rows_dropped``,
``index.compact_bytes_copied``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.index.segment_log import (Segment, SegmentLogStore,
                                           _np_pack_bitmask)
from repro_torch.obs import span

__all__ = ["CompactionPolicy", "plan_compaction", "compact"]


@dataclass(frozen=True)
class CompactionPolicy:
    target_rows: int = 4096          # most live rows in a merged segment
    max_dead_fraction: float = 0.25  # a lone segment is rewritten above this


def _wants_rewrite(run: list[Segment], policy: CompactionPolicy) -> bool:
    if len(run) > 1:
        return True
    seg = run[0]
    dead = seg.length - seg.live
    return seg.length > 0 and dead / seg.length > policy.max_dead_fraction


def plan_compaction(store: SegmentLogStore,
                    policy: CompactionPolicy = CompactionPolicy()):
    """Greedy adjacent runs of sealed-segment indices worth rewriting."""
    runs, cur, cur_live = [], [], 0
    for i, seg in enumerate(store.sealed):
        if cur and cur_live + seg.live > policy.target_rows:
            if _wants_rewrite([store.sealed[j] for j in cur], policy):
                runs.append(cur)
            cur, cur_live = [], 0
        cur.append(i)
        cur_live += seg.live
    if cur and _wants_rewrite([store.sealed[j] for j in cur], policy):
        runs.append(cur)
    return runs


def _rewrite_run(store: SegmentLogStore, run: list[Segment]) -> Segment:
    """Gather the run's live rows into one dense, fully live segment."""
    rows_per = [seg.live_rows() for seg in run]
    n_new = int(sum(r.size for r in rows_per))
    picks = [(seg, torch.from_numpy(rows).to(store.device))
             for seg, rows in zip(run, rows_per) if rows.size]
    if picks:
        words = torch.cat([seg.words.index_select(0, r) for seg, r in picks])
    else:
        words = torch.zeros((0, store.n_words), dtype=torch.int32,
                            device=store.device)
    hashes = None
    if store.band_spec is not None:
        hashes = torch.cat([seg.hashes.index_select(0, r)
                            for seg, r in picks]) if picks else torch.zeros(
            (0, store.band_spec.n_tables), dtype=torch.int32,
            device=store.device)
    ids = np.concatenate([seg.ids[rows] for seg, rows in zip(run, rows_per)])
    return Segment(words=words, hashes=hashes, ids=ids,
                   valid=_np_pack_bitmask(np.ones(n_new, bool)),
                   live=n_new, length=n_new)


def compact(store: SegmentLogStore,
            policy: CompactionPolicy = CompactionPolicy()) -> dict:
    """Rewrite the planned runs in place; the iteration order of live
    rows is unchanged. Returns {runs, segments_before, segments_after,
    rows_dropped, bytes_copied}."""
    with span("index.compact") as sp:
        runs = plan_compaction(store, policy)
        before = len(store.sealed)
        dropped = copied_bytes = 0
        run_at = {run[0]: run for run in runs}
        in_run = {i for run in runs for i in run}
        new_sealed: list[Segment] = []
        for i, seg in enumerate(store.sealed):
            if i not in in_run:
                new_sealed.append(seg)
                continue
            if i not in run_at:
                continue            # consumed by the run that starts earlier
            run = [store.sealed[j] for j in run_at[i]]
            merged = _rewrite_run(store, run)
            sp.sync(merged.words)
            dropped += sum(s.length for s in run) - merged.length
            copied_bytes += merged.words.numel() * 4
            for old in run:
                store._retire(old)
            store._index_rows(merged, np.arange(merged.length))
            if merged.length:       # an all-dead run just vanishes
                new_sealed.append(merged)
        store.sealed = new_sealed
        if runs:
            store.generation += 1
            # external ids survive a rewrite: listeners only learn that
            # membership was rewritten
            store._notify("compact", None)
        reg = store.registry
        reg.counter("index.compactions").inc()
        reg.counter("index.compact_rows_dropped").inc(dropped)
        reg.counter("index.compact_bytes_copied").inc(copied_bytes)
        store._update_gauges()
        sp.set(runs=len(runs), rows_dropped=dropped)
    return {"runs": len(runs), "segments_before": before,
            "segments_after": len(store.sealed),
            "rows_dropped": dropped, "bytes_copied": copied_bytes}
