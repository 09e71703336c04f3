"""Index durability: snapshot and restore through ``checkpoint``.

Counterpart of ``repro/index/snapshot.py``, in its format (version 2),
so that a snapshot written by either package restores in the other. One
atomic checkpoint step holds a flat dict: per segment ``seg<i>_words``
(uint32 [cap, W]), ``seg<i>_valid`` (uint32 bitmask), ``seg<i>_ids``
(int64) and, with a band spec, ``seg<i>_hashes`` (uint32 [cap, L]),
plus ``meta``, a JSON object as uint8 bytes (geometry, ``tail_len``,
``next_id``, band spec, ``impl``). Restore is self-describing: the
manifest gives every leaf's shape and dtype. The tail is saved at full
size with its length, so a restored index resumes ingest where it
stopped, and ``next_id`` carries over, so ids are never reused.

``impl`` is mapped at the boundary: the reference's ``"pallas"`` is the
port's ``"kernel"``; ``"auto"`` and ``"ref"`` are the same in both.
"""
from __future__ import annotations

import json
import re

import numpy as np
import torch

from repro_torch.ann.bands import BandSpec
from repro_torch.checkpoint import (ShapeDtype, latest_step, read_manifest,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.device import resolve_device
from repro_torch.index.segment_log import Segment, SegmentLogStore

__all__ = ["save_index", "restore_index"]

_NAME_RE = re.compile(r"\['([^']+)'\]$")
_IMPL_OUT = {"kernel": "pallas"}
_IMPL_IN = {"pallas": "kernel"}


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def save_index(store: SegmentLogStore, directory: str, step: int,
               keep: int = 3) -> str:
    """Write the store as checkpoint ``directory/step_<step>``; returns
    its path."""
    segs = store.segments()
    # version 2: codes from the canonical r_unit-keyed R and the tagged
    # offset key; version-1 snapshots are rejected on restore
    meta = {
        "version": 2, "k": store.k, "bits": store.bits,
        "tail_rows": store.tail_rows, "tail_len": store.tail.length,
        "next_id": store.next_id, "n_segments": len(segs),
        "impl": _IMPL_OUT.get(store.impl, store.impl),
        "band": ([store.band_spec.n_tables, store.band_spec.band_width]
                 if store.band_spec else None),
    }
    tree = {"meta": np.frombuffer(json.dumps(meta).encode(), np.uint8)}
    for i, seg in enumerate(segs):
        tree[f"seg{i}_words"] = _u32(seg.words)
        tree[f"seg{i}_valid"] = seg.valid
        tree[f"seg{i}_ids"] = seg.ids
        if seg.hashes is not None:
            tree[f"seg{i}_hashes"] = _u32(seg.hashes)
    return save_checkpoint(directory, step, tree, keep=keep)


def _like_from_manifest(manifest: dict) -> dict:
    """Leaf specs from the manifest; uint32 leaves come back as int32
    bit-views."""
    like = {}
    for leaf in manifest["leaves"]:
        m = _NAME_RE.match(leaf["name"])
        if m is None:
            raise ValueError(f"unexpected leaf name {leaf['name']!r}")
        dtype = "int32" if leaf["dtype"] == "uint32" else leaf["dtype"]
        like[m.group(1)] = ShapeDtype(tuple(leaf["shape"]), dtype)
    return like


def restore_index(directory: str, step: int = None,
                  device=None) -> SegmentLogStore:
    """Rebuild a ``SegmentLogStore`` on ``device`` (the card by default)
    from a snapshot: the latest complete step, or ``step``."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete snapshot in {directory}")
    tree = restore_checkpoint(
        directory, step, _like_from_manifest(read_manifest(directory, step)),
        device="cpu")
    meta = json.loads(tree["meta"].numpy().tobytes().decode())
    if meta.get("version") != 2:
        raise ValueError(
            f"unsupported snapshot version {meta.get('version')} (v1 codes "
            f"predate the canonical r_unit key schedule and would silently "
            f"disagree with a current sketcher; re-ingest the corpus)")
    band = (BandSpec(n_tables=meta["band"][0], band_width=meta["band"][1])
            if meta["band"] else None)
    store = SegmentLogStore(meta["k"], meta["bits"], band_spec=band,
                            tail_rows=meta["tail_rows"],
                            impl=_IMPL_IN.get(meta["impl"], meta["impl"]),
                            device=dev)
    n_segs = meta["n_segments"]
    for i in range(n_segs):
        is_tail = i == n_segs - 1
        words = tree[f"seg{i}_words"].to(dev)
        hashes = tree.get(f"seg{i}_hashes")
        seg = Segment(
            words=words, hashes=None if hashes is None else hashes.to(dev),
            ids=tree[f"seg{i}_ids"].numpy().copy(),
            valid=tree[f"seg{i}_valid"].numpy().view(np.uint32).copy(),
            live=0,
            length=meta["tail_len"] if is_tail else words.shape[0])
        rows = seg.live_rows()
        seg.live = int(rows.size)
        store._index_rows(seg, rows)
        if is_tail:
            store.tail = seg
        else:
            store.sealed.append(seg)
    store.next_id = meta["next_id"]
    store.generation += 1
    return store
