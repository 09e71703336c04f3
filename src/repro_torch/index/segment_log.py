"""Segment-log store: the mutable corpus of packed codes.

Counterpart of ``repro/index/segment_log.py:71-436``:

* **Tail buffer.** A preallocated int32 buffer of ``tail_rows`` rows on
  the store's device. ``add_codes``/``add_words`` write each batch into
  it in place (``copy_`` into a slice): O(batch) bytes, the corpus is
  never touched.
* **Sealed segments.** When the tail fills it is sealed as it is (it is
  simply no longer written) and a fresh tail is allocated: no copy.
  Sealed segments never change content.
* **Tombstones.** A delete clears one bit of the segment's packed
  validity bitmask (host-authoritative ``np.uint32``, its device copy
  cached until the next mutation). Searches skip dead rows in the masked
  kernels (``kernels.packed_collision``, ``kernels.fused_scored``).
* **Upserts.** An id -> (segment, row) map lets ``upsert_codes``
  tombstone an id's current row and append its new version under the
  same external id; ids are stable across upserts, seals and
  compactions. The map holds plain ints (a segment's serial number
  times 2^32 plus the row), which the garbage collector never scans and
  numpy builds in bulk.

Row order: sealed segments in log order, live rows in row order, then
the tail. It is the row order of a fresh ``CodeStore`` built from
``live_words()``, and so the search tie-break order. Packed words and
band hashes are held as int32 bit-views of their uint32 values.

The store reports to a ``repro_torch.obs`` registry (its own unless one
is injected) under the reference's names: counters ``index.rows_appended``,
``index.rows_deleted``, ``index.seals``; gauges ``index.live_rows``,
``index.dead_rows``, ``index.live_fraction``, ``index.segments``,
``index.tail_fill``, ``index.resident_bytes``, refreshed after every
mutation.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.ann.bands import BandSpec, band_hashes, word_band_hashes
from repro_torch.core import packing as _packing
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as _ops
from repro_torch.obs import MetricsRegistry

__all__ = ["Segment", "SegmentLogStore"]

_INT32_ID_LIMIT = 2 ** 31 - 1


def _np_pack_bitmask(flags: np.ndarray) -> np.ndarray:
    """Host ``packing.pack_bitmask``: bool [n] -> uint32 [ceil(n/32)]."""
    packed = np.packbits(flags.astype(bool), bitorder="little")
    pad = (-packed.size) % 4
    if pad:
        packed = np.pad(packed, (0, pad))
    return packed.view(np.uint32)


def _np_unpack_bitmask(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of ``_np_pack_bitmask``: uint32 words -> bool [n]."""
    return np.unpackbits(words.view(np.uint8), bitorder="little")[:n] \
        .astype(bool)


def _np_set_bits(words: np.ndarray, lo: int, hi: int):
    """Set bits [lo, hi) of a uint32 bitmask in place, a word at a time."""
    if lo >= hi:
        return
    w0, w1 = lo // 32, (hi - 1) // 32
    first = np.uint32((0xFFFFFFFF << (lo % 32)) & 0xFFFFFFFF)
    last = np.uint32(0xFFFFFFFF >> (31 - (hi - 1) % 32))
    if w0 == w1:
        words[w0] |= first & last
    else:
        words[w0] |= first
        words[w0 + 1:w1] = 0xFFFFFFFF
        words[w1] |= last


class Segment:
    """One log segment: device rows that never change, and liveness.

    ``words`` int32 [cap, W] and ``hashes`` int32 [cap, L] (or None) are
    device tensors of fixed shape; in the tail, rows past ``length`` are
    unwritten and their validity bits are 0, so a search takes the whole
    buffer. ``ids`` int64 [cap] (-1 for unwritten slots) and ``valid``
    uint32 [ceil(cap/32)] live on the host; ``valid_dev``/``ids_dev``
    are device copies made on demand and dropped on mutation.
    """

    __slots__ = ("words", "hashes", "ids", "valid", "live", "length",
                 "serial", "_valid_dev", "_ids_dev")

    def __init__(self, words, hashes, ids, valid, live, length):
        self.words = words
        self.hashes = hashes
        self.ids = ids
        self.valid = valid
        self.live = live              # live rows
        self.length = length          # written rows (cap once sealed)
        self.serial = None            # the store's key, once indexed
        self._valid_dev = None
        self._ids_dev = None

    @property
    def cap(self) -> int:
        """Row capacity of the segment's device buffer."""
        return self.words.shape[0]

    def valid_dev(self) -> torch.Tensor:
        """Device copy of the validity bitmask, int32 [ceil(cap/32)]."""
        if self._valid_dev is None:
            self._valid_dev = torch.from_numpy(
                self.valid.view(np.int32).copy()).to(self.words.device)
        return self._valid_dev

    def ids_dev(self) -> torch.Tensor:
        """Device copy of the external ids, int32 [cap] (-1 = unwritten)."""
        if self._ids_dev is None:
            self._ids_dev = torch.from_numpy(
                self.ids.astype(np.int32)).to(self.words.device)
        return self._ids_dev

    def live_rows(self) -> np.ndarray:
        """Indices of the live rows, ascending (the iteration order)."""
        return np.flatnonzero(_np_unpack_bitmask(self.valid, self.length))

    def kill_rows(self, rows: np.ndarray):
        """Tombstone live rows (int array): clear their validity bits,
        drop the device copy, lower the live count."""
        rows = np.asarray(rows, np.int64)
        np.bitwise_and.at(self.valid, rows // 32,
                          ~(np.uint32(1) << (rows % 32).astype(np.uint32)))
        self.live -= rows.size
        self._valid_dev = None

    def kill_row(self, row: int):
        """Tombstone one live row."""
        self.kill_rows(np.asarray([row]))


def _empty_segment(cap: int, n_words: int, n_tables: int, device) -> Segment:
    return Segment(
        words=torch.zeros((cap, n_words), dtype=torch.int32, device=device),
        hashes=(torch.zeros((cap, n_tables), dtype=torch.int32,
                            device=device) if n_tables else None),
        ids=np.full(cap, -1, np.int64),
        valid=np.zeros(_packing.bitmask_width(cap), np.uint32),
        live=0, length=0)


class SegmentLogStore:
    """Mutable corpus of packed codes: an append-only segment log with
    tombstones, on one device (the card unless ``device`` names another).

    Every mutation bumps ``generation``. The store holds codes; encoding
    vectors is ``index.engine.MutableAnnEngine``'s part.
    """

    def __init__(self, k: int, bits: int, *, band_spec: BandSpec = None,
                 tail_rows: int = 1024, impl: str = "auto", device=None,
                 registry: MetricsRegistry = None):
        if tail_rows % 32:
            raise ValueError(f"tail_rows must be a multiple of 32, "
                             f"got {tail_rows}")
        self.k = k
        self.bits = bits
        self.band_spec = band_spec.validate(k) if band_spec else None
        self.tail_rows = tail_rows
        self.impl = impl
        self.device = resolve_device(device)
        self.n_words = _packing.packed_width(k, bits)
        self.sealed: list[Segment] = []
        self.tail = self._new_tail()
        self.next_id = 0
        self.generation = 0
        self._by_id: dict[int, int] = {}      # id -> serial << 32 | row
        self._segs: dict[int, Segment] = {}   # serial -> indexed segment
        self._n_serial = 0
        self._listeners: list = []
        self.registry = registry if registry is not None \
            else MetricsRegistry(enabled=True)
        self._c_appended = self.registry.counter("index.rows_appended")
        self._c_deleted = self.registry.counter("index.rows_deleted")
        self._c_seals = self.registry.counter("index.seals")
        self._g_live = self.registry.gauge("index.live_rows")
        self._g_dead = self.registry.gauge("index.dead_rows")
        self._g_livefrac = self.registry.gauge("index.live_fraction")
        self._g_segments = self.registry.gauge("index.segments")
        self._g_tail = self.registry.gauge("index.tail_fill")
        self._g_bytes = self.registry.gauge("index.resident_bytes")

    def _update_gauges(self):
        """Refresh the store-shape gauges after any mutation."""
        n_rows = self.n_rows
        self._g_live.set(self.n_live)
        self._g_dead.set(n_rows - self.n_live)
        self._g_livefrac.set(self.n_live / n_rows if n_rows else 1.0)
        self._g_segments.set(self.n_segments)
        self._g_tail.set(self.tail.length / self.tail_rows)
        self._g_bytes.set(self.nbytes)

    def _new_tail(self) -> Segment:
        return _empty_segment(
            self.tail_rows, self.n_words,
            self.band_spec.n_tables if self.band_spec else 0, self.device)

    # -- geometry ------------------------------------------------------------
    @property
    def n_live(self) -> int:
        """Live (not tombstoned) rows across all segments."""
        return len(self._by_id)

    @property
    def n_rows(self) -> int:
        """Resident rows, live or dead (unwritten tail slots excluded)."""
        return sum(s.length for s in self.segments())

    @property
    def n_segments(self) -> int:
        """Resident segments (sealed and the tail)."""
        return len(self.sealed) + 1

    @property
    def nbytes(self) -> int:
        """Resident bytes of the full buffers: words, hashes, masks."""
        total = 0
        for s in self.segments():
            total += s.words.numel() * 4 + s.valid.size * 4
            if s.hashes is not None:
                total += s.hashes.numel() * 4
        return total

    def segments(self) -> list[Segment]:
        """Iteration order: sealed segments in log order, then the tail."""
        return self.sealed + [self.tail]

    def __contains__(self, item_id: int) -> bool:
        return int(item_id) in self._by_id

    # -- mutation listeners --------------------------------------------------
    def add_listener(self, callback) -> "SegmentLogStore":
        """Subscribe ``callback(event, ids)`` to membership events:
        ``"delete"`` with the int64 ids just tombstoned, ``"compact"``
        with None (ids survive compaction). Returns self."""
        self._listeners.append(callback)
        return self

    def _notify(self, event: str, ids):
        for cb in self._listeners:
            cb(event, ids)

    def take_codes(self, ids) -> np.ndarray:
        """int32 codes [m, k] of live external ids (KeyError on a dead
        or unknown id)."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if not ids.size:
            return np.zeros((0, self.k), np.int32)
        words = torch.stack([seg.words[row] for seg, row in
                             map(self._locate, ids.tolist())])
        return _packing.unpack_codes(words, self.bits, self.k).cpu().numpy()

    # -- ingestion -----------------------------------------------------------
    def add_codes(self, codes, ids=None) -> np.ndarray:
        """Append int codes [m, k]; returns the external ids int64 [m].

        Auto-assigned ids continue from ``next_id``; explicit ids must not
        be live (``upsert_codes`` replaces). O(batch) in-place tail write.
        """
        shape = tuple(np.shape(codes))
        if len(shape) != 2 or shape[1] != self.k:
            raise ValueError(f"codes {shape} != [m, {self.k}]")
        ids = self._prepare_ids(ids, shape[0])
        if shape[0] == 0:
            return ids
        codes = torch.as_tensor(codes, device=self.device).to(torch.int32)
        words = _ops.pack_codes(codes, self.bits, impl=self.impl)
        hashes = (_packing.as_i32(band_hashes(codes, self.band_spec))
                  if self.band_spec else None)
        return self._append(words, hashes, ids)

    def add_words(self, words, ids=None) -> np.ndarray:
        """Append packed rows [m, W] (int32 bit-views, or numpy uint32):
        the fused-ingest path, with ``add_codes``'s id rules and O(batch)
        tail write. With a ``band_spec`` only the words holding the band
        codes are unpacked, chunk-locally, for the hashes."""
        shape = tuple(np.shape(words))
        if len(shape) != 2 or shape[1] != self.n_words:
            raise ValueError(f"words {shape} != [m, {self.n_words}]")
        ids = self._prepare_ids(ids, shape[0])
        if shape[0] == 0:
            return ids
        if isinstance(words, np.ndarray):
            words = np.ascontiguousarray(words, np.uint32).view(np.int32)
        words = torch.as_tensor(words, device=self.device)
        if words.dtype != torch.int32:
            raise ValueError(f"words must be int32 bit-views, got "
                             f"{words.dtype}")
        hashes = (_packing.as_i32(word_band_hashes(words, self.bits,
                                                   self.band_spec))
                  if self.band_spec else None)
        return self._append(words, hashes, ids)

    def _prepare_ids(self, ids, m: int) -> np.ndarray:
        """Validate or auto-assign a batch's external ids, before any
        device work, so a bad batch changes nothing."""
        if ids is None:
            ids = np.arange(self.next_id, self.next_id + m, dtype=np.int64)
        else:
            ids = np.asarray(ids, np.int64)
            if ids.shape != (m,):
                raise ValueError(f"ids {ids.shape} != ({m},)")
            if np.unique(ids).size != m:
                raise ValueError("duplicate ids within one batch")
            clash = [i for i in ids.tolist() if i in self._by_id]
            if clash:
                raise ValueError(f"ids already live (upsert instead): "
                                 f"{clash[:5]}")
        if m and (ids.min() < 0 or ids.max() >= _INT32_ID_LIMIT):
            raise ValueError("ids must fit int32 (device id gather)")
        return ids

    def _append(self, words, hashes, ids) -> np.ndarray:
        """Tail writes of validated rows, sealing each full tail."""
        m = words.shape[0]
        pos = 0
        while pos < m:
            t = min(self.tail_rows - self.tail.length, m - pos)
            self._write_tail(words, hashes, ids, pos, t)
            pos += t
            if self.tail.length == self.tail_rows:
                self._seal_tail()
        self.next_id = max(self.next_id, int(ids.max()) + 1)
        self.generation += 1
        self._c_appended.inc(m)
        self._update_gauges()
        return ids

    def _write_tail(self, words, hashes, ids, pos: int, t: int):
        # t rows land on slots [start, start + t) in place; the reference
        # pads t to a power of two to bound its jit compiles, and its pad
        # rows land on slots that are still zero, so the buffer is the same
        tail = self.tail
        start = tail.length
        tail.words[start:start + t].copy_(words[pos:pos + t])
        if hashes is not None:
            tail.hashes[start:start + t].copy_(hashes[pos:pos + t])
        tail.ids[start:start + t] = ids[pos:pos + t]
        _np_set_bits(tail.valid, start, start + t)
        self._index_rows(tail, np.arange(start, start + t))
        tail.live += t
        tail.length += t
        tail._valid_dev = None
        tail._ids_dev = None

    def _index_rows(self, seg: Segment, rows: np.ndarray):
        """Point the id map at ``seg``'s ``rows`` (an int array),
        giving the segment a serial number on first use."""
        if seg.serial is None:
            seg.serial = self._n_serial
            self._n_serial += 1
            self._segs[seg.serial] = seg
        self._by_id.update(zip(seg.ids[rows].tolist(),
                               (rows + (seg.serial << 32)).tolist()))

    def _locate(self, item: int) -> tuple[Segment, int]:
        """(segment, row) of a live id (KeyError otherwise)."""
        loc = self._by_id[item]
        return self._segs[loc >> 32], loc & 0xFFFFFFFF

    def _retire(self, seg: Segment):
        """Forget a segment that compaction replaced."""
        self._segs.pop(seg.serial, None)

    def _seal_tail(self):
        """The full tail becomes a sealed segment as it is (the id map
        keys on the Segment object, so nothing moves)."""
        self.sealed.append(self.tail)
        self.tail = self._new_tail()
        self._c_seals.inc()

    # -- deletes / upserts ---------------------------------------------------
    def delete(self, ids, strict: bool = True) -> int:
        """Tombstone external ids; returns the rows killed. Unknown ids
        raise (``strict``, before anything is tombstoned, so a raise
        leaves the store and its generation as they were) or are
        skipped."""
        ids = np.atleast_1d(np.asarray(ids, np.int64)).tolist()
        if strict:
            dead = [i for i in ids if i not in self._by_id]
            if dead:
                raise KeyError(f"ids not live: {dead[:5]}")
        pop = self._by_id.pop
        hits = [(item, loc) for item in ids
                if (loc := pop(item, None)) is not None]
        if not hits:
            return 0
        killed, locs = (np.asarray(a, np.int64) for a in zip(*hits))
        serials, rows = locs >> 32, locs & 0xFFFFFFFF
        for s in np.unique(serials).tolist():
            self._segs[s].kill_rows(rows[serials == s])
        self.generation += 1
        self._c_deleted.inc(len(hits))
        self._update_gauges()
        self._notify("delete", killed)
        return len(hits)

    def upsert_codes(self, ids, codes) -> np.ndarray:
        """Replace or insert: tombstone each id's live row, append the new
        version under the same id. The batch is validated before the
        tombstones, so a bad upsert never loses the old versions."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        shape = tuple(np.shape(codes))
        if shape != (ids.size, self.k):
            raise ValueError(f"codes {shape} != [{ids.size}, {self.k}]")
        if np.unique(ids).size != ids.size:
            raise ValueError("duplicate ids within one batch")
        if ids.size and (ids.min() < 0 or ids.max() >= _INT32_ID_LIMIT):
            raise ValueError("ids must fit int32 (device id gather)")
        self.delete([i for i in ids.tolist() if i in self._by_id])
        return self.add_codes(codes, ids=ids)

    # -- live-row views (oracle / compaction / snapshot) ---------------------
    def live_ids(self) -> np.ndarray:
        """External ids of the live rows in iteration order, int64."""
        return np.concatenate([seg.ids[seg.live_rows()]
                               for seg in self.segments()])

    def live_words(self) -> torch.Tensor:
        """Live packed rows in iteration order, int32 [n_live, W]."""
        parts = [seg.words[torch.from_numpy(rows).to(self.device)]
                 for seg in self.segments()
                 if (rows := seg.live_rows()).size]
        if not parts:
            return torch.zeros((0, self.n_words), dtype=torch.int32,
                               device=self.device)
        return torch.cat(parts)

    def live_codes(self) -> torch.Tensor:
        """Live rows unpacked, int32 codes [n_live, k]."""
        return _packing.unpack_codes(self.live_words(), self.bits, self.k)

    def stats(self) -> dict:
        """Rows (live, dead), segments, tail fill, bytes, generation."""
        return {"n_live": self.n_live, "n_rows": self.n_rows,
                "n_dead": self.n_rows - self.n_live,
                "n_segments": self.n_segments,
                "tail_len": self.tail.length, "nbytes": self.nbytes,
                "generation": self.generation}
