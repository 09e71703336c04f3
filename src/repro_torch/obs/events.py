"""Flight recorder: a preallocated ring buffer of per-request events.

Counterpart of ``repro/obs/events.py``, the same code.

Histograms (``obs.registry``) answer "what is p99?"; they cannot answer
"*which* request was slow, and what was it doing?". This module is the
forensic layer: every request-scoped operation (a serving flush batch, a
classify call, an ingest, an engine search, a kernel dispatch) appends
one structured event — op, queue/start/end timestamps, batch shape,
cache hits, store generation, outcome, trace id — into a fixed-capacity
ring of preallocated slots. Append is O(1) (one tuple build + one slot
store + one integer bump), allocation-bounded, and cheap enough to stay
on in production; the ring holds the last ``capacity``
events whatever the uptime, so an incident bundle (``obs.incident``)
always has the minutes-before story.

Timestamps reuse the ``sp.sync`` boundary invariant of ``obs.trace``:
an event's ``synced`` flag records whether ``t_end`` was taken after a
device sync (``torch.cuda.synchronize`` under a deep tracer, or a
host transfer) — ``synced=False``
durations are *submission* times and are labelled as such, never
presented as execution times.

There is a process-global default recorder (on by default, the
always-on contract) plus injectable per-component instances — the same
pattern as ``MetricsRegistry``. A recorder built with ``enabled=False``
makes ``record`` a constant-time no-op.
"""
from __future__ import annotations

import time

__all__ = ["FlightRecorder", "EVENT_FIELDS", "default_flight_recorder",
           "set_flight_recorder"]

#: slot layout of one event tuple, in storage order
EVENT_FIELDS = ("seq", "op", "t_queue", "t_start", "t_end", "batch",
                "cache_hits", "generation", "outcome", "trace_id",
                "synced")


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class FlightRecorder:
    """Fixed-slot ring of request events; O(1) append, O(capacity) read.

    ``capacity`` rounds up to a power of two (slot index is one mask).
    ``seq`` increases monotonically forever; slot ``seq & mask`` is
    overwritten on wrap, so the ring always holds the newest
    ``capacity`` events. Readers (``tail``/``snapshot``) rebuild plain
    dicts — the hot path never allocates one.
    """

    __slots__ = ("capacity", "enabled", "_mask", "_slots", "seq")

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = _pow2(int(capacity))
        self._mask = self.capacity - 1
        self._slots = [None] * self.capacity
        self.seq = 0
        self.enabled = enabled

    def record(self, op: str, t_start: float, t_end: float, *,
               t_queue: float = 0.0, batch: int = 0, cache_hits: int = 0,
               generation: int = -1, outcome: str = "ok",
               trace_id: int = 0, synced: bool = False) -> int:
        """Append one event; returns its ``seq`` (-1 when disabled).

        ``t_queue``/``t_start``/``t_end`` are ``time.perf_counter``
        values (0.0 = not applicable); ``synced`` asserts ``t_end`` was
        taken after a device sync (the ``sp.sync`` boundary invariant —
        leave False for submission-time events).
        """
        if not self.enabled:
            return -1
        seq = self.seq
        self._slots[seq & self._mask] = (
            seq, op, t_queue, t_start, t_end, batch, cache_hits,
            generation, outcome, trace_id, synced)
        self.seq = seq + 1
        return seq

    def record_kernel(self, family: str, traced: bool) -> int:
        """Minimal-cost append for a kernel dispatch (the
        ``kernels/ops.py`` chokepoint, via ``obs.kernelstats``): a
        point event ``kernel.<family>``; ``outcome`` records whether
        the dispatch happened under a trace ("traced"; the port has
        none, so its dispatches are always "ok")."""
        if not self.enabled:
            return -1
        seq = self.seq
        t = time.perf_counter()
        self._slots[seq & self._mask] = (
            seq, "kernel." + family, 0.0, t, t, 0, 0, -1,
            "traced" if traced else "ok", 0, False)
        self.seq = seq + 1
        return seq

    def __len__(self) -> int:
        """Events currently resident (≤ capacity)."""
        return min(self.seq, self.capacity)

    @property
    def wrapped(self) -> bool:
        """Whether the ring has overwritten at least one slot."""
        return self.seq > self.capacity

    @property
    def dropped(self) -> int:
        """Events overwritten by wraparound — derived from ``seq`` at
        read time so the append path carries zero drop bookkeeping."""
        return max(0, self.seq - self.capacity)

    def tail(self, n: int = None):
        """The newest ``n`` events (default: all resident) as dicts,
        oldest first — the slice an incident bundle captures."""
        have = len(self)
        n = have if n is None else min(int(n), have)
        first = self.seq - n
        return [dict(zip(EVENT_FIELDS, self._slots[s & self._mask]))
                for s in range(first, self.seq)]

    def snapshot(self):
        """Every resident event as dicts, oldest first."""
        return self.tail()

    def events(self, op: str = None):
        """Resident events filtered by exact ``op`` (oldest first)."""
        evs = self.tail()
        return evs if op is None else [e for e in evs if e["op"] == op]

    def reset(self):
        """Drop every event (slots stay preallocated)."""
        self._slots = [None] * self.capacity
        self.seq = 0


_DEFAULT = FlightRecorder(capacity=4096, enabled=True)


def default_flight_recorder() -> FlightRecorder:
    """The process-global flight recorder (on by default — the
    always-on contract; components may take injected instances)."""
    return _DEFAULT


def set_flight_recorder(fr: FlightRecorder) -> FlightRecorder:
    """Swap the process-global recorder; returns the previous one."""
    global _DEFAULT
    prev = _DEFAULT
    _DEFAULT = fr
    return prev
