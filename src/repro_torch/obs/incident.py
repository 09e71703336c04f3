"""Incident bundles: self-contained forensic snapshots on trigger.

Counterpart of ``repro/obs/incident.py``. When something goes wrong — a
``DriftMonitor``/``CollisionMonitor`` alarm or an SLO burn alert fires,
an endpoint raises — the aggregate metrics say *that* it happened; this
module captures *what the system was doing*. An
``IncidentManager.capture`` dumps one self-contained bundle:

* the flight-recorder tail (``obs.events``) — the last N request events
  before the trigger;
* every trace the ``TailSampler`` currently retains (slow / error /
  flagged requests with their span chains and trace ids);
* a full ``MetricsRegistry`` snapshot (counters, gauges, histogram
  summaries);
* the quality-monitor report (collision chi-square, shadow recall,
  margins) when monitors are wired;
* the SLO engine's ``health()`` verdict (error budgets, burn rates,
  active alerts) when an ``obs.slo.SloEngine`` is wired — every bundle
  records how degraded the service believed itself to be;
* the store generation and any caller-supplied context.

Bundles persist through ``repro_torch.checkpoint`` in the reference's
format — the JSON document rides as a single uint8 leaf — so incidents
get the checkpointer's atomic rename, manifest-gated completeness and
``keep``-N retention, either package reads the other's bundles, and
``load`` restores a readable dict with no prior knowledge of the
contents (on the host: a bundle never touches the card). Numpy values
and tensors (on any device, 0-d or not) inside a context or a report
are written as plain values. ``on_drift`` matches the ``DriftMonitor``
callback contract ``(series, value, detector)`` so wiring is one
``subscribe`` call.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.checkpoint import (available_steps, latest_step,
                              read_manifest, restore_checkpoint,
                              save_checkpoint)
from repro_torch.obs.events import FlightRecorder, default_flight_recorder
from repro_torch.obs.registry import MetricsRegistry, default_registry

__all__ = ["IncidentManager"]

_LEAF = "bundle_json"


def _jsonable(x):
    # numpy scalars/arrays and tensors (any device) inside trace args or
    # context survive as plain values; anything exotic degrades to its
    # repr, never raises
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.item() if x.dim() == 0 else x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return repr(x)


class IncidentManager:
    """Capture/restore incident bundles for one observability scope.

    ``directory`` is where bundles land (checkpoint steps = incident
    numbers, ``keep`` most recent kept). ``flight`` / ``sampler`` /
    ``registry`` / ``quality`` are the sources snapshotted at capture
    time; all optional — missing sources leave empty sections, so the
    manager works at any wiring depth. ``generation_fn`` supplies the
    live store generation (the serving layer passes a lambda over its
    engine).
    """

    def __init__(self, directory: str, flight: FlightRecorder = None,
                 sampler=None, registry: MetricsRegistry = None,
                 quality=None, slo=None, generation_fn=None, keep: int = 8,
                 tail_n: int = 512):
        self.directory = str(directory)
        self.flight = flight
        self.sampler = sampler
        self.registry = registry
        self.quality = quality
        self.slo = slo                    # obs.slo.SloEngine (optional)
        self.generation_fn = generation_fn
        self.keep = int(keep)
        self.tail_n = int(tail_n)
        self.captured = 0                 # incidents captured (and step id)

    def _flight(self) -> FlightRecorder:
        return self.flight if self.flight is not None \
            else default_flight_recorder()

    def bundle(self, kind: str, reason: str, context: dict = None) -> dict:
        """Assemble (but do not persist) one incident bundle dict."""
        reg = self.registry if self.registry is not None \
            else default_registry()
        gen = self.generation_fn() if self.generation_fn is not None \
            else -1
        return {
            "incident": self.captured + 1,
            "kind": str(kind),
            "reason": str(reason),
            "context": context or {},
            "generation": int(gen),
            "events": self._flight().tail(self.tail_n),
            "traces": (self.sampler.retained_traces()
                       if self.sampler is not None else []),
            "registry": reg.snapshot(),
            "quality": (self.quality.report()
                        if self.quality is not None else {}),
            "slo": (self.slo.health()
                    if self.slo is not None else {}),
        }

    def capture(self, kind: str, reason: str, context: dict = None) -> str:
        """Dump one bundle; returns the checkpoint path. Never raises
        into the caller's request path: a failure to assemble or persist
        the bundle degrades to an ``obs.incident.capture_errors``
        counter — an incident dump must not turn one failing request
        into two."""
        try:
            b = self.bundle(kind, reason, context)
            blob = json.dumps(b, default=_jsonable).encode()
            leaf = np.frombuffer(blob, dtype=np.uint8)
            self.captured += 1
            path = save_checkpoint(self.directory, self.captured,
                                   {_LEAF: leaf}, keep=self.keep)
        except Exception:
            reg = self.registry if self.registry is not None \
                else default_registry()
            reg.counter("obs.incident.capture_errors").inc()
            return ""
        reg = self.registry if self.registry is not None \
            else default_registry()
        reg.counter("obs.incident.captured").inc()
        return path

    def on_drift(self, series: str, value: float, detector):
        """``DriftMonitor`` callback adapter: every alarm captures a
        ``kind="drift"`` bundle with the firing series, value, and
        detector direction/alarm count as context."""
        self.capture("drift", f"{series} drifted",
                     {"series": series, "value": float(value),
                      "side": getattr(detector, "side", ""),
                      "alarms": getattr(detector, "alarms", 0)})

    # -- restore --------------------------------------------------------------
    def steps(self):
        """Incident numbers currently on disk, oldest first."""
        return available_steps(self.directory)

    def load(self, step: int = None) -> dict:
        """Read one persisted bundle back into a dict (default: the
        most recent); KeyError when none exist."""
        if step is None:
            step = latest_step(self.directory)
            if step is None:
                raise KeyError(f"no incidents in {self.directory}")
        man = read_manifest(self.directory, step)
        entry = next(e for e in man["leaves"]
                     if e["name"] == f"['{_LEAF}']")
        like = {_LEAF: np.zeros(tuple(entry["shape"]), np.uint8)}
        tree = restore_checkpoint(self.directory, step, like, device="cpu")
        return json.loads(tree[_LEAF].numpy().tobytes().decode())
