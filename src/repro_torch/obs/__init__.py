"""Observability: metrics, traces, flight events, kernel stats, health.

Counterpart of ``repro.obs``, with the same names:

registry    — ``MetricsRegistry``: counters, gauges, fixed-log-bucket
              histograms (p50/p95/p99 without storing samples);
              process-global default + injectable instances; a disabled
              registry hands out no-op metrics
trace       — ``Tracer``/``span``: nestable spans with device-sync-
              correct timing (``sp.sync`` = ``torch.cuda.synchronize``
              under a deep tracer; unsynced spans are *marked* async)
              and Chrome-trace/Perfetto export; ``RequestTrace`` and
              ``TailSampler`` for retain-on-tail request tracing
events      — ``FlightRecorder``: always-on preallocated ring buffer of
              structured per-request events
kernelstats — per-kernel-family dispatch counts + modeled FLOPs/bytes
              recorded at the ``kernels/ops.py`` chokepoint; live
              roofline table against an H100 model
export      — one-call JSON snapshot + Prometheus text format
quality     — online statistical health: sampled empirical collision/
              cell frequencies vs. the paper's theory curves at the MLE
              rho (z-scores, chi-square divergence) + classifier-margin
              moments, all budgeted by one sampling rate
shadow      — seeded reservoir of raw rows (capped, tombstone-aware) +
              shadow queries re-scored by exact cosine: unbiased online
              recall@k and rho-estimation error with Wilson intervals
drift       — Page-Hinkley/CUSUM detectors over the monitored series;
              registered callbacks fire on alarm
incident    — ``IncidentManager``: on a drift alarm, burn-rate alarm or
              endpoint error, dump a self-contained bundle (flight tail,
              retained traces, registry snapshot, quality state, SLO
              health, store generation) through ``repro_torch.checkpoint``
              in the reference's format; restores to a readable dict
slo         — ``SloEngine``: declarative per-endpoint ``SloSpec``s
              (latency/availability/quality), rolling multi-window error
              budgets from cumulative-counter snapshots, multi-window
              multi-burn-rate alerts on the ``DriftMonitor`` callback
              contract, and the machine-readable ``health()`` verdict
probe       — ``CanaryProber``: deterministic known-answer canaries drawn
              from the shadow reservoir, replayed through the service's
              probe endpoints with telemetry segregated; verdicts feed
              the SLO quality budgets
resources   — ``ResourceMonitor``: bytes of tracked stores, the CUDA
              caching allocator's bytes in use and peak per card, host
              RSS, and the process-wide compile counter (the ``nvcc``
              calls of ``kernels._build``) behind the never-recompile
              invariant
dashboard   — one ``gather`` snapshot rendered as terminal text or a
              static self-contained HTML page (SLO budgets and burn
              sparklines, latency, resources, the H100 roofline,
              quality, flight tail), written atomically
"""
from repro_torch.obs.registry import (Counter, Gauge, Histogram,  # noqa: F401
                                      HistogramSpec, MetricsRegistry,
                                      default_registry, set_default_registry)
from repro_torch.obs.trace import (RequestTrace, Span,  # noqa: F401
                                   TailSampler, Tracer, active_tracer,
                                   deep_tracing_active, no_tracing, span,
                                   tracing_active)
from repro_torch.obs.events import (EVENT_FIELDS,  # noqa: F401
                                    FlightRecorder, default_flight_recorder,
                                    set_flight_recorder)
from repro_torch.obs.kernelstats import (HW, KernelStats,  # noqa: F401
                                         get_kernel_stats, roofline_table,
                                         set_kernel_stats)
from repro_torch.obs.export import dump_json, snapshot, to_prometheus  # noqa: F401
from repro_torch.obs.quality import (CollisionMonitor,  # noqa: F401
                                     MarginMonitor, QualityConfig,
                                     QualityMonitors, Welford,
                                     synthetic_code_pairs)
from repro_torch.obs.shadow import (RecallMonitor,  # noqa: F401
                                    ShadowReservoir, wilson_interval)
from repro_torch.obs.drift import Cusum, DriftMonitor, PageHinkley  # noqa: F401
from repro_torch.obs.slo import (AlertState, BurnPolicy,  # noqa: F401
                                 DEFAULT_POLICIES, SloEngine, SloSpec)
from repro_torch.obs.incident import IncidentManager  # noqa: F401
from repro_torch.obs.probe import CanaryProber, ProbeConfig  # noqa: F401
from repro_torch.obs.resources import (ResourceMonitor,  # noqa: F401
                                       install_compile_counter,
                                       jit_compiles)
from repro_torch.obs.dashboard import (gather, render_html,  # noqa: F401
                                       render_text, write_dashboard)
