"""Zero-dependency ops dashboard: one snapshot, two renderers.

Counterpart of ``repro/obs/dashboard.py``: one snapshot dict renders to
the same text and page in both packages. The one difference: the
roofline rows' bytes come from the ``hbm_bytes`` that
``obs.kernelstats`` records (the reference reads a ``bytes`` key its
kernel stats never write, so its column shows "-"), and the roofline is
the port's H100 model (``kernelstats.HW``).

Everything the closed-loop health layer knows — SLO budgets and burn
sparklines, the flight-ring tail, the modeled roofline, quality series,
resource gauges — collapses into one plain-dict snapshot (``gather``)
and renders two ways from it:

* ``render_text`` — a fixed-width terminal view for ``watch``-style
  operation and test assertions;
* ``render_html`` — a static, self-contained HTML page (inline CSS, no
  scripts, no external assets) for CI artifact upload — every CI run
  leaves behind the page an operator would have been looking at.

``write_dashboard`` writes the page *atomically* (tmp file + rename in
the target directory) so a crash or a concurrent artifact scrape never
observes a torn page. Rendering is strictly read-only over the
snapshot: a dashboard render never mutates a metric, ledger, or ring
(the one deliberate exception: ``gather`` refreshes resource gauges via
``ResourceMonitor.collect`` when you hand it a monitor, because
resource numbers are pull-only).

Sparklines are unicode block glyphs over each ledger's recent
fast-window burn-rate series (the ``spark`` deque the ``SloEngine``
maintains per tick) — scale is per-line max, annotated at the end, so
a flat healthy line and a spiking one read correctly side by side.
"""
from __future__ import annotations

import html as _html
import math
import os
import tempfile

from repro_torch.obs import kernelstats as _ks
from repro_torch.obs.registry import MetricsRegistry, default_registry

__all__ = ["gather", "render_text", "render_html", "write_dashboard"]

_BLOCKS = "▁▂▃▄▅▆▇█"


def _spark(values, width: int = 32) -> str:
    """Unicode sparkline of the last ``width`` values, scaled to the
    line's own max (empty series -> empty string)."""
    vals = [v for v in list(values)[-width:]
            if isinstance(v, (int, float)) and v == v]
    if not vals:
        return ""
    hi = max(max(vals), 1e-12)
    return "".join(_BLOCKS[min(len(_BLOCKS) - 1,
                               int(v / hi * (len(_BLOCKS) - 1)))]
                   for v in vals)


def _fmt_bytes(b) -> str:
    if not isinstance(b, (int, float)) or b != b:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(b) < 1024.0 or unit == "TiB":
            return f"{b:.1f}{unit}" if unit != "B" else f"{int(b)}B"
        b /= 1024.0
    return "-"


def _fmt_s(v) -> str:
    if not isinstance(v, (int, float)) or v != v:
        return "-"
    if v >= 1.0:
        return f"{v:.2f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.2f}ms"
    return f"{v * 1e6:.0f}us"


def gather(registry: MetricsRegistry = None, slo=None, flight=None,
           quality=None, resources=None, kernels=None, hw=None,
           tail_n: int = 20) -> dict:
    """One read-only snapshot of everything renderable.

    Every component is optional — pass what the deployment has wired
    and the corresponding section appears; the rest stay absent. The
    snapshot is plain dicts/lists (json-serializable apart from NaN),
    so it can also ride inside an incident bundle. ``kernels`` defaults
    to the process-wide kernel stats and ``hw`` to their H100 model.
    """
    reg = registry if registry is not None else default_registry()
    snap = {"registry": reg.snapshot()}
    if slo is not None:
        snap["health"] = slo.health()
    if flight is not None:
        snap["flight"] = {"tail": flight.tail(tail_n),
                          "dropped": flight.dropped}
    if quality is not None:
        snap["quality"] = quality.report()
    if resources is not None:
        snap["resources"] = resources.collect()
    if kernels is None:
        kernels = _ks.get_kernel_stats()
    try:
        snap["roofline"] = kernels.roofline_table(hw)
    except Exception:
        pass
    return snap


# -- section builders (shared by both renderers) -----------------------------

def _slo_rows(health: dict):
    rows = []
    for name, b in sorted(health.get("slos", {}).items()):
        rows.append({
            "name": name,
            "objective": f"{b['objective']:.4g}",
            "burn_fast": f"{b['burn_fast']:.2f}",
            "burn_short": f"{b['burn_short']:.2f}",
            "budget": f"{b['budget_remaining'] * 100:.1f}%",
            "state": ("ALERT" if b["alerting"]
                      else f"ok ({b['alarms']} past)" if b["alarms"]
                      else "ok"),
            "spark": _spark(b.get("spark", ())),
            "spark_max": (f"{max(b['spark']):.2f}" if b.get("spark")
                          else ""),
            "alerting": b["alerting"],
        })
    return rows


def _flight_rows(flight: dict):
    rows = []
    for ev in flight.get("tail", ()):
        t0, t1 = ev.get("t_start", math.nan), ev.get("t_end", math.nan)
        rows.append({
            "op": str(ev.get("op", "?")),
            "dur": _fmt_s(t1 - t0),
            "batch": str(ev.get("batch", "")),
            "outcome": str(ev.get("outcome", "")),
            "trace": format(ev.get("trace_id", 0) or 0, "x")[:16],
        })
    return rows


def _roofline_rows(roof: dict):
    rows = []
    for fam, r in sorted(roof.items()):
        rows.append({
            "family": fam,
            "calls": str(r.get("calls", "")),
            "bytes": _fmt_bytes(r.get("hbm_bytes", math.nan)),
            "intensity": (f"{r['intensity']:.2f}"
                          if isinstance(r.get("intensity"), float)
                          and r["intensity"] == r["intensity"] else "-"),
            "bound": str(r.get("bound", "")),
            "t_model": _fmt_s(r.get("t_model_s", math.nan)),
        })
    return rows


def _resource_rows(res: dict):
    rows = [{"what": f"store:{k}", "value": _fmt_bytes(v)}
            for k, v in sorted(res.get("tracked", {}).items())]
    rows.append({"what": "tracked total",
                 "value": _fmt_bytes(res.get("tracked_total"))})
    for k, v in sorted(res.get("device", {}).items()):
        rows.append({"what": f"device:{k}", "value": _fmt_bytes(v)})
    for k, v in sorted(res.get("host", {}).items()):
        rows.append({"what": f"host:{k}", "value": _fmt_bytes(v)})
    rows.append({"what": "jit compiles",
                 "value": str(res.get("jit_compiles", "-"))})
    rows.append({"what": "compiles since mark",
                 "value": str(res.get("compiles_since_mark", "-"))})
    return rows


def _latency_rows(registry_snap: dict):
    rows = []
    for name, s in sorted(registry_snap.get("histograms", {}).items()):
        if not s.get("count"):
            continue
        rows.append({"series": name, "count": str(s["count"]),
                     "p50": _fmt_s(s.get("p50")),
                     "p95": _fmt_s(s.get("p95")),
                     "p99": _fmt_s(s.get("p99")),
                     "max": _fmt_s(s.get("max"))})
    return rows


def _table_text(rows, cols, out):
    if not rows:
        return
    widths = {c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in cols}
    out.append("  " + "  ".join(c.ljust(widths[c]) for c in cols))
    for r in rows:
        out.append("  " + "  ".join(
            str(r.get(c, "")).ljust(widths[c]) for c in cols))


def render_text(snap: dict) -> str:
    """Fixed-width terminal view of one ``gather`` snapshot."""
    out = []
    health = snap.get("health")
    if health is not None:
        status = health["status"].upper()
        out.append(f"== health: {status}"
                   + (f"  shed={health['shed_fraction']:.2f}"
                      if health["shed_fraction"] else ""))
        if health["alerts"]:
            out.append("  active alerts: " + ", ".join(health["alerts"]))
        rows = _slo_rows(health)
        for r in rows:
            r["burn"] = f"{r['burn_fast']}/{r['burn_short']}"
            r["sparkline"] = (f"{r['spark']} max={r['spark_max']}"
                              if r["spark"] else "")
        _table_text(rows, ("name", "objective", "burn", "budget",
                           "state", "sparkline"), out)
    rows = _latency_rows(snap.get("registry", {}))
    if rows:
        out.append("== latency")
        _table_text(rows, ("series", "count", "p50", "p95", "p99",
                           "max"), out)
    res = snap.get("resources")
    if res is not None:
        out.append("== resources")
        _table_text(_resource_rows(res), ("what", "value"), out)
    roof = snap.get("roofline")
    if roof:
        out.append("== roofline")
        _table_text(_roofline_rows(roof), ("family", "calls", "bytes",
                                           "intensity", "bound",
                                           "t_model"), out)
    q = snap.get("quality")
    if q:
        out.append("== quality")
        for k, v in sorted(q.items()):
            out.append(f"  {k}: {v}")
    fl = snap.get("flight")
    if fl is not None:
        out.append(f"== flight tail (dropped={fl.get('dropped', 0)})")
        _table_text(_flight_rows(fl), ("op", "dur", "batch",
                                       "outcome", "trace"), out)
    return "\n".join(out) + "\n"


def _table_html(rows, cols, out, classes=None):
    if not rows:
        return
    out.append("<table><tr>"
               + "".join(f"<th>{_html.escape(c)}</th>" for c in cols)
               + "</tr>")
    for r in rows:
        cls = classes(r) if classes else ""
        out.append((f'<tr class="{cls}">' if cls else "<tr>")
                   + "".join(f"<td>{_html.escape(str(r.get(c, '')))}"
                             f"</td>" for c in cols)
                   + "</tr>")
    out.append("</table>")


_CSS = """
body{font-family:ui-monospace,Menlo,Consolas,monospace;background:#111;
color:#ddd;margin:1.5em}
h1{font-size:1.2em} h2{font-size:1em;border-bottom:1px solid #333;
padding-bottom:.2em;margin-top:1.4em}
table{border-collapse:collapse;margin:.5em 0}
th,td{padding:.15em .7em;text-align:left;font-size:.85em}
th{color:#8af;border-bottom:1px solid #333}
tr:nth-child(even){background:#181818}
tr.alert td{color:#f66;font-weight:bold}
.ok{color:#6d6} .degraded{color:#f66}
.spark{color:#fa0;letter-spacing:-1px}
"""


def render_html(snap: dict) -> str:
    """Static self-contained HTML page of one ``gather`` snapshot
    (inline CSS, no scripts — safe as a CI artifact)."""
    out = ["<!doctype html><html><head><meta charset='utf-8'>"
           "<title>serving health</title>"
           f"<style>{_CSS}</style></head><body>",
           "<h1>serving health</h1>"]
    health = snap.get("health")
    if health is not None:
        cls = "degraded" if health["status"] != "ok" else "ok"
        out.append(f"<p>status: <b class='{cls}'>"
                   f"{_html.escape(health['status'])}</b>")
        if health["shed_fraction"]:
            out.append(f" · advisory shed fraction "
                       f"{health['shed_fraction']:.2f}")
        if health["alerts"]:
            out.append(" · alerts: "
                       + _html.escape(", ".join(health["alerts"])))
        out.append("</p><h2>SLO budgets</h2>")
        rows = _slo_rows(health)
        for r in rows:
            r["burn fast/short"] = f"{r['burn_fast']} / {r['burn_short']}"
            r["burn history"] = (f"{r['spark']} ≤{r['spark_max']}"
                                 if r["spark"] else "")
        _table_html(rows, ("name", "objective", "burn fast/short",
                           "budget", "state", "burn history"), out,
                    classes=lambda r: "alert" if r["alerting"] else "")
    rows = _latency_rows(snap.get("registry", {}))
    if rows:
        out.append("<h2>latency</h2>")
        _table_html(rows, ("series", "count", "p50", "p95", "p99",
                           "max"), out)
    res = snap.get("resources")
    if res is not None:
        out.append("<h2>resources</h2>")
        _table_html(_resource_rows(res), ("what", "value"), out)
    roof = snap.get("roofline")
    if roof:
        out.append("<h2>roofline (modeled)</h2>")
        _table_html(_roofline_rows(roof), ("family", "calls", "bytes",
                                           "intensity", "bound",
                                           "t_model"), out)
    q = snap.get("quality")
    if q:
        out.append("<h2>quality</h2><table>")
        for k, v in sorted(q.items()):
            out.append(f"<tr><th>{_html.escape(str(k))}</th>"
                       f"<td>{_html.escape(str(v))}</td></tr>")
        out.append("</table>")
    fl = snap.get("flight")
    if fl is not None:
        out.append(f"<h2>flight tail "
                   f"(dropped={int(fl.get('dropped', 0))})</h2>")
        _table_html(_flight_rows(fl), ("op", "dur", "batch",
                                       "outcome", "trace"), out)
    out.append("</body></html>")
    return "".join(out)


def write_dashboard(path: str, snap: dict = None, **components) -> str:
    """Render and atomically write the HTML dashboard to ``path``.

    Either pass a pre-built ``snap`` or the ``gather`` components as
    keywords (``registry=``, ``slo=``, ``flight=``, ...). The page is
    written to a temp file in the target directory then renamed — a
    reader (CI artifact scrape, browser refresh) never sees a torn
    page. Returns ``path``.
    """
    if snap is None:
        snap = gather(**components)
    page = render_html(snap)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(page)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path
