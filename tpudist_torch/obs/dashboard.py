"""Trend dashboard: the port's copy of ``tpudist/obs/dashboard.py``.

One zero-dependency HTML page (inline-SVG sparklines, no script, no
fetch), served live at ``/dashboard`` by the launcher's fleet
``MetricsServer`` (a ``<meta refresh>`` is the whole "live" mechanism).
It draws the fleet time series of ``obs.tsdb`` and, given a bench history
file, one panel per series with tpudist's trailing-median gate band
(``analyze_history`` below is a copy of ``tpudist/regress.py``'s).

The port has no bench history of its own yet, so the launcher's page
draws none: it never reads the JAX package's ``benchmarks/results``,
whose numbers were taken on a TPU. tpudist's incidents panel draws its
flight recorder's bundles, which the port does not have.
"""

from __future__ import annotations

import html
import json
from typing import Optional

from tpudist_torch.obs import tsdb
from tpudist_torch.telemetry import percentile

# -- the bench-history gate (a copy of tpudist/regress.py's) -------------------

def load_history(path: str) -> list[dict]:
    """All parseable, non-stale rows, file order (= append order)."""
    rows: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(row, dict) or row.get("stale") \
                        or row.get("provisional"):
                    continue
                if row.get("metric") and isinstance(row.get("value"),
                                                    (int, float)):
                    rows.append(row)
    except OSError:
        pass
    return rows


def _series_key(row: dict) -> tuple:
    return (row.get("metric"), row.get("per_device_batch"))


def analyze_history(rows: list[dict], metric: Optional[str] = None,
                    window: int = 5, threshold: float = 0.10,
                    min_history: int = 1) -> dict:
    """Gate verdict for one series' newest row against the median of its
    ``window`` predecessors: ``status`` in {"pass", "regression",
    "no_history", "no_baseline"}, and ``reasons`` naming each tripped
    dimension (the value in the series' direction, MFU, collective
    bytes)."""
    cands = rows if metric is None \
        else [r for r in rows if r.get("metric") == metric]
    if not cands:
        return {"status": "no_history", "metric": metric, "n_history": 0}
    key = _series_key(cands[-1])
    metric = cands[-1]["metric"]
    group = [r for r in rows if _series_key(r) == key]
    newest, prior = group[-1], group[:-1][-window:]
    out: dict = {"status": "pass", "metric": metric,
                 "per_device_batch": newest.get("per_device_batch"),
                 "value": newest["value"],
                 "n_history": len(group) - 1, "window": len(prior),
                 "threshold": threshold, "reasons": [],
                 "measured_at": newest.get("measured_at")}
    if len(prior) < min_history:
        out["status"] = "no_baseline"
        return out
    base_v = percentile([r["value"] for r in prior], 50)
    out["baseline_value"] = round(base_v, 2)
    out["ratio"] = round(newest["value"] / base_v, 4) if base_v else None
    lower_better = bool(newest.get("lower_is_better",
                                   newest.get("unit") == "ms"))
    out["lower_is_better"] = lower_better
    if lower_better:
        if base_v and newest["value"] > (1.0 + threshold) * base_v:
            out["status"] = "regression"
            out["reasons"].append(
                f"{newest.get('unit', 'value')} {newest['value']:.3f} is "
                f"{(newest['value'] / base_v - 1):.1%} above the trailing "
                f"median {base_v:.3f} (n={len(prior)})")
    elif base_v and newest["value"] < (1.0 - threshold) * base_v:
        out["status"] = "regression"
        out["reasons"].append(
            f"{newest.get('unit') or 'images/sec'} {newest['value']:.1f} "
            f"is {(1 - newest['value'] / base_v):.1%} below the trailing "
            f"median {base_v:.1f} (n={len(prior)})")
    prior_mfu = [r["mfu"] for r in prior
                 if isinstance(r.get("mfu"), (int, float))]
    if isinstance(newest.get("mfu"), (int, float)) and \
            len(prior_mfu) >= min_history:
        base_m = percentile(prior_mfu, 50)
        out["mfu"] = newest["mfu"]
        out["baseline_mfu"] = round(base_m, 4)
        if base_m and newest["mfu"] < (1.0 - threshold) * base_m:
            out["status"] = "regression"
            out["reasons"].append(
                f"MFU {newest['mfu']:.4f} is "
                f"{(1 - newest['mfu'] / base_m):.1%} below the trailing "
                f"median {base_m:.4f} (n={len(prior_mfu)})")
    prior_cb = [r["collective_bytes_per_step"] for r in prior
                if isinstance(r.get("collective_bytes_per_step"),
                              (int, float))]
    if isinstance(newest.get("collective_bytes_per_step"), (int, float)) \
            and len(prior_cb) >= min_history:
        base_b = percentile(prior_cb, 50)
        out["collective_bytes_per_step"] = newest[
            "collective_bytes_per_step"]
        out["baseline_collective_bytes"] = round(base_b, 1)
        if base_b and newest["collective_bytes_per_step"] \
                > (1.0 + threshold) * base_b:
            out["status"] = "regression"
            out["reasons"].append(
                f"collective bytes/step "
                f"{newest['collective_bytes_per_step']:.3e} is "
                f"{(newest['collective_bytes_per_step'] / base_b - 1):.1%} "
                f"above the trailing median {base_b:.3e} "
                f"(n={len(prior_cb)})")
    return out


_STYLE = """
body{font-family:ui-monospace,Menlo,Consolas,monospace;margin:1.2em;
     background:#11151a;color:#d7dde4}
h1{font-size:1.25em} h2{font-size:1.05em;margin:1.2em 0 .4em;
     border-bottom:1px solid #2a3340;padding-bottom:.2em}
.panels{display:flex;flex-wrap:wrap;gap:10px}
.panel{border:1px solid #2a3340;border-radius:6px;padding:8px 10px;
       background:#171c23;min-width:340px}
.panel.regression{border-color:#e05252}
.panel h3{margin:0 0 4px;font-size:.85em;font-weight:normal;color:#9fb0c0}
.panel .num{font-size:.8em;color:#7d8b99}
.flag{color:#e05252;font-weight:bold}
.ok{color:#5fb86a} .noband{color:#b8a15f}
svg{display:block}
footer{margin-top:1.5em;color:#566270;font-size:.75em}
"""

SPARK_W, SPARK_H, _PAD = 320, 64, 4


def _spark(values: list[float], band: Optional[tuple] = None,
           baseline: Optional[float] = None,
           regression: bool = False) -> str:
    """Inline-SVG sparkline: value polyline over equal-spaced x, optional
    shaded gate band + baseline rule drawn on the same y scale."""
    if not values:
        return f'<svg width="{SPARK_W}" height="{SPARK_H}"></svg>'
    lo, hi = min(values), max(values)
    if band:
        lo, hi = min(lo, band[0]), max(hi, band[1])
    if baseline is not None:
        lo, hi = min(lo, baseline), max(hi, baseline)
    span = (hi - lo) or 1.0

    def y(v: float) -> float:
        return round(_PAD + (SPARK_H - 2 * _PAD) * (hi - v) / span, 1)

    def x(i: int) -> float:
        n = max(1, len(values) - 1)
        return round(_PAD + (SPARK_W - 2 * _PAD) * i / n, 1)

    parts = [f'<svg width="{SPARK_W}" height="{SPARK_H}" '
             f'viewBox="0 0 {SPARK_W} {SPARK_H}">']
    if band:
        top, bot = y(band[1]), y(band[0])
        parts.append(
            f'<rect class="band" x="{_PAD}" y="{top}" '
            f'width="{SPARK_W - 2 * _PAD}" height="{max(1.0, bot - top)}" '
            f'fill="#2f6e3a" fill-opacity="0.25"/>')
    if baseline is not None:
        yb = y(baseline)
        parts.append(
            f'<line class="baseline" x1="{_PAD}" y1="{yb}" '
            f'x2="{SPARK_W - _PAD}" y2="{yb}" stroke="#5fb86a" '
            f'stroke-dasharray="3,3" stroke-width="1"/>')
    pts = " ".join(f"{x(i)},{y(v)}" for i, v in enumerate(values))
    color = "#e05252" if regression else "#6aa7e8"
    parts.append(f'<polyline points="{pts}" fill="none" '
                 f'stroke="{color}" stroke-width="1.5"/>')
    cx, cy = x(len(values) - 1), y(values[-1])
    parts.append(f'<circle cx="{cx}" cy="{cy}" r="2.5" fill="{color}"/>')
    parts.append("</svg>")
    return "".join(parts)


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def history_series(rows: list[dict]) -> dict:
    """Group history rows into regress's series identity, append order
    preserved: ``{(metric, per_device_batch): [row, ...]}``."""
    out: dict = {}
    for r in rows:
        out.setdefault((r.get("metric"), r.get("per_device_batch")),
                       []).append(r)
    return out


def _history_panel(key: tuple, series: list[dict], window: int,
                   threshold: float) -> str:
    metric, pdb = key
    # The gate's own math, on this series alone: analyze_history keys off
    # the sub-list's last row, and every row here shares its series key.
    v = analyze_history(series, window=window, threshold=threshold)
    status = v.get("status", "no_history")
    base = v.get("baseline_value")
    band = None
    if isinstance(base, (int, float)):
        band = (round(base * (1.0 - threshold), 4),
                round(base * (1.0 + threshold), 4))
    values = [float(r["value"]) for r in series]
    title = html.escape(str(metric))
    if pdb is not None:
        title += f" · b{pdb}"
    attrs = (f'data-metric="{html.escape(str(metric), quote=True)}" '
             f'data-status="{status}"')
    if pdb is not None:
        attrs += f' data-pdb="{pdb}"'
    if band:
        attrs += (f' data-baseline="{_fmt(base)}"'
                  f' data-band-lo="{_fmt(band[0])}"'
                  f' data-band-hi="{_fmt(band[1])}"')
    if status == "regression":
        verdict = ('<span class="flag">REGRESSION: '
                   + html.escape("; ".join(v.get("reasons", []))) + "</span>")
    elif status == "pass":
        verdict = '<span class="ok">pass</span>'
    else:
        verdict = f'<span class="noband">{status}</span>'
    unit = html.escape(str(series[-1].get("unit") or ""))
    return (
        f'<div class="panel {status}" {attrs}>'
        f"<h3>{title}</h3>"
        + _spark(values, band=band,
                 baseline=base if isinstance(base, (int, float)) else None,
                 regression=status == "regression")
        + f'<p class="num">latest {_fmt(values[-1])} {unit} · '
          f"median {_fmt(base)} · band {_fmt(band[0]) if band else '-'}"
          f"–{_fmt(band[1]) if band else '-'} · n={len(series)} · "
        + verdict + "</p></div>")


def _live_panels(live_rows: list[dict], window_s: Optional[float]) -> str:
    series = tsdb.query(live_rows, window=window_s)
    parts = []
    for name, pts in series.items():
        if not pts:
            continue
        values = [v for _, v in pts]
        span = pts[-1][0] - pts[0][0]
        parts.append(
            f'<div class="panel live" data-series="{name}">'
            f"<h3>{name}</h3>" + _spark(values)
            + f'<p class="num">latest {_fmt(values[-1])} · '
              f"{len(values)} samples over {span:.0f}s</p></div>")
    return "".join(parts)


def render(history_rows: Optional[list] = None,
           live_rows: Optional[list] = None,
           window: int = 5, threshold: float = 0.10,
           live_window_s: Optional[float] = 600.0,
           refresh_s: Optional[int] = None,
           title: str = "tpudist console") -> str:
    """The whole page as one string. ``refresh_s`` adds the meta-refresh
    used when served live; omit for static artifacts."""
    head = ['<!doctype html><html><head><meta charset="utf-8">',
            f"<title>{html.escape(title)}</title>"]
    if refresh_s:
        head.append(f'<meta http-equiv="refresh" content="{int(refresh_s)}">')
    head.append(f"<style>{_STYLE}</style></head><body>")
    head.append(f"<h1>{html.escape(title)}</h1>")
    body = []
    if live_rows:
        body.append('<h2>fleet (live tsdb window)</h2>'
                    '<div class="panels" id="live">')
        body.append(_live_panels(live_rows, live_window_s))
        body.append("</div>")
    groups = history_series(history_rows or [])
    n_reg = 0
    if groups:
        body.append('<h2>bench history (trailing-median gate per series)'
                    '</h2><div class="panels" id="history">')
        for key in sorted(groups, key=lambda k: (str(k[0]), str(k[1]))):
            panel = _history_panel(key, groups[key], window, threshold)
            n_reg += 'data-status="regression"' in panel
            body.append(panel)
        body.append("</div>")
    elif not live_rows:
        body.append("<p>no bench history and no live samples — nothing to "
                    "draw yet</p>")
    body.append(
        f'<footer id="summary" data-series="{len(groups)}" '
        f'data-regressions="{n_reg}">{len(groups)} series · '
        f"{n_reg} regression(s) · window={window} "
        f"threshold={threshold:g}</footer></body></html>")
    return "".join(head) + "".join(body)


def render_history_file(history: Optional[str] = None,
                        live_path: Optional[str] = None, **kw) -> str:
    """The page from files: a bench history (none when ``history`` is
    None) and a fleet series file."""
    rows = load_history(history) if history else []
    live = tsdb.load_rows(live_path) if live_path else None
    return render(history_rows=rows, live_rows=live, **kw)


def live_renderer(ts_dir: str):
    """() -> HTML closure for ``MetricsServer(dashboard=...)``: the newest
    attempt's series under ``ts_dir``, read in the HTTP handler thread
    that calls it, never on the supervision poll."""
    def _render() -> str:
        return render_history_file(live_path=tsdb.latest_path(ts_dir),
                                   refresh_s=5)
    return _render
