"""Exposition formats over a :class:`~.metrics.Registry` snapshot.

Three consumers, one data model:

- :func:`to_prometheus_text` — the Prometheus text exposition format
  (``# HELP``/``# TYPE`` + samples; histograms as cumulative
  ``_bucket{le=...}`` series plus ``_sum``/``_count``), scrape-ready.
- :func:`to_json` — a structured snapshot for dashboards/benchmarks.
- :func:`start_metrics_server` — an optional stdlib ``http.server``
  endpoint (``/metrics`` text, ``/metrics.json``) for the serving host;
  runs on a daemon thread, no third-party dependency.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Optional

from .metrics import Registry, default_registry

__all__ = ["to_prometheus_text", "to_json", "write_prometheus",
           "start_metrics_server", "MetricsServer",
           "register_collect_hook", "unregister_collect_hook"]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# Pre-collection hooks: callables invoked with the registry about to be
# exported, BEFORE the snapshot walk. The mechanism that lets derived
# series (e.g. the SLO quantile digests in ``stepprof``) publish fresh
# gauge values only when somebody actually scrapes — the hot path never
# pays for percentile math. Hooks must be idempotent and cheap; a hook
# that raises is dropped from that export, never propagated to the
# scraper.
_collect_hooks = []


def register_collect_hook(fn) -> None:
    """Register ``fn(registry)`` to run before every export."""
    if fn not in _collect_hooks:
        _collect_hooks.append(fn)


def unregister_collect_hook(fn) -> None:
    try:
        _collect_hooks.remove(fn)
    except ValueError:
        pass


def _run_collect_hooks(reg: Registry) -> None:
    for fn in list(_collect_hooks):
        try:
            fn(reg)
        except Exception:   # a broken hook must not break the scrape
            pass


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f != f:                   # Prometheus spells it NaN, Python nan
        return "NaN"
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(names, values, extra=()) -> str:
    pairs = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape_label(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def to_prometheus_text(registry: Optional[Registry] = None) -> str:
    """Render every family as Prometheus text exposition (0.0.4)."""
    reg = registry or default_registry()
    _run_collect_hooks(reg)
    lines = []
    for fam in reg.collect():
        if fam.help:
            lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for labelvalues, child in fam.samples():
            base = _label_str(fam.labelnames, labelvalues)
            if fam.kind == "histogram":
                for edge, cum in child.cumulative_buckets():
                    le = _label_str(fam.labelnames, labelvalues,
                                    extra=[("le", _fmt_value(edge))])
                    lines.append(f"{fam.name}_bucket{le} {cum}")
                lines.append(f"{fam.name}_sum{base} "
                             f"{_fmt_value(child.sum)}")
                lines.append(f"{fam.name}_count{base} {child.count}")
            else:
                lines.append(f"{fam.name}{base} "
                             f"{_fmt_value(child.value)}")
    return "\n".join(lines) + ("\n" if lines else "")


def to_json(registry: Optional[Registry] = None) -> dict:
    """{name: {kind, help, labelnames, series: [{labels, ...}]}}."""
    reg = registry or default_registry()
    _run_collect_hooks(reg)
    out = {}
    for fam in reg.collect():
        series = []
        for labelvalues, child in fam.samples():
            labels = dict(zip(fam.labelnames, labelvalues))
            if fam.kind == "histogram":
                series.append({
                    "labels": labels,
                    "count": child.count,
                    "sum": child.sum,
                    # true stream extrema: quantiles interpolated from
                    # the buckets downstream must clamp to these
                    "observed_min": child.observed_min,
                    "observed_max": child.observed_max,
                    "buckets": [[("+Inf" if e == math.inf else e), c]
                                for e, c in child.cumulative_buckets()],
                })
            else:
                series.append({"labels": labels, "value": child.value})
        out[fam.name] = {"kind": fam.kind, "help": fam.help,
                         "labelnames": list(fam.labelnames),
                         "series": series}
    return out


def write_prometheus(path: str,
                     registry: Optional[Registry] = None) -> str:
    """Dump the text exposition to ``path`` (benchmark/CI artifact)."""
    text = to_prometheus_text(registry)
    with open(path, "w") as f:
        f.write(text)
    return path


class MetricsServer:
    """``/metrics`` + ``/healthz`` endpoint over stdlib ``http.server``.

    Scrape-only by design: GET /metrics (Prometheus text),
    GET /metrics.json, and GET /healthz (200 with uptime — or 503 when
    a registered hang watchdog reports a stall); anything else is 404.
    HEAD is answered with the same headers and no body. The listener
    thread is a daemon so an unclosed server never blocks interpreter
    exit.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 registry: Optional[Registry] = None,
                 watchdog=None):
        import http.server
        import time

        reg = registry or default_registry()
        t_started = time.perf_counter()

        def healthz_body():
            wd = watchdog
            if wd is None:
                from .watchdog import default_watchdog
                wd = default_watchdog()
            wd_status = wd.status() if wd is not None else None
            stalled = bool(wd_status and wd_status["stalled"])
            body = {"status": "stalled" if stalled else "ok",
                    "uptime_seconds": time.perf_counter() - t_started,
                    "watchdog": wd_status}
            return (503 if stalled else 200,
                    json.dumps(body).encode())

        class _Handler(http.server.BaseHTTPRequestHandler):
            def _respond(self, send_body: bool):
                path = self.path.split("?", 1)[0]
                status = 200
                if path in ("/metrics", "/"):
                    body = to_prometheus_text(reg).encode()
                    ctype = PROMETHEUS_CONTENT_TYPE
                elif path == "/metrics.json":
                    body = json.dumps(to_json(reg)).encode()
                    ctype = "application/json"
                elif path == "/healthz":
                    status, body = healthz_body()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if send_body:
                    self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — http.server contract
                self._respond(send_body=True)

            def do_HEAD(self):  # noqa: N802 — headers only, no body
                self._respond(send_body=False)

            def log_message(self, *args):  # scrapes are not app logs
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      _Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="pd-metrics-server",
                                        daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def start_metrics_server(host: str = "127.0.0.1", port: int = 0,
                         registry: Optional[Registry] = None,
                         watchdog=None) -> MetricsServer:
    """Start the ``/metrics`` + ``/healthz`` endpoint; ``port=0`` picks
    a free port (read it back from ``server.port``). ``watchdog``
    defaults to the process-default hang watchdog, if one is
    registered."""
    return MetricsServer(host=host, port=port, registry=registry,
                         watchdog=watchdog)
