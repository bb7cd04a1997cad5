"""Prometheus-style exporter over the fleet SLO plane.

One scrape of ``/metrics`` renders **one consistent snapshot**: the
monitor service's rate / percentile / error mirrors are captured under a
single lock acquisition (:meth:`FleetMonitorService.obs_snapshot`), and
the control loop contributes post-decide numpy mirrors (burn rates, SLO
targets) plus its failure-handling counters.  A scrape never mixes two
harvest generations, and it never touches the per-tick decision path —
zero retraces, no arena writes, no extra gathers beyond the mirrors the
collector already maintains.

The server is stdlib ``http.server`` on a daemon thread: no third-party
dependency, ephemeral port by default (``port=0``) so tests and benches
can run many exporters side by side.

Endpoints
---------
``/metrics``
    Prometheus text exposition (version 0.0.4).  The metric reference
    is the JAX package's ``repro/obs/README.md``; the names are the same.
``/control_log``
    Drains the :class:`~repro_torch.control.log.ControlLog` ring as JSON
    lines (one decision per line; records that fell off the ring since
    the last drain are acknowledged with a ``{"dropped": n}`` line).
    The scraper owns persistence; the drain cursor advances per GET.
``/healthz``
    ``ControlLoop.health()`` as JSON (``{"ok": true}`` when no loop is
    attached).  200 always — readiness is the scraper's judgement.
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence, Union

import numpy as np

__all__ = ["MetricsExporter", "render_metrics"]


def _fmt(v) -> str:
    """Prometheus sample value: shortest faithful float, special-cased
    non-finites (the text format spells them ``NaN`` / ``+Inf``)."""
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return format(v, ".10g")


def _esc(s: str) -> str:
    return str(s).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Lines:
    """Accumulates one exposition; emits HELP/TYPE once per family."""

    def __init__(self) -> None:
        self._out: list[str] = []
        self._seen: set[str] = set()

    def sample(self, name: str, help_: str, type_: str,
               value, labels: Optional[dict] = None) -> None:
        if name not in self._seen:
            self._seen.add(name)
            self._out.append(f"# HELP {name} {help_}")
            self._out.append(f"# TYPE {name} {type_}")
        if labels:
            lab = ",".join(f'{k}="{_esc(v)}"' for k, v in labels.items())
            self._out.append(f"{name}{{{lab}}} {_fmt(value)}")
        else:
            self._out.append(f"{name} {_fmt(value)}")

    def text(self) -> str:
        return "\n".join(self._out) + "\n"


def render_metrics(service=None, loop=None, log=None,
                   names: Union[None, Sequence[str],
                                Callable[[], Sequence[str]]] = None,
                   extra: Optional[Callable[[], dict]] = None) -> str:
    """Render one Prometheus text exposition (no HTTP involved).

    ``names`` optionally labels each public queue index with a stable
    ``name="..."`` (e.g. the tenant name in a :class:`ControlGroup`);
    pass a callable to resolve it at scrape time under fleet churn.
    ``extra`` is a callable returning ``{metric: value}`` or
    ``{metric: {label_value: value}}`` (rendered with a ``name`` label)
    for process-specific gauges such as engine breaker states.
    """
    out = _Lines()
    nm: Sequence[str] = ()
    if callable(names):
        nm = tuple(names())
    elif names is not None:
        nm = tuple(names)

    def qlab(i: int, **more) -> dict:
        lab = {"queue": str(i)}
        if i < len(nm):
            lab["name"] = nm[i]
        lab.update(more)
        return lab

    if service is not None:
        snap = service.obs_snapshot()
        q = int(snap["q"])
        qs = snap["quantile_qs"]
        for i in range(q):
            out.sample("repro_stream_rate_items_per_s",
                       "Per-queue non-blocking service-rate estimate "
                       "(gated head/tail harvest).", "gauge",
                       snap["rates"][i], qlab(i))
        for i in range(q):
            for j, p in enumerate(qs):
                out.sample("repro_latency_seconds",
                           "Per-queue latency percentile over the last "
                           "harvest window (bucket-interpolated).",
                           "gauge", snap["percentiles"][i, j],
                           qlab(i, quantile=_fmt(float(p))))
        for i in range(q):
            out.sample("repro_latency_observations_total",
                       "Latency observations harvested, ever.",
                       "counter", snap["latency_counts"][i], qlab(i))
        for i in range(q):
            out.sample("repro_errors_total",
                       "Errors recorded on the queue's arena slots, "
                       "ever.", "counter", snap["error_totals"][i],
                       qlab(i))
        for i in range(q):
            out.sample("repro_error_rate_per_s",
                       "Error rate over the last harvest window.",
                       "gauge", snap["error_rates"][i], qlab(i))
        for i in range(q):
            out.sample("repro_periods_blocked_total",
                       "Monitor periods the queue spent blocked.",
                       "counter", snap["n_blocked"][i], qlab(i))
        for i in range(q):
            out.sample("repro_periods_total",
                       "Monitor periods observed.", "counter",
                       snap["n_total"][i], qlab(i))
        out.sample("repro_monitor_dispatches_total",
                   "Fused collector dispatches, ever.", "counter",
                   snap["dispatches"])

    if loop is not None:
        burn_f = np.asarray(loop.slo_burn_fast, float)
        burn_s = np.asarray(loop.slo_burn_slow, float)
        tgt = np.asarray(loop.slo_targets, float)
        for i in range(burn_f.shape[0]):
            out.sample("repro_slo_burn_rate",
                       "SLO error-budget burn rate (EMA of "
                       "over-threshold fraction / budget).", "gauge",
                       burn_f[i], qlab(i, window="fast"))
            out.sample("repro_slo_burn_rate",
                       "SLO error-budget burn rate (EMA of "
                       "over-threshold fraction / budget).", "gauge",
                       burn_s[i], qlab(i, window="slow"))
        for i in range(tgt.shape[0]):
            out.sample("repro_slo_target_seconds",
                       "Per-queue latency SLO target (NaN = no SLO).",
                       "gauge", tgt[i], qlab(i))
        h = loop.health()
        health_help = {
            "ticks": ("repro_control_ticks_total", "counter",
                      "Control-loop ticks, ever."),
            "tick_errors": ("repro_control_tick_errors_total", "counter",
                            "Contained tick failures."),
            "quarantined": ("repro_control_quarantined_total", "counter",
                            "Non-finite sense rows quarantined."),
            "actuation_errors": ("repro_control_actuation_errors_total",
                                 "counter", "Actuations that raised or "
                                 "timed out past retries."),
            "monitor_restarts": ("repro_control_monitor_restarts_total",
                                 "counter",
                                 "Watchdog monitor-thread restarts."),
            "jit_failures": ("repro_control_jit_failures_total",
                             "counter",
                             "Decision dispatches degraded to numpy."),
            "impl_degraded": ("repro_control_impl_degraded", "gauge",
                              "1 when the decision path is pinned to "
                              "the numpy host fallback."),
            "control_log_dropped": ("repro_control_log_dropped_total",
                                    "counter", "Decision records lost "
                                    "off the audit ring undrained."),
        }
        for key, (name, type_, help_) in health_help.items():
            if key in h:
                out.sample(name, help_, type_, h[key])
        lg = log if log is not None else getattr(loop, "log", None)
        if lg is not None:
            for key, n in sorted(lg.counts().items()):
                pol, _, outcome = key.partition("/")
                out.sample("repro_control_decisions_total",
                           "Decision records in the retained audit "
                           "window, by policy and outcome.", "gauge",
                           n, {"policy": pol, "outcome": outcome})

    if extra is not None:
        for name, val in sorted(extra().items()):
            if isinstance(val, dict):
                for k, v in sorted(val.items()):
                    out.sample(name, "Process-specific gauge.", "gauge",
                               v, {"name": str(k)})
            else:
                out.sample(name, "Process-specific gauge.", "gauge", val)

    out.sample("repro_exporter_scrapes_total",
               "Scrapes served by this exporter (this one included).",
               "counter", _SCRAPES.bump())
    return out.text()


class _Counter:
    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def bump(self) -> int:
        with self._lock:
            self._n += 1
            return self._n


_SCRAPES = _Counter()


class MetricsExporter:
    """Background HTTP exporter; see module docstring for endpoints.

    Parameters mirror :func:`render_metrics`; ``port=0`` binds an
    ephemeral port (read it back from ``.port`` / ``.url`` after
    :meth:`start`).  ``start``/``stop`` are idempotent; the server
    thread is a daemon so a forgotten exporter never blocks process
    exit.
    """

    def __init__(self, service=None, loop=None, log=None,
                 names=None, extra=None,
                 host: str = "127.0.0.1", port: int = 0):
        self.service = service
        self.loop = loop
        self.log = log if log is not None else getattr(loop, "log", None)
        self.names = names
        self.extra = extra
        self.host = host
        self._want_port = int(port)
        self._srv: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- rendering (usable without HTTP, e.g. from tests/benches) ---------
    def render(self) -> str:
        return render_metrics(self.service, self.loop, self.log,
                              names=self.names, extra=self.extra)

    def healthz(self) -> dict:
        if self.loop is not None:
            return dict(self.loop.health(), ok=True)
        return {"ok": True}

    # -- lifecycle --------------------------------------------------------
    @property
    def port(self) -> Optional[int]:
        return self._srv.server_address[1] if self._srv else None

    @property
    def url(self) -> Optional[str]:
        p = self.port
        return f"http://{self.host}:{p}" if p else None

    def start(self) -> "MetricsExporter":
        if self._srv is not None:
            return self
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):        # silence request logging
                pass

            def _send(self, code: int, ctype: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        body = exporter.render().encode()
                        self._send(200, "text/plain; version=0.0.4;"
                                        " charset=utf-8", body)
                    elif path == "/control_log":
                        lg = exporter.log
                        lines = lg.drain_lines() if lg is not None else []
                        body = ("\n".join(lines) + ("\n" if lines else "")
                                ).encode()
                        self._send(200, "application/x-ndjson", body)
                    elif path == "/healthz":
                        body = json.dumps(exporter.healthz()).encode()
                        self._send(200, "application/json", body)
                    else:
                        self._send(404, "text/plain", b"not found\n")
                except Exception as exc:      # scrape must not kill server
                    try:
                        self._send(500, "text/plain",
                                   f"scrape failed: {exc}\n".encode())
                    except Exception:
                        pass

        self._srv = ThreadingHTTPServer((self.host, self._want_port),
                                        Handler)
        self._srv.daemon_threads = True
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        name="repro-metrics-exporter",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        srv, self._srv = self._srv, None
        th, self._thread = self._thread, None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if th is not None:
            th.join(timeout=5)

    # -- context manager --------------------------------------------------
    def __enter__(self) -> "MetricsExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def make_exporter(obs, **defaults) -> Optional[MetricsExporter]:
    """Resolve the ``obs=`` knob shared by ``Engine``, ``ControlGroup``
    and ``Pipeline``: ``None``/``False`` → no exporter; ``True`` →
    ephemeral port; an ``int`` → that port; a ``dict`` → keyword
    overrides merged over ``defaults`` (e.g. ``{"port": 9100}``); an
    existing :class:`MetricsExporter` is adopted as-is (caller keeps
    whatever service/loop it was built with)."""
    if obs is None or obs is False:
        return None
    if isinstance(obs, MetricsExporter):
        return obs
    kw = dict(defaults)
    if obs is True:
        pass
    elif isinstance(obs, int):
        kw["port"] = obs
    elif isinstance(obs, dict):
        kw.update(obs)
    else:
        raise TypeError(f"obs= expects None/bool/int/dict/MetricsExporter,"
                        f" got {type(obs).__name__}")
    return MetricsExporter(**kw)
