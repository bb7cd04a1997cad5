"""Observability plane: Prometheus-style exporter over the fleet SLO
mirrors (rates, latency percentiles, burn rates, decision audit).

Everything here reads mirrors the collector and control loop already
maintain — a scrape never touches the hot path.  See ``exporter.py`` for
the endpoints.
"""

from repro_torch.obs.exporter import (MetricsExporter, make_exporter,
                                      render_metrics)

__all__ = ["MetricsExporter", "make_exporter", "render_metrics"]
