"""Observability: flow tracing and metrics.

``obs.trace`` and ``obs.metrics`` are stdlib-only so every runtime module
(core.channel, core.pipeline, comm.resharding) can import them.
Counterpart of the JAX package's ``obs``, without its plan-vs-actual
report (``obs/report.py``, ROADMAP.md queue 1, item 11).
"""
from repro_torch.obs.metrics import (
    MetricsRegistry,
    default_registry,
    format_snapshot,
    set_registry,
)
from repro_torch.obs.trace import Tracer, active, install, tracing, uninstall

__all__ = [
    "Tracer", "active", "install", "uninstall", "tracing",
    "MetricsRegistry", "default_registry", "set_registry",
    "format_snapshot",
]
