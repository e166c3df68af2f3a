"""Observability: flow tracing, metrics, and plan-vs-actual reporting.

Layering: ``obs.trace`` and ``obs.metrics`` are stdlib-only so every
runtime module (core.channel, core.pipeline, comm.resharding, serve)
can import them; ``obs.report`` imports core (Simulator, CostModel) and
is therefore exposed LAZILY here — importing ``repro_torch.obs`` from inside
core must never pull core back in.  A copy of the JAX package's
``obs/__init__.py``.
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
    # lazy (see __getattr__): plan_vs_actual, apply_drift, replay_sim,
    # FlowReport, DeviceUtil, DriftRow
]

_REPORT_NAMES = ("plan_vs_actual", "apply_drift", "replay_sim",
                 "FlowReport", "DeviceUtil", "DriftRow",
                 "report_to_json_file")


def __getattr__(name):
    if name in _REPORT_NAMES:
        from repro_torch.obs import report
        return getattr(report, name)
    raise AttributeError(name)
