"""Counter/gauge/histogram registry for runtime metrics.

The runtime's instrumentation sites record channel queue depth, block
time, page-pool utilization, tokens/s, recoveries and straggler beat
intervals here; ``WorkflowRunner.run_loop`` snapshots the registry once
per iteration and merges the lines into its verbose output, and
``tools/flowtrace.py`` prints the final snapshot next to the
plan-vs-actual report.

Like :mod:`repro_torch.obs.trace`, this module is stdlib-only and importable
from every layer.  Hot paths gate on :func:`active` (non-None only while
a tracer is installed), so a run without tracing pays one global read
per site.

A copy of the JAX package's ``obs/metrics.py``; only its imports
differ.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from repro_torch.obs import trace as _trace


class Counter:
    """Monotonically increasing count (recoveries, preemptions, chunks)."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def snapshot(self) -> Dict[str, float]:
        return {"value": self.value}


class Gauge:
    """Last-set value plus the high-water mark (queue depth, page-pool
    utilization, tokens/s)."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.max = float("-inf")
        self._set = False
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)
            self._set = True
            if value > self.max:
                self.max = float(value)

    def snapshot(self) -> Dict[str, float]:
        if not self._set:
            return {"value": 0.0, "max": 0.0}
        return {"value": self.value, "max": self.max}


class Histogram:
    """Bounded sample reservoir with percentile snapshots (block times,
    beat intervals).  Keeps the most recent ``window`` observations —
    enough for per-iteration p50/p95 without unbounded growth."""

    WINDOW = 1024

    def __init__(self, name: str, window: int = WINDOW):
        self.name = name
        self.count = 0
        self.total = 0.0
        self._samples: Deque[float] = deque(maxlen=window)
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self.count += 1
            self.total += value
            self._samples.append(float(value))

    @staticmethod
    def _percentile(xs: List[float], pct: float) -> float:
        if not xs:
            return 0.0
        k = max(0, min(len(xs) - 1, int(round(pct / 100.0 * (len(xs) - 1)))))
        return xs[k]

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            xs = sorted(self._samples)
            count, total = self.count, self.total
        return {
            "count": float(count),
            "mean": (total / count) if count else 0.0,
            "p50": self._percentile(xs, 50.0),
            "p95": self._percentile(xs, 95.0),
            "max": xs[-1] if xs else 0.0,
        }


class MetricsRegistry:
    """Thread-safe get-or-create registry of named metrics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Point-in-time view of every metric, keyed by name.  Counters
        and gauges keep accumulating afterwards — the snapshot is a
        read, not a reset."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.snapshot() for name, m in sorted(items)}

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


def format_snapshot(snap: Dict[str, Dict[str, float]],
                    prefix: Optional[str] = None) -> List[str]:
    """Render a snapshot as aligned ``name  k=v ...`` lines (optionally
    filtered to names under ``prefix``)."""
    lines = []
    for name, fields in snap.items():
        if prefix is not None and not name.startswith(prefix):
            continue
        body = "  ".join(f"{k}={v:.6g}" for k, v in fields.items())
        lines.append(f"{name:40s} {body}")
    return lines


# ---------------------------------------------------------------------------
# Global registry.  Always present (so snapshots never need None checks),
# but hot-path sites use active(), which hands it out only while tracing
# is armed — metrics and tracing switch on together.
# ---------------------------------------------------------------------------
_registry = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _registry


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the global registry (tests install a fresh one); returns the
    previous registry."""
    global _registry
    prev, _registry = _registry, reg
    return prev


def active() -> Optional[MetricsRegistry]:
    """The registry, but only while a tracer is installed — hot paths
    gate their metric updates on this so a production run without
    flowtrace records nothing."""
    return _registry if _trace.active() is not None else None
