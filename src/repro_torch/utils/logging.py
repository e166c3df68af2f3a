"""Structured logger with levels, routed through the obs layer.

Levels follow the usual ladder (``debug < info < warn < error``); the
threshold comes from the ``REPRO_LOG_LEVEL`` environment variable
(default ``info``) or :func:`set_level`.  Each emitted line is formatted
OUTSIDE the lock and written with a single ``write`` call under it, so
lines from the executor's named threads (pipe-prod/pipe-cons/
cycle-member-*) never interleave mid-line; the thread name is part of
the line for exactly that audience.

When tracing is armed (:mod:`repro_torch.obs.trace`), every emitted line also
lands in the trace as an instant event (visible on the Perfetto
timeline next to the spans it explains) and bumps a per-level counter in
the metrics registry — verbose output and metrics share one sink.

A copy of the JAX package's ``utils/logging.py``; only its imports
differ.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}

_T0 = time.time()
_lock = threading.Lock()
# back-compat: VERBOSE=False mutes everything below error (the old
# binary switch launch scripts toggle)
VERBOSE = True


def _env_level() -> int:
    name = os.environ.get("REPRO_LOG_LEVEL", "info").strip().lower()
    return LEVELS.get(name, LEVELS["info"])


_level = _env_level()


def set_level(name: str) -> int:
    """Set the threshold programmatically; returns the previous value.
    ``REPRO_LOG_LEVEL`` only sets the import-time default."""
    global _level
    prev = _level
    _level = LEVELS.get(name.strip().lower(), _level)
    return prev


def get_level() -> str:
    for name, v in LEVELS.items():
        if v == _level:
            return name
    return str(_level)


def log(tag: str, msg: str, *, level: str = "info", **kv: Any) -> None:
    lv = LEVELS.get(level, LEVELS["info"])
    tr = _trace.active()
    if tr is not None:
        # the trace keeps every line regardless of the stdout threshold —
        # a debug line invisible on the console still lands on the
        # timeline where it can explain a span
        tr.instant(f"log:{tag}", "log", level=level, msg=msg, **kv)
        reg = _metrics.active()
        if reg is not None:
            reg.counter(f"log/{level}").inc()
    if lv < _level or (not VERBOSE and lv < LEVELS["error"]):
        return
    extra = " ".join(f"{k}={v}" for k, v in kv.items())
    tname = threading.current_thread().name
    line = (f"[{time.time() - _T0:8.2f}s] {level:5s} {tag:12s} "
            f"({tname}) {msg} {extra}".rstrip() + "\n")
    with _lock:
        sys.stdout.write(line)
        sys.stdout.flush()


def debug(tag: str, msg: str, **kv: Any) -> None:
    log(tag, msg, level="debug", **kv)


def info(tag: str, msg: str, **kv: Any) -> None:
    log(tag, msg, level="info", **kv)


def warn(tag: str, msg: str, **kv: Any) -> None:
    log(tag, msg, level="warn", **kv)


def error(tag: str, msg: str, **kv: Any) -> None:
    log(tag, msg, level="error", **kv)
