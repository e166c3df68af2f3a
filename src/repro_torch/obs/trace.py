"""Thread-safe span recorder with Chrome-trace/Perfetto JSON export.

The runtime's instrumentation sites (executor task choke point, Pipelined
producer/consumer chunks, ContextSwitcher offload/onload, weight sync,
Channel block time, PagedEngine step loop) all funnel through one global
:class:`Tracer`.  Tracing is **default-off**: the global tracer is
``None`` until :func:`install` (or the :func:`tracing` context manager)
arms it, and every instrumentation site's fast path is a single global
read — the measured overhead bound (executor wall with tracing enabled
within 5% of disabled, enforced in tests) depends on keeping it that way.

Design constraints:

  * **zero dependencies** — stdlib only, importable from every layer
    (``core.channel`` and ``comm.resharding`` both instrument; obs must
    never import back into them);
  * **monotonic clocks** — spans carry absolute ``time.perf_counter``
    stamps; export normalizes to the tracer's epoch.  The clock is
    injectable so tests replay fixed timelines and assert deterministic
    export byte-for-byte;
  * **thread attribution** — each span records the recording thread
    (stable small ids in first-appearance order + thread-name metadata),
    so Perfetto lanes mirror the executor's pipe-prod/pipe-cons/
    cycle-member/ctx-prefetch threads.

A copy of the JAX package's ``obs/trace.py``; only its imports
differ.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple


@dataclass
class Span:
    """One timed interval.  ``t0``/``t1`` are absolute clock readings
    (the tracer's ``clock``); ``tid`` is the tracer-local thread id the
    span was recorded from (or assigned explicitly, e.g. one lane per
    worker when replaying a simulated timeline)."""
    name: str
    cat: str
    t0: float
    t1: float
    tid: int = 0
    args: Dict[str, Any] = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


@dataclass
class Instant:
    """A zero-duration event (preemption, weight swap, log line)."""
    name: str
    cat: str
    t: float
    tid: int = 0
    args: Dict[str, Any] = field(default_factory=dict)


@dataclass
class CounterSample:
    """A (name, t, value) timeline sample — exported as a Chrome 'C'
    event so Perfetto renders e.g. channel queue depth over time."""
    name: str
    t: float
    value: float


class Tracer:
    """Span/instant/counter recorder.  All record paths are lock-guarded
    and cheap (append to a list); analysis happens at export time."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self.epoch = clock()
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._instants: List[Instant] = []
        self._counters: List[CounterSample] = []
        # thread ident -> (stable small id, thread name)
        self._tids: Dict[int, Tuple[int, str]] = {}
        # named lanes claimed via explicit tid= (sim replay: one per worker)
        self._lanes: Dict[str, int] = {}
        # context merged into every span/instant's args (e.g. iteration)
        self._ctx: Dict[str, Any] = {}

    # ------------------------------------------------------------------
    # context
    # ------------------------------------------------------------------
    def set_context(self, **kv: Any) -> None:
        """Merge ``kv`` into every subsequently recorded event's args
        (``None`` removes a key).  Used for run-wide attributes the
        recording site cannot know — the training iteration, above all."""
        with self._lock:
            for k, v in kv.items():
                if v is None:
                    self._ctx.pop(k, None)
                else:
                    self._ctx[k] = v

    def _merged(self, args: Dict[str, Any]) -> Dict[str, Any]:
        if not self._ctx:
            return args
        out = dict(self._ctx)
        out.update(args)
        return out

    def _tid(self, lane: Optional[str]) -> int:
        # caller holds self._lock
        if lane is not None:
            if lane not in self._lanes:
                # lanes live above thread ids so they never collide
                self._lanes[lane] = 1000 + len(self._lanes)
            return self._lanes[lane]
        ident = threading.get_ident()
        ent = self._tids.get(ident)
        if ent is None:
            ent = (len(self._tids), threading.current_thread().name)
            self._tids[ident] = ent
        return ent[0]

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------
    def add(self, name: str, cat: str, t0: float, t1: float, *,
            lane: Optional[str] = None, **args: Any) -> None:
        """Record a completed interval from timestamps the caller already
        took — the executor's hot path uses this (no context-manager
        overhead around the task call)."""
        with self._lock:
            self._spans.append(Span(name, cat, t0, t1, self._tid(lane),
                                    self._merged(args)))

    def instant(self, name: str, cat: str = "event", t: Optional[float] = None,
                *, lane: Optional[str] = None, **args: Any) -> None:
        with self._lock:
            self._instants.append(
                Instant(name, cat, self.clock() if t is None else t,
                        self._tid(lane), self._merged(args)))

    def counter(self, name: str, value: float,
                t: Optional[float] = None) -> None:
        with self._lock:
            self._counters.append(CounterSample(
                name, self.clock() if t is None else t, float(value)))

    @contextmanager
    def span(self, name: str, cat: str = "span",
             lane: Optional[str] = None, **args: Any) -> Iterator[None]:
        t0 = self.clock()
        try:
            yield
        finally:
            self.add(name, cat, t0, self.clock(), lane=lane, **args)

    def trace(self, name: Optional[str] = None, cat: str = "task",
              **args: Any) -> Callable:
        """Decorator form of :meth:`span`."""
        def deco(fn: Callable) -> Callable:
            label = name or getattr(fn, "__name__", "fn")

            def wrapped(*a: Any, **kw: Any) -> Any:
                with self.span(label, cat, **args):
                    return fn(*a, **kw)

            wrapped.__name__ = getattr(fn, "__name__", label)
            wrapped.__doc__ = fn.__doc__
            return wrapped
        return deco

    # ------------------------------------------------------------------
    # access
    # ------------------------------------------------------------------
    def spans(self, cat: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if cat is not None:
            out = [s for s in out if s.cat == cat]
        return out

    def instants(self, cat: Optional[str] = None) -> List[Instant]:
        with self._lock:
            out = list(self._instants)
        if cat is not None:
            out = [i for i in out if i.cat == cat]
        return out

    def counters(self) -> List[CounterSample]:
        with self._lock:
            return list(self._counters)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._instants.clear()
            self._counters.clear()

    # ------------------------------------------------------------------
    # Chrome-trace export (open in Perfetto / chrome://tracing)
    # ------------------------------------------------------------------
    def to_chrome(self) -> Dict[str, Any]:
        """Chrome Trace Event Format dict.  Timestamps are microseconds
        relative to the tracer's epoch; events are sorted on a total
        order (ts, -dur, name, tid) and args keys are emitted sorted, so
        the export is a pure function of the recorded events — identical
        inputs (fixed injected clock) give byte-identical JSON."""
        with self._lock:
            spans = list(self._spans)
            instants = list(self._instants)
            counters = list(self._counters)
            tids = dict(self._tids)
            lanes = dict(self._lanes)

        def us(t: float) -> float:
            return round((t - self.epoch) * 1e6, 3)

        events: List[Dict[str, Any]] = []
        for s in spans:
            events.append({"name": s.name, "cat": s.cat, "ph": "X",
                           "ts": us(s.t0), "dur": round(s.dur * 1e6, 3),
                           "pid": 0, "tid": s.tid,
                           "args": dict(sorted(s.args.items()))})
        for i in instants:
            events.append({"name": i.name, "cat": i.cat, "ph": "i",
                           "ts": us(i.t), "s": "g", "pid": 0, "tid": i.tid,
                           "args": dict(sorted(i.args.items()))})
        for c in counters:
            events.append({"name": c.name, "cat": "counter", "ph": "C",
                           "ts": us(c.t), "pid": 0, "tid": 0,
                           "args": {"value": c.value}})
        events.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0),
                                   e["name"], e["tid"]))
        meta: List[Dict[str, Any]] = [
            {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
             "args": {"name": "repro"}}]
        for _, (tid, tname) in sorted(tids.items(), key=lambda kv: kv[1][0]):
            meta.append({"name": "thread_name", "ph": "M", "pid": 0,
                         "tid": tid, "args": {"name": tname}})
        for lname, tid in sorted(lanes.items(), key=lambda kv: kv[1]):
            meta.append({"name": "thread_name", "ph": "M", "pid": 0,
                         "tid": tid, "args": {"name": lname}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, sort_keys=True,
                      separators=(",", ":"))
            f.write("\n")


# ---------------------------------------------------------------------------
# The global tracer: default-off.  Instrumentation sites call active();
# a None return means "record nothing" and costs one global read.
# ---------------------------------------------------------------------------
_tracer: Optional[Tracer] = None


def active() -> Optional[Tracer]:
    return _tracer


def install(tracer: Optional[Tracer] = None) -> Tracer:
    """Arm tracing globally; returns the installed tracer."""
    global _tracer
    _tracer = tracer if tracer is not None else Tracer()
    return _tracer


def uninstall() -> Optional[Tracer]:
    """Disarm tracing; returns the tracer that was active (its recorded
    events stay readable/exportable)."""
    global _tracer
    prev, _tracer = _tracer, None
    return prev


@contextmanager
def tracing(tracer: Optional[Tracer] = None) -> Iterator[Tracer]:
    """Scoped tracing: installs on entry, restores the previous global
    (usually None) on exit."""
    global _tracer
    prev = _tracer
    tr = install(tracer)
    try:
        yield tr
    finally:
        _tracer = prev
