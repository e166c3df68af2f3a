"""Failure injection + detection harness (scale-out fault tolerance).

The recovery story has three parts spread over three modules:

  * **inject** (here) — :class:`FaultInjector` wraps the workflow's task
    fns and kills a chosen worker at a configurable (iteration,
    invocation) point, optionally taking its whole host down
    (``SimulatedCluster.fail_host``).  Invocation index is the phase
    boundary: invocation 0 is the worker's first task call of the
    iteration, k is its k-th chunk/loop step;
  * **detect** — the ExecutionFlowManager wraps every task death as a
    typed :class:`~repro_torch.core.worker.WorkerFailure` (worker name + step)
    and reports it to ``Controller.report_failure``; the
    :class:`HeartbeatMonitor` here covers the complementary silent-hang
    case (no exception, no progress);
  * **recover** — ``WorkflowRunner.recover`` tears the run down, rebuilds
    workers, re-plans over ``Cluster.available_devices`` and resumes from
    the last checkpoint, which makes recovery ≡ a fresh run resumed from
    that checkpoint *by construction* (the determinism the fault tests
    assert).

Death is marked on the worker OBJECT (``_injected_dead``), not the
injector, so a rebuilt worker of the same name starts clean while any
straggler call into the dead instance keeps failing — exactly a real
dead process's behaviour.

A copy of the JAX package's ``core/faults.py``; only its imports
differ.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional


class InjectedFault(RuntimeError):
    """The synthetic death raised inside a killed worker's task."""


@dataclass(frozen=True)
class FaultSpec:
    """WHERE and WHEN to kill: ``worker`` dies at its ``invocation``-th
    task call of iteration ``iteration``; ``kill_host`` additionally
    fails the host its devices live on (needs a SimulatedCluster)."""
    worker: str
    iteration: int
    invocation: int = 0
    kill_host: bool = False


class FaultInjector:
    """One-shot kill switch threaded through the task-fn layer.

    Usage (what WorkflowRunner does when given an injector)::

        task_fns = injector.arm(task_fns)       # once, after build
        injector.set_iteration(it)              # every run_iteration
        ... controller.execute(...)             # raises WorkerFailure
                                                # wrapping InjectedFault

    Wrapping the task fns — rather than worker methods — catches every
    execution path (Temporal direct calls, Pipelined threads, cycle
    member threads) at the single choke point they share.
    """

    def __init__(self, spec: FaultSpec, cluster: Optional[Any] = None):
        self.spec = spec
        self.cluster = cluster
        self.fired = False
        self._iteration: Optional[int] = None
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def set_iteration(self, it: int) -> None:
        """Mark the current training iteration; invocation counts reset
        (they index phase boundaries WITHIN one iteration)."""
        with self._lock:
            self._iteration = it
            self._counts = {}

    def arm(self, task_fns: Dict[str, Callable[[Any, Dict], Dict]]
            ) -> Dict[str, Callable[[Any, Dict], Dict]]:
        """Return task fns with the kill switch spliced in front."""
        return {name: self._wrap(name, fn) for name, fn in task_fns.items()}

    def _wrap(self, name: str, fn: Callable) -> Callable:
        def wrapped(w: Any, chunk: Dict) -> Dict:
            self._maybe_fire(name, w)
            return fn(w, chunk)

        wrapped.__name__ = getattr(fn, "__name__", name)
        return wrapped

    def _maybe_fire(self, name: str, w: Any) -> None:
        if getattr(w, "_injected_dead", False):
            # a dead instance stays dead until recovery rebuilds it
            raise InjectedFault(f"worker {name!r} is dead")
        with self._lock:
            if (self.fired or name != self.spec.worker
                    or self._iteration != self.spec.iteration):
                return
            c = self._counts.get(name, 0)
            self._counts[name] = c + 1
            if c != self.spec.invocation:
                return
            self.fired = True
        w._injected_dead = True
        if self.spec.kill_host and self.cluster is not None:
            devs = list(getattr(w, "devices", ()) or ())
            if devs and hasattr(self.cluster, "fail_host"):
                self.cluster.fail_host(self.cluster.node_of(devs[0]))
        raise InjectedFault(
            f"injected fault: worker {name!r} killed at iteration "
            f"{self.spec.iteration}, invocation {self.spec.invocation}"
            + (" (host down)" if self.spec.kill_host else ""))


class HeartbeatMonitor:
    """Liveness by progress: every task call beats; silence past
    ``timeout`` marks the worker suspect.  Covers the failure mode typed
    exceptions cannot — a hung worker that never raises.

    ``clock`` is injectable so tests advance time explicitly instead of
    sleeping.

    Straggler detection rides on the same beats: every beat records the
    interval since the worker's previous beat (bounded history), and
    :meth:`suspects` surfaces workers whose *current* silence already
    dwarfs their own recorded cadence — slow-but-alive workers, long
    before the hard ``timeout`` declares them dead.
    """

    # beat intervals kept per worker for the straggler percentile
    HISTORY = 256

    def __init__(self, timeout: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self._clock = clock
        self._last: Dict[str, float] = {}
        self._intervals: Dict[str, deque] = {}
        self._lock = threading.Lock()

    def beat(self, worker: str) -> None:
        with self._lock:
            now = self._clock()
            prev = self._last.get(worker)
            if prev is not None:
                self._intervals.setdefault(
                    worker, deque(maxlen=self.HISTORY)).append(now - prev)
            self._last[worker] = now

    def last_beat(self, worker: str) -> Optional[float]:
        with self._lock:
            return self._last.get(worker)

    def intervals(self, worker: str) -> List[float]:
        with self._lock:
            return list(self._intervals.get(worker, ()))

    def interval_percentile(self, worker: str,
                            percentile: float = 95.0) -> Optional[float]:
        """The ``percentile``-th recorded beat interval for ``worker``
        (None with no history) — the per-worker cadence number run_loop
        publishes as a straggler gauge each iteration."""
        with self._lock:
            hist = self._intervals.get(worker)
            if not hist:
                return None
            ordered = sorted(hist)
            k = min(len(ordered) - 1,
                    int(len(ordered) * percentile / 100.0))
            return ordered[k]

    def suspects(self, percentile: float = 95.0,
                 factor: float = 3.0,
                 min_history: int = 3) -> List[str]:
        """Workers whose current silence exceeds ``factor`` times their
        own ``percentile``-th beat interval — stragglers, surfaced while
        still under the hard ``timeout``.  Workers with fewer than
        ``min_history`` recorded intervals have no cadence to compare
        against and are never suspected."""
        now = self._clock()
        out = []
        with self._lock:
            for w, last in self._last.items():
                hist = self._intervals.get(w)
                if hist is None or len(hist) < min_history:
                    continue
                ordered = sorted(hist)
                k = min(len(ordered) - 1,
                        int(len(ordered) * percentile / 100.0))
                typical = ordered[k]
                if now - last > factor * max(typical, 1e-9):
                    out.append(w)
        return sorted(out)

    def silent(self) -> List[str]:
        """Workers whose last beat is older than ``timeout``."""
        now = self._clock()
        with self._lock:
            return sorted(w for w, t in self._last.items()
                          if now - t > self.timeout)

    def check(self) -> None:
        """Raise if any tracked worker has gone silent."""
        dead = self.silent()
        if dead:
            raise TimeoutError(
                f"no heartbeat from {dead} for > {self.timeout}s")

    def reset(self) -> None:
        with self._lock:
            self._last = {}
            self._intervals = {}
