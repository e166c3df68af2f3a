"""Managed context switching for Temporal plan transitions (paper §3.3/§4).

A Temporal cut means two stages time-share the same accelerators; the
transition between them is a *context switch*: the outgoing stage's
state moves to host memory while the incoming stage's state moves back.
The executor used to do this with an ad-hoc ``offload()`` and no cost
feedback; this module makes the transition first-class:

  * **per-key offload** — optimizer state is colder than params, so it
    leaves the device first (``OFFLOAD_KEY_ORDER``); params move last.
    Each key is timed separately, so the records show where switch time
    actually goes.
  * **prefetch-onload** — when the incoming side's placement does not
    conflict with the running stage, its state is restored on a
    background thread (:meth:`prefetch`) overlapped with the stage's
    tail; at the cut itself the incoming side moves in only after the
    outgoing side has freed the shared devices' memory.
  * **measured feedback** — every switch is timed and the observed
    on/offload seconds are blended into the worker's :class:`CostModel`
    (``onload_time`` / ``offload_time``), so after the first executed
    iteration the Scheduler's ``_switch_cost`` charges measured reality
    instead of the profiling estimate.

A copy of the JAX package's ``core/switching.py``; only its imports
differ.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence

from repro_torch.obs import trace as _trace

# Cold keys leave the device first; anything unlisted (e.g. "params")
# follows in registration order.
OFFLOAD_KEY_ORDER = ("opt",)


@dataclass
class SwitchRecord:
    worker: str
    kind: str  # "offload" | "onload"
    key: str
    seconds: float


class ContextSwitcher:
    """Drives (and measures) the offload/onload traffic of Temporal cuts.

    ``workers`` maps plan worker names to :class:`~repro_torch.core.worker.Worker`
    objects; ``profiles`` maps the same names to :class:`CostModel`s that
    receive the measured switch times (shared with the Scheduler, so a
    replan after iteration 1 uses measured costs)."""

    def __init__(self, workers: Dict[str, Any],
                 profiles: Optional[Dict[str, Any]] = None,
                 blend: float = 0.5):
        self.workers = workers
        self.profiles = profiles if profiles is not None else {}
        self.blend = blend
        self.records: List[SwitchRecord] = []
        # worker -> {"onload_time"|"offload_time": blended measured seconds}
        self.measured: Dict[str, Dict[str, float]] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def offload_worker(self, name: str) -> float:
        """Per-key offload of one worker; returns measured seconds."""
        w = self.workers.get(name)
        if w is None or not hasattr(w, "offload"):
            return 0.0
        state_keys = list(getattr(w, "_state", {}) or {})
        keys = [k for k in OFFLOAD_KEY_ORDER if k in state_keys]
        keys += [k for k in state_keys if k not in keys]
        total, moved_any = 0.0, False
        tr = _trace.active()
        for k in keys:
            t0 = time.perf_counter()
            moved = w.offload(keys=(k,))
            t1 = time.perf_counter()
            dt = t1 - t0
            if moved:
                moved_any = True
                total += dt
                with self._lock:
                    self.records.append(
                        SwitchRecord(name, "offload", k, dt))
                if tr is not None:
                    tr.add(f"offload:{name}", "switch", t0, t1,
                           worker=name, key=k)
        if moved_any:
            self._feedback(name, "offload_time", total)
        return total

    def onload_worker(self, name: str) -> float:
        """Restore one worker's host state; returns measured seconds."""
        w = self.workers.get(name)
        if w is None or not hasattr(w, "onload"):
            return 0.0
        t0 = time.perf_counter()
        moved = w.onload()
        t1 = time.perf_counter()
        dt = t1 - t0
        if not moved:
            return 0.0
        with self._lock:
            self.records.append(
                SwitchRecord(name, "onload", "+".join(moved), dt))
        tr = _trace.active()
        if tr is not None:
            tr.add(f"onload:{name}", "switch", t0, t1,
                   worker=name, key="+".join(moved))
        self._feedback(name, "onload_time", dt)
        return dt

    # ------------------------------------------------------------------
    def prefetch(self, names: Iterable[str]) -> threading.Thread:
        """Onload ``names`` on a background thread (overlap with the tail
        of whatever is still running); join the returned thread before
        dispatching work to these workers."""
        names = list(names)

        def run():
            tr = _trace.active()
            if tr is not None:
                # outer span marks the whole overlapped window; per-worker
                # onload spans nest inside it on the ctx-prefetch lane
                with tr.span("prefetch", "switch", workers=names):
                    for n in names:
                        self.onload_worker(n)
            else:
                for n in names:
                    self.onload_worker(n)

        th = threading.Thread(target=run, daemon=True,
                              name="ctx-prefetch")
        th.start()
        return th

    def switch(self, outgoing: Sequence[str],
               incoming: Sequence[str]) -> None:
        """One Temporal transition: offload ``outgoing``, then onload
        ``incoming``.  A Temporal cut exists precisely because the two
        sides time-share devices whose memory cannot hold both working
        sets, so the incoming side's state moves in only AFTER the
        outgoing side has freed its memory (overlapping them would peak
        at the sum of both working sets).  Safe overlap with a running
        stage's tail — when placements do not conflict — is the
        executor's :meth:`prefetch` path, not this one."""
        for n in outgoing:
            if n in incoming:
                continue  # worker survives the cut; keep it resident
            self.offload_worker(n)
        for n in incoming:
            if getattr(self.workers.get(n), "offloaded", False):
                self.onload_worker(n)

    # ------------------------------------------------------------------
    def _feedback(self, name: str, attr: str, seconds: float) -> None:
        with self._lock:
            m = self.measured.setdefault(name, {})
            prev = m.get(attr)
            val = seconds if prev is None else (
                (1.0 - self.blend) * prev + self.blend * seconds)
            m[attr] = val
            cm = self.profiles.get(name)
            if cm is not None:
                setattr(cm, attr, val)
