"""Discrete-event executor for Schedule trees.

Replays a schedule against the cost models, producing a timeline of
(worker, devices, t_start, t_end, chunk) — the Gantt data behind the
paper's Figs. 11–13 analogues — and a makespan that validates the
scheduler's analytic estimate (tests assert they agree).

The simulation models:
  * pipelined stages with chunk granularity m (stage s processes chunk i,
    hands it downstream; stage occupancy respects the bottleneck);
  * temporal context switches with onload/offload latency;
  * the long-tail effect inside generation-like stages (tail_factor).

A copy of the JAX package's ``core/simulator.py``; only its imports
differ.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.profiler import CostModel
from repro_torch.core.scheduler import (
    Async,
    Leaf,
    Pipelined,
    Temporal,
    cycle_hybrid_time,
)


@dataclass
class Span:
    worker: str
    devices: int
    start: float
    end: float
    chunk: int = -1
    kind: str = "compute"  # compute | switch


@dataclass
class SimResult:
    makespan: float
    spans: List[Span] = field(default_factory=list)

    def busy_time(self, worker: str) -> float:
        return sum(s.end - s.start for s in self.spans
                   if s.worker == worker and s.kind == "compute")

    def breakdown(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s in self.spans:
            key = s.worker if s.kind == "compute" else f"{s.worker}:switch"
            out[key] = out.get(key, 0.0) + (s.end - s.start)
        return out

    def gantt(self) -> str:
        lines = []
        for s in sorted(self.spans, key=lambda x: (x.worker, x.start)):
            lines.append(
                f"{s.worker:24s} [{s.start:8.2f} -> {s.end:8.2f}] "
                f"n={s.devices:3d} chunk={s.chunk} {s.kind}")
        return "\n".join(lines)


class Simulator:
    def __init__(self, profiles: Dict[str, CostModel],
                 members: Optional[Dict[str, Tuple[str, ...]]] = None):
        self.profiles = profiles
        self.members = members or {}

    def _leaf_time(self, leaf: Leaf, batch: int) -> float:
        frac = batch / max(self._total, 1)
        ms = self.members.get(leaf.worker, (leaf.worker,))
        if len(ms) == 1:
            return self.profiles[leaf.worker].time(batch, leaf.devices, frac)
        # Collapsed cycle: replay the realization RECORDED on the Leaf
        # (Leaf.cycle_mode / member_devices) — the simulator used to
        # re-derive the scheduler's cheaper-of-two costing here and could
        # disagree with what would actually run.
        n = leaf.devices
        t_shared = sum(self.profiles[m].time(batch, n, frac) for m in ms)
        if leaf.cycle_mode == "collocated":
            return t_shared
        if leaf.cycle_mode == "hybrid" and leaf.member_devices:
            return cycle_hybrid_time(self.profiles, ms, leaf.member_devices,
                                     batch, frac, leaf.cycle_chunks)
        # legacy leaf with no recorded realization: cheaper-of-two over
        # an even split (pre-recording behaviour)
        best = t_shared
        if len(ms) >= 2 and n >= len(ms):
            even = max(n // len(ms), 1)
            ts = [self.profiles[m].time(batch, even, frac) for m in ms]
            best = min(best, max(ts) + (sum(ts) - max(ts)) / max(batch, 1))
        return best

    # ------------------------------------------------------------------
    def run(self, sched, total_batch: int, t0: float = 0.0) -> SimResult:
        self._total = total_batch
        spans: List[Span] = []
        end = self._run(sched, total_batch, t0, spans)
        return SimResult(makespan=end - t0, spans=spans)

    def run_iterations(self, sched, total_batch: int, iterations: int,
                       t0: float = 0.0) -> SimResult:
        """Horizon replay: an Async schedule embeds its own iteration
        count (which must agree with ``iterations`` — a silent mismatch
        would skew any tokens/makespan throughput the caller derives);
        any other schedule runs back-to-back (the sync baseline)."""
        if isinstance(sched, Async):
            if sched.iterations != iterations:
                raise ValueError(
                    f"Async schedule was built for {sched.iterations} "
                    f"iterations, asked to replay {iterations}")
            return self.run(sched, total_batch, t0)
        self._total = total_batch
        spans: List[Span] = []
        t = t0
        for _ in range(iterations):
            t = self._run(sched, total_batch, t, spans)
        return SimResult(makespan=t - t0, spans=spans)

    def _run(self, sched, batch: int, t0: float, spans: List[Span]) -> float:
        if isinstance(sched, Leaf):
            t = self._leaf_time(sched, batch)
            spans.append(Span(sched.worker, sched.devices, t0, t0 + t))
            return t0 + t

        if isinstance(sched, Temporal):
            mid = self._run(sched.s, batch, t0, spans)
            if sched.switch_cost:
                spans.append(Span("context-switch", 0, mid,
                                  mid + sched.switch_cost, kind="switch"))
                mid += sched.switch_cost
            return self._run(sched.t, batch, mid, spans)

        if isinstance(sched, Pipelined):
            m = sched.granularity
            chunks = max(batch // m, 1)
            # per-chunk completion recursion: stage s chunk i can start when
            # (a) chunk i's upstream is done, (b) stage finished chunk i-1
            s_end = [0.0] * chunks
            t_end = [0.0] * chunks
            prev_s = t0
            for i in range(chunks):
                start = prev_s
                dur_s = self._stage_time(sched.s, m)
                s_spans: List[Span] = []
                self._run_stage(sched.s, m, start, s_spans, i)
                spans.extend(s_spans)
                s_end[i] = start + dur_s
                prev_s = s_end[i]
            prev_t = t0
            for i in range(chunks):
                start = max(s_end[i], prev_t)
                dur_t = self._stage_time(sched.t, m)
                t_spans: List[Span] = []
                self._run_stage(sched.t, m, start, t_spans, i)
                spans.extend(t_spans)
                t_end[i] = start + dur_t
                prev_t = t_end[i]
            return t_end[-1]

        if isinstance(sched, Async):
            # Cross-iteration overlap with bounded staleness K: iteration
            # i's producer starts once (a) its own previous iteration and
            # (b) the consumer's iteration i-K-1 have finished — the exact
            # recurrence of scheduler.async_makespan, replayed with spans
            # (chunk = iteration index).
            I, K = sched.iterations, sched.depth
            dur_s = self._stage_time(sched.s, batch)
            dur_t = self._stage_time(sched.t, batch)
            s_end = [0.0] * I
            t_end = [0.0] * I
            for i in range(I):
                gate = t_end[i - K - 1] if i - K - 1 >= 0 else t0
                start_s = max(s_end[i - 1] if i >= 1 else t0, gate)
                self._run_stage(sched.s, batch, start_s, spans, i)
                s_end[i] = start_s + dur_s
                start_t = max(s_end[i], t_end[i - 1] if i >= 1 else t0)
                self._run_stage(sched.t, batch, start_t, spans, i)
                t_end[i] = start_t + dur_t
            return t_end[-1]

        raise TypeError(type(sched))

    def _stage_time(self, sched, m: int) -> float:
        if isinstance(sched, Leaf):
            return self._leaf_time(sched, m)
        if isinstance(sched, Temporal):
            return (self._stage_time(sched.s, m) + sched.switch_cost
                    + self._stage_time(sched.t, m))
        if isinstance(sched, Pipelined):
            # nested pipeline over this chunk: the inner pipeline may
            # re-chunk at a finer granularity m' — same formula as the
            # scheduler: t_crit + (chunks-1) * t_bottleneck
            g = sched.granularity
            chunks = max(m // g, 1)
            ts = self._stage_time(sched.s, g)
            tt = self._stage_time(sched.t, g)
            return ts + tt + (chunks - 1) * max(ts, tt)
        raise TypeError(type(sched))

    def _run_stage(self, sched, m: int, t0: float, spans: List[Span],
                   chunk: int) -> float:
        if isinstance(sched, Leaf):
            t = self._leaf_time(sched, m)
            spans.append(Span(sched.worker, sched.devices, t0, t0 + t,
                              chunk=chunk))
            return t0 + t
        if isinstance(sched, Temporal):
            mid = self._run_stage(sched.s, m, t0, spans, chunk)
            if sched.switch_cost:
                spans.append(Span("context-switch", 0, mid,
                                  mid + sched.switch_cost, kind="switch",
                                  chunk=chunk))
                mid += sched.switch_cost
            return self._run_stage(sched.t, m, mid, spans, chunk)
        if isinstance(sched, Pipelined):
            mid = self._run_stage(sched.s, sched.granularity, t0, spans, chunk)
            return self._run_stage(sched.t, sched.granularity, mid, spans,
                                   chunk)
        raise TypeError(type(sched))
