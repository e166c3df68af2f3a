"""Plan-vs-actual analysis: overlay the simulator's predicted schedule
on a traced timeline.

Three outputs, all derived from one :class:`FlowReport`:

  * **device utilization** — per-device busy/bubble fractions computed
    from the executor's task spans and the plan's placement;
  * **gap attribution** — every bubble is charged to the most specific
    cause whose span overlaps it, in priority order
    ``switch > sync > channel-wait > preemption > straggler > idle``
    (a straggler bubble = this device idle while another plan device is
    still busy on the same iteration; what is left is true idle);
  * **drift table** — per-node predicted-vs-measured seconds, the ratio
    the CostModels are off by.  :func:`apply_drift` blends these ratios
    back into the profiles — the same feedback the ROADMAP's online
    re-planner will consume.

This module sits ABOVE core (it imports the Simulator and CostModels);
``obs/__init__`` therefore exposes it lazily so ``core.channel`` can
import ``obs.trace`` without a cycle.

A copy of the JAX package's ``obs/report.py`` over the port's profiler,
simulator and tracer; only its imports differ.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.profiler import CostModel
from repro_torch.core.simulator import SimResult, Simulator
from repro_torch.obs.trace import Tracer

Interval = Tuple[float, float]

# bubble causes in attribution priority order (most specific first)
GAP_CAUSES = ("switch", "sync", "channel-wait", "preemption", "straggler",
              "idle")


# ---------------------------------------------------------------------------
# interval algebra
# ---------------------------------------------------------------------------
def merge_intervals(ivs: Sequence[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for lo, hi in sorted((lo, hi) for lo, hi in ivs if hi > lo):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def total(ivs: Sequence[Interval]) -> float:
    return sum(hi - lo for lo, hi in ivs)


def intersect(a: Sequence[Interval], b: Sequence[Interval]) -> List[Interval]:
    """Intersection of two MERGED (sorted, disjoint) interval lists."""
    out: List[Interval] = []
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: Sequence[Interval], b: Sequence[Interval]) -> List[Interval]:
    """a minus b, both merged; returns merged remainder."""
    out: List[Interval] = []
    b = list(b)
    for lo, hi in a:
        cur = lo
        for blo, bhi in b:
            if bhi <= cur or blo >= hi:
                continue
            if blo > cur:
                out.append((cur, blo))
            cur = max(cur, bhi)
            if cur >= hi:
                break
        if cur < hi:
            out.append((cur, hi))
    return out


def complement(ivs: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    return subtract([(lo, hi)], merge_intervals(ivs))


# ---------------------------------------------------------------------------
# report datatypes
# ---------------------------------------------------------------------------
@dataclass
class DeviceUtil:
    device: int
    busy_s: float
    wall_s: float
    gaps: Dict[str, float] = field(default_factory=dict)

    @property
    def busy_frac(self) -> float:
        return self.busy_s / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def bubble_frac(self) -> float:
        return 1.0 - self.busy_frac


@dataclass
class DriftRow:
    worker: str
    predicted_s: float
    measured_s: float
    calls: int

    @property
    def ratio(self) -> float:
        """measured / predicted — the factor the CostModel is off by
        (1.0 = perfect prediction; 0 predicted with nonzero measured
        reads as inf drift)."""
        if self.predicted_s > 0:
            return self.measured_s / self.predicted_s
        return float("inf") if self.measured_s > 0 else 1.0


@dataclass
class FlowReport:
    predicted_wall: float
    measured_wall: float
    devices: List[DeviceUtil] = field(default_factory=list)
    drift: List[DriftRow] = field(default_factory=list)
    iterations: int = 1

    @property
    def wall_ratio(self) -> float:
        """measured / predicted wall — the headline drift number."""
        if self.predicted_wall > 0:
            return self.measured_wall / self.predicted_wall
        return float("inf") if self.measured_wall > 0 else 1.0

    def bubble_fraction(self) -> float:
        """Device-second-weighted bubble fraction across the plan."""
        wall = sum(d.wall_s for d in self.devices)
        if wall <= 0:
            return 0.0
        return sum(d.wall_s - d.busy_s for d in self.devices) / wall

    def gap_totals(self) -> Dict[str, float]:
        out = {c: 0.0 for c in GAP_CAUSES}
        for d in self.devices:
            for c, s in d.gaps.items():
                out[c] = out.get(c, 0.0) + s
        return out

    def to_json(self) -> Dict[str, Any]:
        return {
            "predicted_wall_s": self.predicted_wall,
            "measured_wall_s": self.measured_wall,
            "wall_ratio": self.wall_ratio,
            "iterations": self.iterations,
            "bubble_fraction": self.bubble_fraction(),
            "gap_totals_s": self.gap_totals(),
            "devices": [
                {"device": d.device, "busy_s": d.busy_s, "wall_s": d.wall_s,
                 "busy_frac": d.busy_frac, "gaps_s": d.gaps}
                for d in self.devices],
            "drift": [
                {"worker": r.worker, "predicted_s": r.predicted_s,
                 "measured_s": r.measured_s, "calls": r.calls,
                 "ratio": r.ratio}
                for r in self.drift],
        }

    def format(self) -> str:
        lines = [
            "== plan vs actual ==",
            f"predicted wall {self.predicted_wall:9.4f}s   "
            f"measured wall {self.measured_wall:9.4f}s   "
            f"ratio {self.wall_ratio:6.3f}   "
            f"({self.iterations} iteration(s))",
            "",
            "-- device utilization --",
            f"{'dev':>4s} {'busy%':>7s} {'busy_s':>9s} "
            + " ".join(f"{c:>12s}" for c in GAP_CAUSES),
        ]
        for d in sorted(self.devices, key=lambda x: x.device):
            lines.append(
                f"{d.device:4d} {100 * d.busy_frac:6.1f}% {d.busy_s:9.4f} "
                + " ".join(f"{d.gaps.get(c, 0.0):12.4f}" for c in GAP_CAUSES))
        lines += [
            f"bubble fraction (device-weighted): "
            f"{100 * self.bubble_fraction():.1f}%",
            "",
            "-- drift table (measured / predicted per node) --",
            f"{'node':24s} {'pred_s':>10s} {'meas_s':>10s} "
            f"{'calls':>6s} {'ratio':>7s}",
        ]
        for r in sorted(self.drift, key=lambda x: x.worker):
            ratio = f"{r.ratio:7.3f}" if r.ratio != float("inf") else "    inf"
            lines.append(f"{r.worker:24s} {r.predicted_s:10.4f} "
                         f"{r.measured_s:10.4f} {r.calls:6d} {ratio}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the analysis
# ---------------------------------------------------------------------------
def _cause_intervals(tracer: Tracer, window: Interval
                     ) -> Dict[str, List[Interval]]:
    """Merged interval lists per attributable cause, clipped later by
    intersection with each gap."""
    out: Dict[str, List[Interval]] = {}
    out["switch"] = merge_intervals(
        [(s.t0, s.t1) for s in tracer.spans("switch")])
    out["sync"] = merge_intervals(
        [(s.t0, s.t1) for s in tracer.spans("sync")])
    out["channel-wait"] = merge_intervals(
        [(s.t0, s.t1) for s in tracer.spans("channel-wait")])
    # preemption is an instant — charge a small neighbourhood around each
    # event so it can claim overlap (the re-prefill cost it stands for
    # has no span of its own)
    eps = max((window[1] - window[0]) * 1e-3, 1e-9)
    out["preemption"] = merge_intervals(
        [(i.t - eps, i.t + eps) for i in tracer.instants()
         if i.name == "preempt"])
    return out


def _worker_of(span) -> Optional[str]:
    return span.args.get("worker")


def plan_vs_actual(plan: Any, profiles: Dict[str, CostModel],
                   tracer: Tracer, total_batch: int,
                   iterations: int = 1,
                   sim: Optional[SimResult] = None) -> FlowReport:
    """Overlay prediction on measurement.

    ``plan`` is a ``core.controller.ExecutionPlan`` (schedule + placement
    + cycle members); ``tracer`` holds the executed run's spans.  The
    prediction is re-simulated here (or passed in via ``sim``) so the
    report never depends on what the planner happened to cache.
    """
    if sim is None:
        simulator = Simulator(profiles, members=getattr(plan, "members", {}))
        sim = simulator.run_iterations(plan.schedule, total_batch, iterations)

    tasks = tracer.spans("task")
    iters = tracer.spans("iteration")
    anchor = iters if iters else tasks
    if anchor:
        window = (min(s.t0 for s in anchor), max(s.t1 for s in anchor))
    else:
        window = (0.0, 0.0)
    wall = window[1] - window[0]

    placement: Dict[str, List[int]] = dict(getattr(plan, "placement", {}))

    # per-device busy intervals from task spans (device ids recorded on
    # the span win; the plan's placement is the fallback)
    busy: Dict[int, List[Interval]] = {}
    for s in tasks:
        w = _worker_of(s)
        devs = s.args.get("devices") or placement.get(w, [])
        for d in devs:
            busy.setdefault(int(d), []).append((s.t0, s.t1))
    for d in {d for devs in placement.values() for d in devs}:
        busy.setdefault(int(d), [])
    busy = {d: merge_intervals(ivs) for d, ivs in busy.items()}

    causes = _cause_intervals(tracer, window)
    devices: List[DeviceUtil] = []
    for d in sorted(busy):
        b = intersect(busy[d], [window])
        gaps = complement(b, *window)
        charged: Dict[str, float] = {c: 0.0 for c in GAP_CAUSES}
        remaining = gaps
        for cause in ("switch", "sync", "channel-wait", "preemption"):
            hit = intersect(remaining, causes[cause])
            charged[cause] = total(hit)
            remaining = subtract(remaining, hit)
        # straggler: this device idle while some OTHER device is busy
        others = merge_intervals(
            [iv for od, ivs in busy.items() if od != d for iv in ivs])
        hit = intersect(remaining, others)
        charged["straggler"] = total(hit)
        remaining = subtract(remaining, hit)
        charged["idle"] = total(remaining)
        devices.append(DeviceUtil(device=d, busy_s=total(b), wall_s=wall,
                                  gaps=charged))

    # drift table: predicted busy seconds per sim worker vs measured task
    # seconds per worker (cycle members fold into their collapsed node,
    # which is the name the simulator prices)
    predicted: Dict[str, float] = {}
    for s in sim.spans:
        if s.kind == "compute":
            predicted[s.worker] = predicted.get(s.worker, 0.0) \
                + (s.end - s.start)
    measured: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    for s in tasks:
        w = _worker_of(s)
        if w is None:
            continue
        measured[w] = measured.get(w, 0.0) + s.dur
        calls[w] = calls.get(w, 0) + 1
    for node, ms in getattr(plan, "members", {}).items():
        if node in predicted and node not in measured:
            measured[node] = sum(measured.pop(m, 0.0) for m in ms)
            calls[node] = sum(calls.pop(m, 0) for m in ms)
    drift = [DriftRow(worker=w, predicted_s=p,
                      measured_s=measured.get(w, 0.0),
                      calls=calls.get(w, 0))
             for w, p in sorted(predicted.items())]

    return FlowReport(predicted_wall=sim.makespan, measured_wall=wall,
                      devices=devices, drift=drift, iterations=iterations)


def apply_drift(profiles: Dict[str, CostModel], report: FlowReport,
                blend: float = 0.5) -> Dict[str, float]:
    """Feed measured drift back into the CostModels.

    Each node's base/slope scale by ``1 - blend + blend * ratio`` —
    blend=0 keeps the profile, blend=1 trusts the measurement outright.
    Nodes with no measured calls (or unbounded ratio) are left alone.
    Returns {worker: applied factor} for logging; this is the hook the
    ROADMAP's online re-planner builds on.
    """
    applied: Dict[str, float] = {}
    for row in report.drift:
        cm = profiles.get(row.worker)
        if cm is None or row.calls == 0 or row.ratio == float("inf"):
            continue
        factor = 1.0 - blend + blend * row.ratio
        if factor <= 0:
            continue
        cm.base_time *= factor
        cm.slope_time *= factor
        applied[row.worker] = factor
    return applied


def replay_sim(sim: SimResult, tracer: Optional[Tracer] = None,
               placement: Optional[Dict[str, List[int]]] = None,
               epoch: float = 0.0) -> Tracer:
    """Convert a Simulator timeline into Tracer spans (one lane per
    worker) so benchmarks and simulated tests share the same report and
    export code as the real runtime.  Compute spans become cat="task"
    (with the placement's device ids when given); switch spans become
    cat="switch"; one cat="iteration" span covers the makespan."""
    if tracer is None:
        tracer = Tracer(clock=lambda: 0.0)
        tracer.epoch = epoch
    for s in sim.spans:
        if s.kind == "switch":
            tracer.add(s.worker, "switch", epoch + s.start, epoch + s.end,
                       lane=s.worker)
        else:
            devs = (placement or {}).get(s.worker, [])
            tracer.add(s.worker, "task", epoch + s.start, epoch + s.end,
                       lane=s.worker, worker=s.worker, chunk=s.chunk,
                       devices=list(devs))
    t0 = min((s.start for s in sim.spans), default=0.0)
    tracer.add("iteration", "iteration", epoch + t0,
               epoch + t0 + sim.makespan, lane="run")
    return tracer


def report_to_json_file(report: FlowReport, path: str) -> None:
    with open(path, "w") as f:
        json.dump(report.to_json(), f, indent=2, sort_keys=True)
        f.write("\n")
