"""Controller: ties profiler → scheduler → executor together (Fig. 4).

Responsibilities (paper §3.1): assign workers to accelerators, manage
inter-worker connections (via the Router), orchestrate the execution flow
by dispatching function invocations, monitor failures, and expose the
worker-group-level timers.

``Controller.plan()`` is the M2Flow transformation entry point: it takes
the traced logical flow + profiles, runs Algorithm 1, and returns an
execution plan (Schedule tree + placement) that ``execute()`` runs.

A copy of the JAX package's ``core/controller.py``, but for strict mode:
flowlint (the JAX package's ``analysis``) is not ported yet, so
``strict=True`` raises instead of linting.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.comm.primitives import global_router, reset_router
from repro_torch.core.channel import Channel
from repro_torch.core.flowgraph import FlowGraph, GraphTracer
from repro_torch.core.pipeline import ExecutionFlowManager
from repro_torch.core.placement import Cluster, PlacementManager, split_devices
from repro_torch.core.profiler import CostModel, Profiler
from repro_torch.core.scheduler import (
    Async,
    Leaf,
    Pipelined,
    Scheduler,
    SchedulerConfig,
    Temporal,
    collocated_schedule,
    disaggregated_schedule,
    leaves,
)
from repro_torch.core.simulator import Simulator
from repro_torch.core.switching import ContextSwitcher
from repro_torch.core.worker import Worker, WorkerFailure, WorkerGroup
from repro_torch.obs import trace as _trace


STRICT_UNPORTED = (
    "strict mode lints every plan with flowlint, which the port does not "
    "have yet (ROADMAP.md queue 1, item 11: observability and lint on the "
    "port); use strict=False")


@dataclass
class ExecutionPlan:
    schedule: Any
    est_time: float
    placement: Dict[str, List[int]]
    mode: str  # "auto" | "collocated" | "disaggregated"
    # collapsed-cycle membership: {collapsed node name: member workers}
    # (only nodes with >= 2 members).  Recorded at plan time so the
    # executor can run the cycle's members without re-condensing the
    # graph, and so the placement column binds the MEMBER workers (the
    # real ones) instead of the synthetic collapsed name.
    members: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    # the graph this plan was derived from, carried so strict-mode
    # analysis (and tooling) can lint plan + graph together
    graph: Optional[Any] = field(default=None, repr=False)

    def pretty(self) -> str:
        lines = [f"mode={self.mode} est={self.est_time:.2f}s"]
        lines.append(self.schedule.pretty())
        for w, devs in self.placement.items():
            span = f"{devs[0]}..{devs[-1]}" if devs else "-"
            lines.append(f"  {w}: devices [{span}] ({len(devs)})")
        return "\n".join(lines)


class Controller:
    def __init__(self, cluster: Cluster,
                 profiles: Optional[Dict[str, CostModel]] = None,
                 scheduler_cfg: Optional[SchedulerConfig] = None,
                 heartbeat: Optional[Any] = None,
                 strict: bool = False):
        self.cluster = cluster
        self.profiles = profiles or {}
        self.scheduler_cfg = scheduler_cfg or SchedulerConfig()
        # strict=True would run flowlint Pass 1-2 on every plan inside
        # execute(); without the lint passes it is refused outright
        if strict:
            raise NotImplementedError(STRICT_UNPORTED)
        self.strict = strict
        self.tracer = GraphTracer()
        self.router = global_router()
        self.placement_manager = PlacementManager(cluster)
        # optional core.faults.HeartbeatMonitor — beaten around every task
        # call by the executor so a silent hang is detectable
        self.heartbeat = heartbeat
        self._switcher: Optional[ContextSwitcher] = None
        self._failed: List[WorkerFailure] = []
        self._kill = threading.Event()

    # ------------------------------------------------------------------
    # failure monitoring (paper §4)
    # ------------------------------------------------------------------
    def report_failure(self, failure: WorkerFailure) -> None:
        self._failed.append(failure)
        # kill the whole system quickly to avoid cascading timeout noise
        self._kill.set()

    @property
    def failed(self) -> List[WorkerFailure]:
        return self._failed

    def check_alive(self) -> None:
        if self._kill.is_set():
            raise self._failed[0]
        if self.heartbeat is not None:
            self.heartbeat.check()

    def reset_failures(self) -> None:
        """Clear failure state after recovery re-established the run."""
        self._failed = []
        self._kill.clear()
        if self.heartbeat is not None:
            self.heartbeat.reset()

    # ------------------------------------------------------------------
    # M2Flow planning
    # ------------------------------------------------------------------
    def plan(self, graph: FlowGraph, *, total_batch: int,
             mode: str = "auto") -> ExecutionPlan:
        # plan over LIVE devices only: after a host failure the surviving
        # devices are the whole universe (recovery re-plans through here)
        avail = self.cluster.available_devices()
        n = len(avail)
        if mode == "collocated":
            t, sched = collocated_schedule(graph, self.profiles, n, total_batch)
        elif mode == "disaggregated":
            t, sched = disaggregated_schedule(graph, self.profiles, n,
                                              total_batch)
        else:
            sch = Scheduler(self.profiles, self.scheduler_cfg)
            t, sched = sch.schedule(graph, n, total_batch)
        members = self._cycle_members(graph)
        placement = self._place(sched, avail, members)
        return ExecutionPlan(schedule=sched, est_time=t, placement=placement,
                             mode=mode, members=members, graph=graph)

    def plan_async(self, graph: FlowGraph, *, total_batch: int,
                   iterations: int = 8,
                   depths: Optional[List[int]] = None) -> ExecutionPlan:
        """M2Flow planning with the async off-policy dimension: searches
        temporal/spatial/async_depth and returns the horizon-optimal plan.
        ``est_time`` is the estimated wall-clock makespan of the whole
        ``iterations`` horizon (schedule_async selects with a freshness
        tax but always returns the untaxed time)."""
        avail = self.cluster.available_devices()
        n = len(avail)
        sch = Scheduler(self.profiles, self.scheduler_cfg)
        t, sched = sch.schedule_async(graph, n, total_batch,
                                      iterations=iterations, depths=depths)
        mode = (f"async-{sched.depth}" if isinstance(sched, Async)
                else "auto")
        members = self._cycle_members(graph)
        placement = self._place(sched, avail, members)
        return ExecutionPlan(schedule=sched, est_time=t, placement=placement,
                             mode=mode, members=members, graph=graph)

    @staticmethod
    def _cycle_members(graph: FlowGraph) -> Dict[str, Tuple[str, ...]]:
        _, members = graph.condense()
        return {name: ms for name, ms in members.items() if len(ms) > 1}

    def _place(self, sched, devices: List[int],
               members: Optional[Dict[str, Tuple[str, ...]]] = None
               ) -> Dict[str, List[int]]:
        """Spatial stages get disjoint device slices; temporal stages
        share.  A collapsed-cycle leaf binds its MEMBER workers: the
        hybrid realization pins each member to its recorded disjoint
        share (Leaf.member_devices); the collocated realization gives
        every member the leaf's full (time-shared) slice."""
        out: Dict[str, List[int]] = {}
        members = members or {}
        if isinstance(sched, Leaf):
            devs = devices[: sched.devices] or devices
            ms = members.get(sched.worker, ())
            if len(ms) > 1:
                if sched.cycle_mode == "hybrid" and sched.member_devices:
                    cur = 0
                    for m, share in zip(ms, sched.member_devices):
                        out[m] = devs[cur:cur + share] or list(devs)
                        cur += share
                else:
                    for m in ms:
                        out[m] = list(devs)
            else:
                out[sched.worker] = devs
            return out
        if isinstance(sched, Temporal):
            out.update(self._place(sched.s, devices, members))
            out.update(self._place(sched.t, devices, members))
            return out
        if isinstance(sched, (Pipelined, Async)):
            # both sides own disjoint device slices, split exactly as the
            # scheduler recorded (summing leaf counts instead would
            # double-count time-shared Temporal stages within one side
            # and starve the other side's slice)
            out.update(self._place(sched.s, devices[:sched.n_s], members))
            out.update(self._place(sched.t, devices[sched.n_s:], members))
            return out
        raise TypeError(type(sched))

    # ------------------------------------------------------------------
    def simulate(self, plan: ExecutionPlan, total_batch: int):
        sim = Simulator(self.profiles)
        return sim.run(plan.schedule, total_batch)

    def bind_placement(self, plan: ExecutionPlan,
                       workers: Dict[str, Any]) -> Dict[str, List[int]]:
        """Make the plan's placement binding: diff against the cluster's
        current allocations and rebind every worker's device slice (and
        mesh/shardings) to what the plan assigns."""
        return self.placement_manager.apply(plan, workers)

    @property
    def switch_stats(self) -> Dict[str, Dict[str, float]]:
        """Measured context-switch costs (worker -> onload/offload s)."""
        return self._switcher.measured if self._switcher else {}

    def _lint(self, plan: ExecutionPlan,
              cycle_specs: Optional[Dict[str, Any]]) -> None:
        """Strict mode: flowlint Pass 1-2 over the plan.  The lint passes
        are not ported, so a strict controller refuses to run a plan
        rather than run it unchecked."""
        raise NotImplementedError(STRICT_UNPORTED)

    def execute(self, plan: ExecutionPlan, workers: Dict[str, Any],
                task_fns: Dict[str, Callable], batch,
                cycle_specs: Optional[Dict[str, Any]] = None) -> Any:
        if self.strict:
            self._lint(plan, cycle_specs)
        self.bind_placement(plan, workers)
        # one switcher per (workers, profiles) pair so measured switch
        # costs accumulate (and keep feeding the CostModels) across
        # iterations
        if (self._switcher is None or self._switcher.workers is not workers
                or self._switcher.profiles is not self.profiles):
            self._switcher = ContextSwitcher(workers, profiles=self.profiles)
        mgr = ExecutionFlowManager(workers, task_fns,
                                   switcher=self._switcher,
                                   members=plan.members,
                                   cycle_specs=cycle_specs,
                                   heartbeat=self.heartbeat,
                                   on_failure=self.report_failure)
        tr = _trace.active()
        if tr is not None:
            with tr.span("execute", "phase", mode=plan.mode,
                         est_time=plan.est_time):
                out = mgr.run(plan.schedule, batch)
        else:
            out = mgr.run(plan.schedule, batch)
        self.last_timeline = mgr.timeline
        self.last_time = mgr.total_time
        self.last_cycle_log = mgr.cycle_log
        return out
