"""Shared profile → plan → execute driver for RL workflows (paper Fig. 5b).

`GRPORunner` and `RLHFRunner` used to duplicate this loop (and RLHF
bypassed the runtime entirely, calling workers imperatively).  The
:class:`WorkflowRunner` base makes the loop declarative — a subclass
names its workers, task functions and workflow graph, and the base owns:

  ``profile()``         one traced iteration in topological order →
                        per-worker :class:`CostModel`s (timings, memory,
                        on/offload round-trips, measured rollout tail);
  ``plan_execution()``  Controller.plan → a *binding* ExecutionPlan;
  ``run_iteration()``   measured weight sync through the resharding data
                        plane + ``Controller.execute`` (which diffs the
                        plan's placement, rebinds worker device slices,
                        and drives Temporal cuts through the managed
                        ContextSwitcher);
  ``run()``             the whole loop.

Both the GRPO chain and the RLHF diamond therefore exercise the same
binding-placement path; a new workflow is ~five declarative hooks.

Counterpart of the JAX package's ``rl/runner.py``.  Weight sync COPIES
the trainer's params into each target's own tensors
(``comm.resharding.timed_weight_sync``): the trainer updates its params
in place, so a reference would change the targets' weights under them.
Periodic checkpointing, resume and failure recovery need
``train/checkpoint.py``, which is not ported yet (ROADMAP.md queue 1,
item 6), so a runner given ``checkpoint_dir`` or ``fault_injector``
raises.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.comm.resharding import timed_weight_sync, transfer_stats
from repro_torch.core import Cluster, Controller, FlowGraph, Profiler, SchedulerConfig
from repro_torch.core.faults import HeartbeatMonitor
from repro_torch.core.flowgraph import topological_sort
from repro_torch.core.pipeline import assert_no_leaked_threads
from repro_torch.core.profiler import CostModel, fit_tail_factor, measure_onoffload
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.utils import logging as _log

CHECKPOINT_UNPORTED = (
    "checkpointing, resume and failure recovery need train/checkpoint.py, "
    "which the port does not have yet (ROADMAP.md queue 1, item 6: "
    "train/checkpoint.py)")


class WorkflowRunner:
    """Owns the workers + controller and drives the M2Flow-scheduled loop.

    Subclass responsibilities (the declarative surface):

      * ``build_workers()  -> {node: Worker}``
      * ``build_task_fns() -> {node: fn(worker, chunk) -> chunk}``
      * ``build_graph()    -> FlowGraph`` over the same node names
      * ``make_batch()     -> dict-of-arrays batch``
      * ``scheduler_config() -> SchedulerConfig``
      * ``_record_stats(it, wall, out) -> stat`` (appends + returns)
      * optionally ``post_execute(out)``, ``log_iteration(st)``,
        ``weight_sync_workers`` (node names that receive trainer
        weights; the trainer must expose ``params()`` as ``self.actor``).
    """

    # node names whose workers receive the trainer's weights each
    # iteration (must expose update_weights)
    weight_sync_workers: Tuple[str, ...] = ("rollout", "inference")
    # the one sync target whose update_weights accepts a version tag
    # (its engine stamps per-request weight versions for the async
    # staleness correction); None = no versioned target
    versioned_sync_worker: Optional[str] = "rollout"

    def __init__(self, *, iterations: int, batch_size: int,
                 mode: str = "auto",
                 profile_batches: Sequence[int] = (8, 32),
                 cluster: Optional[Cluster] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0,
                 fault_injector: Optional[Any] = None):
        if checkpoint_dir or checkpoint_every or fault_injector is not None:
            raise NotImplementedError(CHECKPOINT_UNPORTED)
        self.iterations = iterations
        self.batch_size = batch_size
        self.mode = mode
        self.profile_batches = tuple(profile_batches)
        self.cluster = cluster or Cluster(num_nodes=1, devices_per_node=8)
        self.workers: Dict[str, Any] = self.build_workers()
        self.task_fns: Dict[str, Callable] = self.build_task_fns()
        self._graph: Optional[FlowGraph] = None
        # straggler observability: every task call beats the monitor
        # (via the executor), run_loop reads the interval percentiles.
        # The hard timeout is infinite — the monitor's job here is
        # cadence statistics, not liveness enforcement
        self.heartbeat = HeartbeatMonitor(timeout=math.inf)
        self.controller = Controller(self.cluster, heartbeat=self.heartbeat)
        self.plan = None
        self.stats: List[Any] = []
        # cumulative weight-sync accounting (the copy data plane): total
        # measured seconds, total bytes moved, number of syncs
        self.sync_stats: Dict[str, float] = {
            "seconds": 0.0, "bytes": 0.0, "syncs": 0}

    # ------------------------------------------------------------------
    # declarative surface
    # ------------------------------------------------------------------
    def build_workers(self) -> Dict[str, Any]:
        raise NotImplementedError

    def build_task_fns(self) -> Dict[str, Callable]:
        raise NotImplementedError

    def build_graph(self) -> FlowGraph:
        raise NotImplementedError

    def make_batch(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def scheduler_config(self) -> SchedulerConfig:
        return SchedulerConfig(total_batch=self.batch_size)

    def cycle_specs(self) -> Dict[str, Any]:
        """{collapsed node name: core.pipeline.CycleSpec} for workflows
        whose graph contains cycles (e.g. embodied sim<->generation);
        the executor needs them to run a cycle Leaf as a closed loop."""
        return {}

    def _record_stats(self, it: int, wall: float, out) -> Any:
        raise NotImplementedError

    def post_execute(self, out):
        """Hook after the planned graph ran (e.g. auxiliary updates that
        ride with the training stage)."""
        return out

    def log_iteration(self, st) -> None:
        print(f"iter {st.iteration:3d}  wall={st.wall_time:6.2f}s "
              f"reward={st.mean_reward:+6.2f} acc={st.accuracy:5.2f}")

    # ------------------------------------------------------------------
    def graph(self) -> FlowGraph:
        if self._graph is None:
            self._graph = self.build_graph()
        return self._graph

    def topo_order(self) -> List[str]:
        return list(topological_sort(self.graph().g))

    # ------------------------------------------------------------------
    # weight sync: a data-plane operation through comm.resharding
    # ------------------------------------------------------------------
    def _sync_weights(self, params: Optional[Any] = None,
                      version: Optional[int] = None) -> float:
        """Copy the trainer's params into each generation-side worker's
        own tensors on its device (``timed_weight_sync``), with byte
        accounting (``transfer_stats``).  The measured cost lands in the
        target workers' CostModels (``sync_time``/``sync_bytes``) where the
        Scheduler charges it on the Temporal cut that brings the worker
        back online.  Returns the measured seconds of this sync."""
        if params is None:
            params = self.actor.params()
        stats = transfer_stats(params)
        total = 0.0
        for name in self.weight_sync_workers:
            w = self.workers.get(name)
            if w is None:
                continue
            synced, dt = timed_weight_sync(params, w.sync_destination(params))
            total += dt
            if version is not None and name == self.versioned_sync_worker:
                w.update_weights(synced, version=version)
            else:
                w.update_weights(synced)
            cm = self.controller.profiles.get(name)
            if cm is not None:
                cm.sync_time = dt if cm.sync_time == 0.0 \
                    else 0.5 * cm.sync_time + 0.5 * dt
                cm.sync_bytes = stats["bytes"]
        self.sync_stats["seconds"] += total
        self.sync_stats["bytes"] += stats["bytes"] * len(
            [n for n in self.weight_sync_workers if n in self.workers])
        self.sync_stats["syncs"] += 1
        return total

    # ------------------------------------------------------------------
    # Phase 1: profiling iteration — fit cost models along the graph
    # ------------------------------------------------------------------
    def _profile_sizes(self) -> List[int]:
        sizes = [b for b in self.profile_batches if b <= self.batch_size]
        return sizes or [self.batch_size]

    def profile(self) -> FlowGraph:
        self._sync_weights()
        prof = Profiler(warmup=1, repeats=1)
        profiles: Dict[str, CostModel] = {}
        chunk = self.make_batch()
        for name in self.topo_order():
            w, fn = self.workers[name], self.task_fns[name]
            inp = dict(chunk)

            def run_at(b, w=w, fn=fn, inp=inp):
                sub = {k: (v[:b] if isinstance(v, np.ndarray)
                           and v.ndim >= 1 else v)
                       for k, v in inp.items()}
                return fn(w, sub)

            cm = prof.measure(name, run_at, self._profile_sizes())
            chunk = fn(w, inp)
            if hasattr(w, "_state") and w.state_bytes():
                on, off = measure_onoffload(w)
                cm.onload_time, cm.offload_time = on, off
            cm.base_mem = float(w.state_bytes())
            if hasattr(w, "request_records"):
                # engine-backed tail: fit the long-tail multiplier from
                # measured per-request completion times instead of
                # assuming the Fig. 2 length model
                recs = w.request_records()
                if recs:
                    cm.tail_factor = fit_tail_factor(t for _, t in recs)
            profiles[name] = cm
        self.controller.profiles = profiles
        return self.graph()

    # ------------------------------------------------------------------
    def plan_execution(self) -> None:
        self.controller.scheduler_cfg = self.scheduler_config()
        self.plan = self.controller.plan(
            self.graph(), total_batch=self.batch_size, mode=self.mode)

    # ------------------------------------------------------------------
    def run_iteration(self, it: int):
        t0 = time.perf_counter()
        tr = _trace.active()
        if tr is not None:
            tr.set_context(iteration=it)
        try:
            self._sync_weights()
            batch = self.make_batch()
            out = self.controller.execute(
                self.plan, self.workers, self.task_fns, batch,
                cycle_specs=self.cycle_specs())
            out = self.post_execute(out)
        finally:
            wall = time.perf_counter() - t0
            if tr is not None:
                tr.add(f"iteration-{it}", "iteration", t0,
                       time.perf_counter())
                tr.set_context(iteration=None)
        return self._record_stats(it, wall, out)

    # ------------------------------------------------------------------
    # teardown
    # ------------------------------------------------------------------
    def teardown(self) -> None:
        """Release everything the run held: router registrations,
        cluster allocations (both construction-time owners and plan-
        managed ones), the context switcher, and the failure latch.
        After this the cluster looks exactly as it did before the runner
        was constructed."""
        for name, w in self.workers.items():
            if hasattr(w, "shutdown"):
                w.shutdown()
            self.cluster.free(name)
        self.controller.placement_manager.release_all()
        self.controller._switcher = None
        self.controller.profiles = {}
        self.controller.reset_failures()
        self.plan = None
        self._graph = None
        # a wedged executor thread surviving teardown would silently
        # leak into the next run — make it a typed error instead
        assert_no_leaked_threads()

    def _observe_iteration(self, it: int, verbose: bool) -> None:
        """Per-iteration observability: straggler warnings from the
        heartbeat cadence (percentile path — the hard-timeout path only
        catches outright hangs), the matching obs gauges, and a metrics
        snapshot merged into verbose output while tracing is armed."""
        suspects = self.heartbeat.suspects()
        if suspects and verbose:
            _log.warn("straggler",
                      f"iteration {it}: {', '.join(suspects)} running "
                      f"behind their own beat cadence", iteration=it)
        reg = _metrics.active()
        if reg is not None:
            reg.gauge("faults/stragglers").set(len(suspects))
            reg.counter("runner/iterations").inc()
            for name in self.workers:
                p95 = self.heartbeat.interval_percentile(name, 95.0)
                if p95 is not None:
                    reg.gauge(f"faults/beat_p95_s/{name}").set(p95)
            if verbose:
                snap = reg.snapshot()
                for line in _metrics.format_snapshot(snap):
                    _log.info("metrics", line)

    def run_loop(self, verbose: bool = True) -> None:
        if self.plan is None:
            # allow run_loop() as the single entry point
            self.profile()
            self.plan_execution()
        for it in range(self.iterations):
            st = self.run_iteration(it)
            self._observe_iteration(it, verbose)
            if verbose:
                self.log_iteration(st)

    def run(self, verbose: bool = True) -> List[Any]:
        self.profile()
        self.plan_execution()
        if verbose:
            print(self.plan.pretty())
        self.run_loop(verbose)
        return self.stats
