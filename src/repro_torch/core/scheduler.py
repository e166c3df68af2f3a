"""Profiling-guided scheduling policy — Algorithm 1 of the paper.

Recursively partitions the (cycle-collapsed) workflow DAG along s-t cuts,
evaluating for each cut:

  temporal (shared devices):   T = T_s + T_t + context-switch overhead
  spatial  (disjoint devices): T = T_critical + (M/m − 1) · T_bottleneck
                               over device splits N_s + N_t = N and data
                               granularities m | M

memoized on (subgraph, devices, batch).  Leaves return the profiled cost
model's time.  The result is a Schedule tree that the executor/simulator
can run directly.

A copy of the JAX package's ``core/scheduler.py``; its topological
sorts come from the port's flowgraph in place of ``networkx``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.core.flowgraph import FlowGraph, topological_sort
from repro_torch.core.profiler import CostModel


# ---------------------------------------------------------------------------
# Schedule tree
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Leaf:
    worker: str
    devices: int
    batch: int
    # Collapsed-cycle realization, RECORDED on the plan (paper §3.4) so
    # the simulator and the executor honor what the scheduler chose
    # instead of re-deriving it (and possibly disagreeing):
    #   None          — plain single-worker leaf;
    #   "collocated"  — cycle members alternate per step on the leaf's
    #                   shared devices;
    #   "hybrid"      — members pinned to disjoint device shares
    #                   (member_devices, ordered like the sorted member
    #                   tuple) and fine-grained-pipelined per step over
    #                   `cycle_chunks` env chunks (double-buffering).
    cycle_mode: Optional[str] = None
    member_devices: Optional[Tuple[int, ...]] = None
    cycle_chunks: int = 2

    def pretty(self, indent: str = "") -> str:
        extra = ""
        if self.cycle_mode:
            share = ("+".join(map(str, self.member_devices))
                     if self.member_devices else "shared")
            extra = f", cycle={self.cycle_mode}:{share}"
        return f"{indent}{self.worker}[n={self.devices}, b={self.batch}{extra}]"


@dataclass(frozen=True)
class Temporal:
    """G_s then G_t on the SAME devices (context switch between)."""
    s: "Schedule"
    t: "Schedule"
    switch_cost: float = 0.0

    def pretty(self, indent: str = "") -> str:
        return (f"{indent}Temporal(switch={self.switch_cost:.2f}s)\n"
                f"{self.s.pretty(indent + '  ')}\n"
                f"{self.t.pretty(indent + '  ')}")


@dataclass(frozen=True)
class Pipelined:
    """G_s and G_t on DISJOINT devices, chunked at granularity m."""
    s: "Schedule"
    t: "Schedule"
    granularity: int
    n_s: int
    n_t: int

    def pretty(self, indent: str = "") -> str:
        return (f"{indent}Pipelined(m={self.granularity}, "
                f"N={self.n_s}+{self.n_t})\n"
                f"{self.s.pretty(indent + '  ')}\n"
                f"{self.t.pretty(indent + '  ')}")


@dataclass(frozen=True)
class Async:
    """Cross-ITERATION overlap (bounded-staleness off-policy pipelining).

    ``s`` (producer: generation side) and ``t`` (consumer: training side)
    run on DISJOINT device shares; iteration ``i``'s producer may start as
    soon as the consumer has finished iteration ``i - depth - 1``, so
    rollouts are generated with parameters up to ``depth`` versions stale.
    ``depth = 0`` degenerates to strictly synchronous execution (producer
    waits for every update).  Costed over an ``iterations`` horizon — the
    steady-state increment is the bottleneck side, not the sum.
    """
    s: "Schedule"
    t: "Schedule"
    depth: int        # staleness bound K (versions)
    iterations: int   # horizon the schedule was costed over
    n_s: int
    n_t: int

    def pretty(self, indent: str = "") -> str:
        return (f"{indent}Async(K={self.depth}, iters={self.iterations}, "
                f"N={self.n_s}+{self.n_t})\n"
                f"{self.s.pretty(indent + '  ')}\n"
                f"{self.t.pretty(indent + '  ')}")


Schedule = object  # Leaf | Temporal | Pipelined | Async


def leaves(s: Schedule) -> List[Leaf]:
    if isinstance(s, Leaf):
        return [s]
    return leaves(s.s) + leaves(s.t)


def cycle_hybrid_time(profiles, members: Sequence[str],
                      split: Sequence[int], batch: float, frac: float,
                      chunks: int) -> float:
    """Cost of the HYBRID realization of a collapsed cycle: members on
    disjoint device shares, fine-grained-pipelined over ``chunks`` env
    chunks.  Each member executes every chunk every step, so its device
    occupancy per step is ``chunks * t(batch/chunks)`` — a member whose
    cost is FLAT in the chunk size (a CPU-bound sim, Fig. 3) pays the
    chunk count, which is exactly why collocation wins the LIBERO-like
    regime; a member whose cost scales with envs (GPU-parallel sim,
    generation) keeps its total and hides behind the slower side.
    Steady-state throughput is the slowest member's occupancy; the other
    members' one-chunk fill is the (tiny) warmup term.  The single cost
    semantics shared by Scheduler._leaf and Simulator._leaf_time."""
    C = max(chunks, 1)
    tc = [profiles[m].time(batch / C, n, frac / C)
          for m, n in zip(members, split)]
    occupancy = max(C * t for t in tc)
    warmup = (sum(tc) - max(tc)) * min(1.0 / max(batch, 1), 1.0)
    return occupancy + warmup


def async_makespan(t_s: float, t_t: float, depth: int,
                   iterations: int) -> float:
    """Analytic horizon makespan of an Async schedule — the recurrence the
    event simulator replays span-by-span (they must agree exactly):

        s_end[i] = max(s_end[i-1], t_end[i-depth-1]) + t_s
        t_end[i] = max(s_end[i], t_end[i-1]) + t_t

    The ``t_end[i-depth-1]`` term is the staleness back-pressure: the
    producer may run at most ``depth`` updates ahead of the trainer.
    """
    if iterations < 1:
        raise ValueError(f"iterations must be >= 1, got {iterations}")
    s_end = [0.0] * iterations
    t_end = [0.0] * iterations
    for i in range(iterations):
        gate = t_end[i - depth - 1] if i - depth - 1 >= 0 else 0.0
        s_prev = s_end[i - 1] if i >= 1 else 0.0
        s_end[i] = max(s_prev, gate) + t_s
        t_prev = t_end[i - 1] if i >= 1 else 0.0
        t_end[i] = max(s_end[i], t_prev) + t_t
    return t_end[-1]


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------
@dataclass
class SchedulerConfig:
    total_batch: int = 256
    # candidate data granularities as fractions of the total batch
    granularity_divisors: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    # candidate device splits are multiples of this quantum (e.g. a node
    # of 8 GPUs); 1 = any split
    device_quantum: int = 1
    # pipeline chunk sizes must be multiples of this — the data atomicity
    # unit (e.g. a GRPO group: group-relative advantages are undefined if
    # a chunk boundary splits a group); 1 = any chunk size
    chunk_multiple: int = 1
    # memory capacity per device (bytes); 0 disables feasibility checks
    device_memory: float = 0.0
    # force the realization of collapsed cycle nodes: None = cheaper of
    # the two, "collocated" = members alternate on shared devices,
    # "hybrid" = members on disjoint shares, fine-grained-pipelined
    # (falls back to collocated when the leaf has fewer devices than
    # members).  The fixed settings are the paper's Fig.-9 baselines.
    cycle_mode: Optional[str] = None
    # env-chunk count of the hybrid realization's per-step pipeline
    # (2 = double-buffered obs/action queues); priced by
    # cycle_hybrid_time and recorded on the Leaf for the executor
    cycle_chunks: int = 2
    # --- async off-policy dimension (cross-iteration overlap) ---
    # candidate staleness bounds K searched by schedule_async; 0 = sync
    async_depths: Tuple[int, ...] = (0, 1, 2, 4)
    # freshness cost: stale samples need importance correction and carry
    # less learning signal per sample; modeled as a fractional throughput
    # tax per version of staleness (cost *= 1 + penalty * K).
    staleness_penalty: float = 0.03
    # --- hierarchical planning (scale-out) ---
    # Partition the device pool into host groups and plan inter-group
    # splits coarsely (whole host groups, geometrically spaced) while
    # any subproblem that fits inside one host group is still planned
    # exactly.  None = auto: hierarchical kicks in once n_devices
    # exceeds `hierarchical_threshold`; True/False force it.
    hierarchical: Optional[bool] = None
    host_group_size: int = 8
    hierarchical_threshold: int = 64


class Scheduler:
    def __init__(self, profiles: Dict[str, CostModel],
                 cfg: Optional[SchedulerConfig] = None):
        self.profiles = profiles
        self.cfg = cfg or SchedulerConfig()
        self._memo: Dict[Tuple, Tuple[float, Schedule]] = {}
        # per-subgraph cut decompositions (s_set, t_set, gs, gt): st_cuts
        # enumeration + subgraph copies are independent of (n, batch), so
        # they are computed once per distinct node set, not once per state
        self._cuts: Dict[FrozenSet[str], List[Tuple]] = {}
        self._work: Dict[Tuple, float] = {}
        self.evaluated_cuts = 0
        self._hier = bool(self.cfg.hierarchical)

    def _set_hierarchical(self, n_devices: int) -> None:
        """Resolve the hierarchical flag for one planning call: forced by
        cfg.hierarchical, else auto once the pool outgrows the threshold."""
        if self.cfg.hierarchical is None:
            self._hier = n_devices > self.cfg.hierarchical_threshold
        else:
            self._hier = bool(self.cfg.hierarchical)

    # -- public -----------------------------------------------------------
    def schedule(self, graph: FlowGraph, n_devices: int,
                 total_batch: Optional[int] = None
                 ) -> Tuple[float, Schedule]:
        """Algorithm 1 entry point: collapse cycles then recurse."""
        M = total_batch or self.cfg.total_batch
        self._total = M
        self._set_hierarchical(n_devices)
        dag, members = graph.condense()
        self._members = members
        return self._find(dag, n_devices, M)

    def schedule_async(self, graph: FlowGraph, n_devices: int,
                       total_batch: Optional[int] = None,
                       iterations: int = 8,
                       depths: Optional[Sequence[int]] = None
                       ) -> Tuple[float, Schedule]:
        """Extended search over (temporal, spatial, async_depth).

        For ``K = 0`` the candidate is the plain Algorithm-1 schedule run
        ``iterations`` times back-to-back.  For ``K >= 1`` every s-t cut
        and device split becomes an :class:`Async` candidate: the producer
        side keeps generating under stale parameters while the consumer
        side trains, gated so staleness never exceeds K.  Candidates are
        SELECTED by ``async_makespan * (1 + staleness_penalty * K)`` — the
        freshness tax makes ever-larger K unattractive once the bottleneck
        stage is saturated — but the RETURNED time is always the untaxed
        horizon makespan, directly comparable to ``schedule()`` times and
        to the event simulator's replay.  The schedule is an
        :class:`Async` node when some K >= 1 wins, otherwise the plain
        Algorithm-1 schedule (run ``iterations`` times back-to-back).
        """
        if iterations < 1:
            raise ValueError(f"iterations must be >= 1, got {iterations}")
        M = total_batch or self.cfg.total_batch
        depths = tuple(depths if depths is not None
                       else self.cfg.async_depths)
        self._total = M
        self._set_hierarchical(n_devices)
        dag, members = graph.condense()
        self._members = members

        # K = 0 baseline: the unconstrained Algorithm-1 plan, repeated.
        t_sync, s_sync = self._find(dag, n_devices, M)
        best_obj: float = t_sync * iterations  # selection objective
        best_t: float = t_sync * iterations    # untaxed makespan
        best_s: Schedule = s_sync
        for K in depths:
            if K < 1:
                continue
            for s_set, t_set in dag.st_cuts():
                gs, gt = dag.subgraph(s_set), dag.subgraph(t_set)
                for n_s in self._device_splits(n_devices, gs, gt, M):
                    n_t = n_devices - n_s
                    if not self._fits(s_set, n_s, M) or \
                       not self._fits(t_set, n_t, M):
                        continue
                    ts, ss = self._find(gs, n_s, M)
                    tt, st = self._find(gt, n_t, M)
                    span = async_makespan(ts, tt, K, iterations)
                    cand = span * (1.0 + self.cfg.staleness_penalty * K)
                    if cand < best_obj:
                        best_obj = cand
                        best_t = span
                        best_s = Async(ss, st, K, iterations, n_s, n_t)
        return best_t, best_s

    # -- Algorithm 1: FindSchedule -----------------------------------------
    def _find(self, g: FlowGraph, n: int, batch: int
              ) -> Tuple[float, Schedule]:
        key = (g.key(), n, batch, self._hier)
        if key in self._memo:
            return self._memo[key]

        nodes = g.nodes
        if len(nodes) == 1:
            out = self._leaf(nodes[0], n, batch)
            self._memo[key] = out
            return out

        cuts = self._cuts.get(key[0])
        if cuts is None:
            cuts = [(s_set, t_set, g.subgraph(s_set), g.subgraph(t_set))
                    for s_set, t_set in g.st_cuts()]
            self._cuts[key[0]] = cuts

        best_t, best_s = math.inf, None
        for s_set, t_set, gs, gt in cuts:
            self.evaluated_cuts += 1

            # --- temporal: same devices, sequential, context switch ---
            ts, ss = self._find(gs, n, batch)
            tt, st = self._find(gt, n, batch)
            switch = self._switch_cost(gs, gt)
            cand = ts + tt + switch
            if cand < best_t:
                best_t, best_s = cand, Temporal(ss, st, switch)

            # --- spatial: disjoint devices, pipelined ---
            for n_s in self._device_splits(n, gs, gt, batch):
                n_t = n - n_s
                for m in self._granularities(batch):
                    ts_m, ss_m = self._find(gs, n_s, m)
                    tt_m, st_m = self._find(gt, n_t, m)
                    if not self._fits(s_set, n_s, m) or \
                       not self._fits(t_set, n_t, m):
                        continue
                    chunks = batch // m
                    t_crit = ts_m + tt_m  # warmup + cooldown
                    t_bot = max(ts_m, tt_m)
                    cand = t_crit + (chunks - 1) * t_bot
                    if cand < best_t:
                        best_t = cand
                        best_s = Pipelined(ss_m, st_m, m, n_s, n_t)

        self._memo[key] = (best_t, best_s)
        return best_t, best_s

    # -- leaves -------------------------------------------------------------
    def _leaf(self, node: str, n: int, batch: int) -> Tuple[float, Schedule]:
        members = getattr(self, "_members", {}).get(node, (node,))
        frac = batch / max(getattr(self, "_total", batch), 1)
        if len(members) == 1:
            prof = self.profiles[node]
            return prof.time(batch, n, frac), Leaf(node, n, batch)
        # Collapsed cycle (paper §3.4): two realizations are costed and the
        # cheaper chosen (unless cfg.cycle_mode forces one) —
        #  (a) shared devices, members alternate (collocated cycle):
        #      costs add, each member sees all n devices;
        #  (b) disjoint devices, members pipeline against each other
        #      (the paper's hybrid mode for sim<->generation): the cycle
        #      iterates, so throughput is set by the slowest member on its
        #      own device share; cost ~= max_i t_i + warmup of the others.
        # The winning realization (and its device split) is RECORDED on
        # the Leaf so the simulator and the executor run exactly what was
        # costed.
        t_shared = sum(self.profiles[m].time(batch, n, frac)
                       for m in members)
        C = self.cfg.cycle_chunks
        t_hybrid, hybrid_split = math.inf, None
        if len(members) >= 2 and n >= len(members):
            for split in self._member_splits(members, n):
                cand = cycle_hybrid_time(self.profiles, members, split,
                                         batch, frac, C)
                if cand < t_hybrid:
                    t_hybrid, hybrid_split = cand, tuple(split)
        forced = self.cfg.cycle_mode
        if hybrid_split is not None and (
                forced == "hybrid" or (forced is None and t_hybrid < t_shared)):
            return t_hybrid, Leaf(node, n, batch, cycle_mode="hybrid",
                                  member_devices=hybrid_split,
                                  cycle_chunks=C)
        return t_shared, Leaf(node, n, batch, cycle_mode="collocated")

    def _member_splits(self, members, n: int):
        """Small search over device partitions among cycle members."""
        k = len(members)
        if k == 2:
            caps = [self.profiles[m].max_useful_devices for m in members]
            for a in {max(n // 4, 1), max(n // 2, 1), min(caps[0], n - 1),
                      max(n - caps[1], 1)}:
                if 1 <= a < n:
                    yield (a, n - a)
        else:
            even = max(n // k, 1)
            yield tuple(even for _ in members)

    def _switch_cost(self, gs: FlowGraph, gt: FlowGraph) -> float:
        """Only the workers at the boundary actually swap at the cut: the
        sinks of G_s offload, the sources of G_t onload — interior nodes'
        switches are charged by the nested recursion.  A source that
        receives trainer weights also pays its measured weight-sync cost
        (``CostModel.sync_time``) when it comes online."""
        sinks = [n for n in gs.nodes if not list(gs.g.successors(n))]
        sources = [n for n in gt.nodes if not list(gt.g.predecessors(n))]
        off = sum(self.profiles[w].offload_time
                  for n_ in sinks for w in self._members.get(n_, (n_,)))
        on = sum(self.profiles[w].onload_time + self.profiles[w].sync_time
                 for n_ in sources for w in self._members.get(n_, (n_,)))
        return off + on

    def _device_splits(self, n: int, gs: Optional[FlowGraph] = None,
                       gt: Optional[FlowGraph] = None,
                       batch: Optional[int] = None) -> List[int]:
        if self._hier and n > self.cfg.host_group_size:
            return self._coarse_splits(n, gs, gt, batch)
        q = self.cfg.device_quantum
        return [k for k in range(q, n, q)]

    def _coarse_splits(self, n: int, gs: Optional[FlowGraph],
                       gt: Optional[FlowGraph],
                       batch: Optional[int]) -> List[int]:
        """Inter-group split candidates for hierarchical planning.

        Devices are partitioned in whole host groups at an adaptive
        quantum q (the group size G doubled until at most ~8 group-sized
        candidates remain), and only a handful of splits are tried: the
        work-proportional point between the two sides (near-optimal for
        a pipeline), its two grid neighbours, the even split, and the
        two extremes.  All candidates lie on a closed nested grid of
        group multiples, so the memoized recursion reaches O(log n)
        levels of a few device counts each instead of O(n) — that is
        what keeps `schedule()` sub-second at 256-1024 devices.  Once a
        subproblem's pool drops to <= one host group, `_device_splits`
        falls back to the exact enumeration (intra-group planning at
        `device_quantum`)."""
        q = max(self.cfg.host_group_size, self.cfg.device_quantum, 1)
        while n > 8 * q:
            q *= 2
        cands = {q, n - q, (n // (2 * q)) * q}
        if gs is not None and gt is not None:
            b = batch if batch is not None else self.cfg.total_batch
            ws = self._graph_work(gs, b)
            wt = self._graph_work(gt, b)
            prop = int(round(n * ws / max(ws + wt, 1e-12) / q)) * q
            cands.update((prop - q, prop, prop + q))
        return sorted(c for c in cands if 0 < c < n)

    def _graph_work(self, g: FlowGraph, batch: int) -> float:
        """Single-device total work of a subgraph — the proportionality
        weight the coarse split candidates are centred on."""
        key = (g.key(), batch)
        if key not in self._work:
            frac = batch / max(getattr(self, "_total", batch), 1)
            self._work[key] = sum(
                self.profiles[w].time(batch, 1, frac)
                for node in g.nodes
                for w in getattr(self, "_members", {}).get(node, (node,)))
        return self._work[key]

    def _granularities(self, batch: int) -> List[int]:
        out = []
        for d in self.cfg.granularity_divisors:
            if batch % d == 0 and batch // d >= 1 \
                    and (batch // d) % self.cfg.chunk_multiple == 0:
                out.append(batch // d)
        return sorted(set(out))

    def _fits(self, node_set, n: int, batch: int) -> bool:
        if not self.cfg.device_memory:
            return True
        for node in node_set:
            for w in self._members.get(node, (node,)):
                if self.profiles[w].memory(batch) / max(n, 1) > \
                        self.cfg.device_memory:
                    return False
        return True


# ---------------------------------------------------------------------------
# Fixed-mode baselines (veRL-style collocated / AReaL-style disaggregated)
# ---------------------------------------------------------------------------
def collocated_schedule(graph: FlowGraph, profiles, n: int, batch: int
                        ) -> Tuple[float, Schedule]:
    """All workers share all devices, executed phase-by-phase."""
    dag, members = graph.condense()
    order = list(topological_sort(dag.g))

    def build(i: int) -> Tuple[float, Schedule]:
        node = order[i]
        ms = members.get(node, (node,))
        t = sum(profiles[m].time(batch, max(n // len(ms), 1), 1.0)
                for m in ms)
        leaf = Leaf(node, n, batch,
                    cycle_mode="collocated" if len(ms) > 1 else None)
        if i == len(order) - 1:
            return t, leaf
        t_rest, rest = build(i + 1)
        switch = (sum(profiles[m].offload_time for m in ms)
                  + sum(profiles[mm].onload_time + profiles[mm].sync_time
                        for mm in members.get(order[i + 1], (order[i + 1],))))
        return t + t_rest + switch, Temporal(leaf, rest, switch)

    return build(0)


def disaggregated_schedule(graph: FlowGraph, profiles, n: int, batch: int,
                           granularity: Optional[int] = None
                           ) -> Tuple[float, Schedule]:
    """Fully spatial (AReaL-style): every component gets a proportional
    device slice and the whole workflow pipelines at one granularity.
    Like the real baseline, the pipeline granularity is tuned (best of a
    small sweep) — the *mode* is fixed, not the knob."""
    if granularity is None:
        best = None
        for div in (2, 4, 8, 16, 32):
            if batch % div:
                continue
            cand = disaggregated_schedule(graph, profiles, n, batch,
                                          granularity=batch // div)
            if best is None or cand[0] < best[0]:
                best = cand
        if best is None:
            # batch divisible by none of the candidate divisors (e.g. a
            # prime batch like 7): degenerate to one full-batch chunk
            # instead of returning None (which TypeErrors on unpack)
            best = disaggregated_schedule(graph, profiles, n, batch,
                                          granularity=batch)
        return best
    dag, members = graph.condense()
    order = list(topological_sort(dag.g))
    m = granularity

    # device shares proportional to work
    works = []
    for node in order:
        ms = members.get(node, (node,))
        works.append(sum(profiles[w].time(batch, 1) for w in ms))
    total_work = sum(works)
    shares = [max(int(round(w / total_work * n)), 1) for w in works]
    # fix rounding to sum exactly n
    while sum(shares) > n:
        shares[shares.index(max(shares))] -= 1
    while sum(shares) < n:
        shares[shares.index(min(shares))] += 1

    stage_ts = []
    for node, share in zip(order, shares):
        ms = members.get(node, (node,))
        stage_ts.append(sum(
            profiles[w].time(m, max(share // len(ms), 1), m / batch)
            for w in ms))

    def build(i: int) -> Schedule:
        ms_i = members.get(order[i], (order[i],))
        leaf = Leaf(order[i], shares[i], m,
                    cycle_mode="collocated" if len(ms_i) > 1 else None)
        if i == len(order) - 1:
            return leaf
        return Pipelined(leaf, build(i + 1), m, shares[i],
                         sum(shares[i + 1:]))

    t_crit = sum(stage_ts)
    t_bot = max(stage_ts)
    total = t_crit + (batch // m - 1) * t_bot
    return total, build(0)
