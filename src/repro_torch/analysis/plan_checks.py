"""flowlint Pass 1 — graph and execution-plan invariants.

Checks the *transformation artifacts* (the workflow graph and the
ExecutionPlan the Scheduler/Controller produced) instead of any worker's
code — the M2Flow premise is that correctness lives in these artifacts:

  * graph hygiene: cycles outside declared CycleSpecs, orphan nodes,
    disconnected components;
  * placement hygiene: every worker placed, no unknown workers, no dead
    or out-of-range devices;
  * schedule-tree invariants: Pipelined/Async sides on disjoint devices,
    chunk granularities aligned with ``chunk_multiple`` (the
    silent-zero-advantage bug class), non-empty device splits;
  * collapsed-cycle round-trips: every cycle leaf has a members entry
    (or its members silently escape the Temporal offload/onload
    discipline) and hybrid member_devices match the member tuple;
  * weight-sync edges: both endpoints exist and own a non-empty device
    slice, or the resharding data plane has no mesh to land on.

All checks are pure functions of the artifacts; nothing executes.

A copy of the JAX package's ``analysis/plan_checks.py`` over the port's
graph (``core.flowgraph``, no networkx): its component functions yield
networkx's order, so the findings come out in JAX's order with JAX's
codes.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.core.flowgraph import (
    FlowGraph,
    cycle_node_name,
    strongly_connected_components,
    weakly_connected_components,
)
from repro_torch.core.scheduler import Async, Leaf, Pipelined, Temporal, leaves

PASS = "plan"


def _f(code: str, severity: str, subject: str, message: str,
       hint: str = "") -> Finding:
    return Finding(code, severity, subject, message, hint, PASS)


# ---------------------------------------------------------------------------
# graph checks
# ---------------------------------------------------------------------------
def check_graph(graph: FlowGraph,
                cycle_specs: Optional[Dict[str, Any]] = None
                ) -> List[Finding]:
    out: List[Finding] = []
    g = graph.g
    specs = cycle_specs or {}

    # P101 — cycles outside declared CycleSpecs.  A cycle collapses into
    # one schedulable node; without a CycleSpec the executor cannot
    # realize it as a closed loop and raises at runtime — catch it here.
    for comp in strongly_connected_components(g):
        members = tuple(sorted(comp))
        is_cycle = len(members) > 1 or g.has_edge(members[0], members[0])
        if is_cycle:
            name = cycle_node_name(members)
            if name not in specs:
                out.append(_f(
                    "P101", "error", name,
                    f"cycle over {members} has no declared CycleSpec",
                    "register a CycleSpec for this collapsed node "
                    "(WorkflowRunner.cycle_specs) or break the cycle"))
            else:
                spec = specs[name]
                order = tuple(getattr(spec, "order", ()))
                if sorted(order) != list(members):
                    out.append(_f(
                        "P102", "error", name,
                        f"CycleSpec order {order} does not cover the "
                        f"cycle members {members}",
                        "the spec's order must name every member of the "
                        "strongly-connected component exactly once"))

    # P103 — orphan nodes: a worker with no data dependencies at all in
    # a multi-node graph is almost always a forgotten channel edge.
    if g.number_of_nodes() > 1:
        for n in g.nodes:
            if g.in_degree(n) == 0 and g.out_degree(n) == 0:
                out.append(_f(
                    "P103", "warning", n,
                    "node has no incoming or outgoing edges",
                    "connect it with add_edge(...) or drop it from the "
                    "graph; the scheduler will otherwise place it as an "
                    "independent stage"))

    # P104 — disconnected graph (beyond orphans): separate weakly-
    # connected components of size >= 2 mean two sub-workflows that never
    # exchange data — usually a missing edge, occasionally intentional.
    comps = [c for c in weakly_connected_components(g) if len(c) >= 2]
    if len(comps) > 1:
        out.append(_f(
            "P104", "warning",
            "+".join(sorted(min(c) for c in comps)),
            f"graph splits into {len(comps)} disconnected sub-workflows",
            "if these workflows are truly independent, lint and plan "
            "them separately"))
    return out


def check_cost_models(graph: FlowGraph,
                      cost_models: Dict[str, Any]) -> List[Finding]:
    """P105 — every graph node needs a cost model, or Algorithm 1 prices
    that stage from thin air and the plan's est_time is fiction."""
    out: List[Finding] = []
    for n in sorted(graph.nodes):
        if n not in cost_models:
            out.append(_f(
                "P105", "warning", n,
                "no cost model for this worker — the scheduler will "
                "price its stage with defaults",
                "run the profiling iteration (WorkflowRunner.profile) "
                "or register a CostModel for it"))
    return out


# ---------------------------------------------------------------------------
# plan checks
# ---------------------------------------------------------------------------
def _expand(name: str, members: Dict[str, Tuple[str, ...]]) -> Tuple[str, ...]:
    return members.get(name, (name,))


def _side_workers(sched, members: Dict[str, Tuple[str, ...]]) -> List[str]:
    out: List[str] = []
    for lf in leaves(sched):
        out.extend(_expand(lf.worker, members))
    return out


def _placed_devices(workers: Iterable[str],
                    placement: Dict[str, List[int]]) -> set:
    devs: set = set()
    for w in workers:
        devs |= set(placement.get(w, ()))
    return devs


def check_plan(plan: Any, graph: Optional[FlowGraph] = None,
               cluster: Optional[Any] = None,
               cfg: Optional[Any] = None,
               cycle_specs: Optional[Dict[str, Any]] = None,
               sync_edges: Sequence[Tuple[str, str]] = ()
               ) -> List[Finding]:
    """Pass-1 invariants of one ExecutionPlan (duck-typed: needs
    ``schedule``, ``placement`` and ``members``)."""
    out: List[Finding] = []
    sched = plan.schedule
    placement: Dict[str, List[int]] = dict(plan.placement or {})
    members: Dict[str, Tuple[str, ...]] = dict(
        getattr(plan, "members", None) or {})

    plan_workers = set(_side_workers(sched, members))

    # ---- placement membership ------------------------------------------------
    if graph is not None:
        graph_workers = set()
        for n in graph.nodes:
            graph_workers.update(_expand(n, members))
        for w in sorted(set(placement) - graph_workers):
            out.append(_f(
                "P201", "warning", w,
                "placement names a worker absent from the workflow graph",
                "stale placement entry — drop it or add the worker to "
                "the graph"))
        missing_side = graph_workers
    else:
        missing_side = plan_workers
    for w in sorted(missing_side):
        if not placement.get(w):
            out.append(_f(
                "P202", "error", w,
                "worker has no (or an empty) device slice in the "
                "placement",
                "every scheduled worker needs devices; re-run "
                "Controller.plan or fix the hand-built placement"))

    # ---- device liveness -----------------------------------------------------
    if cluster is not None:
        n_dev = cluster.num_devices
        for w, devs in sorted(placement.items()):
            for d in devs:
                if not (0 <= d < n_dev):
                    out.append(_f(
                        "P203", "error", w,
                        f"placement references device {d} outside the "
                        f"cluster (0..{n_dev - 1})",
                        "the plan was built for a different topology; "
                        "re-plan against this cluster"))
                elif not cluster.device_alive(d):
                    out.append(_f(
                        "P204", "error", w,
                        f"placement references device {d} on a failed "
                        f"host",
                        "re-plan over cluster.available_devices() "
                        "(recovery does this automatically)"))

    # ---- schedule-tree invariants -------------------------------------------
    out.extend(_check_tree(sched, placement, members, cfg))

    # ---- collapsed-cycle round-trips ----------------------------------------
    out.extend(_check_cycles(sched, placement, members, cycle_specs))

    # ---- weight-sync edges ---------------------------------------------------
    for src, dst in sync_edges:
        for end, role in ((src, "source"), (dst, "destination")):
            known = end in plan_workers or end in placement
            if not known:
                out.append(_f(
                    "P207", "error", f"{src}->{dst}",
                    f"weight-sync {role} {end!r} is not part of the plan",
                    "weight_sync_workers must name scheduled workers"))
            elif not placement.get(end):
                out.append(_f(
                    "P208", "error", f"{src}->{dst}",
                    f"weight-sync {role} {end!r} has no device slice — "
                    f"the resharding data plane has no mesh to place "
                    f"params on",
                    "give the worker a non-empty placement (its "
                    "state_shardings need a mesh)"))
    return out


def _check_tree(sched, placement, members, cfg) -> List[Finding]:
    out: List[Finding] = []
    chunk_multiple = int(getattr(cfg, "chunk_multiple", 1) or 1)

    def walk(node):
        if isinstance(node, Leaf):
            return
        if isinstance(node, (Pipelined, Async)):
            kind = type(node).__name__
            # P205 — spatial sides must sit on disjoint devices: an
            # overlap time-shares what the cost model priced as parallel
            # (the Pipelined-starvation bug class that property tests
            # caught at runtime).
            s_devs = _placed_devices(_side_workers(node.s, members),
                                     placement)
            t_devs = _placed_devices(_side_workers(node.t, members),
                                     placement)
            shared = sorted(s_devs & t_devs)
            if shared:
                out.append(_f(
                    "P205", "error", kind,
                    f"{kind} sides share device(s) {shared} — the plan "
                    f"priced them as disjoint",
                    "re-place the sides on disjoint slices (the "
                    "scheduler's n_s/n_t split) or use a Temporal cut"))
            if node.n_s <= 0 or node.n_t <= 0:
                out.append(_f(
                    "P206", "error", kind,
                    f"{kind} records an empty device split "
                    f"(n_s={node.n_s}, n_t={node.n_t})",
                    "both sides of a spatial cut need at least one "
                    "device"))
            if isinstance(node, Pipelined):
                m = node.granularity
                if m <= 0 or m % chunk_multiple:
                    out.append(_f(
                        "P209", "error", kind,
                        f"pipeline granularity {m} is not a positive "
                        f"multiple of chunk_multiple={chunk_multiple}",
                        "a chunk boundary that splits a data atom (e.g. "
                        "a GRPO group) silently zeroes group-relative "
                        "advantages; set SchedulerConfig.chunk_multiple"))
            if isinstance(node, Async) and node.depth < 0:
                out.append(_f(
                    "P210", "error", kind,
                    f"negative staleness bound K={node.depth}",
                    "async depth must be >= 0 (0 = synchronous)"))
        walk(node.s)
        walk(node.t)

    walk(sched)
    return out


def _check_cycles(sched, placement, members, cycle_specs) -> List[Finding]:
    out: List[Finding] = []
    specs = cycle_specs or {}
    for lf in leaves(sched):
        looks_cyclic = lf.cycle_mode is not None or lf.worker in members
        if not looks_cyclic:
            continue
        ms = members.get(lf.worker, ())
        if len(ms) < 2:
            # P211 — a cycle leaf with no members entry: the switcher
            # sees only the synthetic node name, so its members escape
            # the offload/onload discipline at every Temporal cut (the
            # offload/onload sets stop round-tripping).
            out.append(_f(
                "P211", "error", lf.worker,
                "cycle leaf has no members entry in plan.members — its "
                "member workers escape offload/onload at Temporal cuts",
                "record {collapsed node: member tuple} on the plan "
                "(Controller.plan does this from graph.condense())"))
            continue
        if specs and lf.worker not in specs:
            out.append(_f(
                "P212", "error", lf.worker,
                "no CycleSpec registered for this cycle leaf",
                "pass cycle_specs={node: CycleSpec(...)} to "
                "Controller.execute"))
        if lf.cycle_mode == "hybrid":
            md = lf.member_devices or ()
            if len(md) != len(ms):
                out.append(_f(
                    "P213", "error", lf.worker,
                    f"hybrid member_devices {md} does not match the "
                    f"{len(ms)} member(s) {ms}",
                    "one device share per member, ordered like the "
                    "sorted member tuple"))
            elif sum(md) > lf.devices or any(s <= 0 for s in md):
                out.append(_f(
                    "P213", "error", lf.worker,
                    f"hybrid member_devices {md} exceed the leaf's "
                    f"{lf.devices} device(s) (or contain empty shares)",
                    "member shares must be positive and sum to at most "
                    "the leaf's device count"))
            if lf.cycle_chunks < 1:
                out.append(_f(
                    "P214", "error", lf.worker,
                    f"hybrid cycle_chunks={lf.cycle_chunks} < 1",
                    "the per-step env pipeline needs at least one chunk "
                    "(2 = double-buffered)"))
    return out
