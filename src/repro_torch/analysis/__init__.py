"""flowlint — static analysis for M2Flow transformation artifacts.

The M2Flow premise moves correctness out of worker code and into the
transformation artifacts: the workflow graph, the execution plan, the
channel topology the plan implies, and the kernel invocations the
workers will issue.  flowlint checks those artifacts *before* anything
runs:

  * Pass 1 (``plan_checks``)  — graph/plan invariants (P1xx/P2xx);
  * Pass 2 (``concurrency``)  — deadlock/livelock analysis over the
    channel topology (C1xx);
  * Pass 3 (``kernel_checks``) — in the JAX package, Pallas kernel
    shape/index-map lint at the config-zoo shapes plus RNG-determinism
    (K1xx/R1xx).

Counterpart of the JAX package's ``analysis`` with passes 1 and 2.  Pass
3's port is a check of the CUDA wrappers' grids, not of Pallas
BlockSpecs, and is not written yet (ROADMAP.md queue 1, item 11b):
``analyze(kernels=True)`` raises.

Entry points: :func:`analyze` (library), ``Controller(strict=True)``
(reject bad plans before execution), and :class:`LockOrderRecorder`
(runtime validation of Pass 2's model).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.concurrency import (
    ChannelDecl,
    ChannelTopology,
    LockOrderRecorder,
    PortDecl,
    build_topology,
    check_topology,
)
from repro_torch.analysis.findings import (
    Finding,
    FlowLintError,
    SEVERITIES,
    filter_findings,
    format_findings,
    max_severity,
    severity_rank,
)
from repro_torch.analysis.plan_checks import (
    check_cost_models,
    check_graph,
    check_plan,
)

__all__ = [
    "ChannelDecl", "ChannelTopology", "Finding", "FlowLintError",
    "KERNEL_PASS_UNPORTED", "LockOrderRecorder", "PortDecl", "SEVERITIES",
    "analyze", "analyze_target", "build_topology", "check_cost_models",
    "check_graph", "check_plan", "check_topology", "filter_findings",
    "format_findings", "max_severity", "severity_rank",
]

KERNEL_PASS_UNPORTED = (
    "flowlint pass 3 (kernel_checks: the kernels' launch-shape lint and "
    "check_rng) is not ported yet (ROADMAP.md queue 1, item 11b)")


def analyze(graph: Optional[Any] = None, plan: Optional[Any] = None,
            cost_model: Optional[Dict[str, Any]] = None, *,
            cluster: Optional[Any] = None, cfg: Optional[Any] = None,
            cycle_specs: Optional[Dict[str, Any]] = None,
            sync_edges: Sequence[Tuple[str, str]] = (),
            kernels: bool = False,
            min_severity: str = "info") -> List[Finding]:
    """Run every applicable flowlint pass over the given artifacts.

    Pass whatever exists: a graph alone gets Pass 1's graph checks; a
    plan adds the plan invariants and Pass 2's concurrency analysis (the
    channel topology is derived from the plan).  ``kernels=True`` (Pass
    3) raises: see :data:`KERNEL_PASS_UNPORTED`.
    """
    if kernels:
        raise NotImplementedError(KERNEL_PASS_UNPORTED)
    findings: List[Finding] = []
    if graph is not None:
        findings.extend(check_graph(graph, cycle_specs))
        if cost_model is not None:
            findings.extend(check_cost_models(graph, cost_model))
    if plan is not None:
        findings.extend(check_plan(plan, graph=graph, cluster=cluster,
                                   cfg=cfg, cycle_specs=cycle_specs,
                                   sync_edges=sync_edges))
        topo = build_topology(graph, plan, cycle_specs)
        findings.extend(check_topology(topo))
    return filter_findings(findings, min_severity)


def analyze_target(target: Any, *, kernels: bool = False,
                   min_severity: str = "info") -> List[Finding]:
    """Transform a :class:`repro_torch.analysis.targets.LintTarget` (run the
    planner) and analyze graph + plan together."""
    from repro_torch.analysis.targets import plan_for
    plan = plan_for(target)
    return analyze(target.graph, plan, target.cost_models,
                   cluster=target.cluster, cfg=target.scheduler_cfg,
                   cycle_specs=target.cycle_specs,
                   sync_edges=target.sync_edges, kernels=kernels,
                   min_severity=min_severity)
