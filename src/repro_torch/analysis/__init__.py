"""flowlint — static analysis for M2Flow transformation artifacts.

The M2Flow premise moves correctness out of worker code and into the
transformation artifacts: the workflow graph, the execution plan, the
channel topology the plan implies, and the kernel invocations the
workers will issue.  flowlint checks those artifacts *before* anything
runs:

  * Pass 1 (``plan_checks``)  — graph/plan invariants (P1xx/P2xx);
  * Pass 2 (``concurrency``)  — deadlock/livelock analysis over the
    channel topology (C1xx);
  * Pass 3 (``kernel_checks``) — CUDA launch lint of the kernel
    wrappers at the config-zoo shapes plus RNG-determinism of the
    sampling noise's keys (K1xx/R1xx).

Counterpart of the JAX package's ``analysis``; its Pass 3 checks the
CUDA launches (grid, block, shared memory, cluster, tiles) where JAX's
checks Pallas BlockSpecs.

Entry points: :func:`analyze` (library), ``python -m
repro_torch.analysis`` (CLI), ``Controller(strict=True)`` (reject bad
plans before execution), and :class:`LockOrderRecorder` (runtime
validation of Pass 2's model).
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
from repro_torch.analysis.kernel_checks import (
    KernelInvocation,
    RNGKeySpec,
    check_invocation,
    check_kernels,
    check_rng,
)
from repro_torch.analysis.plan_checks import (
    check_cost_models,
    check_graph,
    check_plan,
)

__all__ = [
    "ChannelDecl", "ChannelTopology", "Finding", "FlowLintError",
    "KernelInvocation", "LockOrderRecorder", "PortDecl", "RNGKeySpec",
    "SEVERITIES", "analyze", "analyze_target", "build_topology",
    "check_cost_models", "check_graph", "check_invocation",
    "check_kernels", "check_plan", "check_rng", "check_topology",
    "filter_findings", "format_findings", "max_severity", "severity_rank",
]


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
    channel topology is derived from the plan); ``kernels=True`` adds
    Pass 3's config-zoo launch sweep and the RNG-determinism check
    (artifact-independent, so opt-in).
    """
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
    if kernels:
        findings.extend(check_kernels())
        findings.extend(check_rng())
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
