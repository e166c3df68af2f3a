"""Lint targets: the repo's workflow families and example graphs.

A :class:`LintTarget` bundles everything :func:`repro_torch.analysis.analyze`
needs for one workflow — the graph, its CycleSpecs, synthetic cost
models (so planning is instant; no model is built), a scheduler config
and a cluster.  :func:`all_targets` lists them; the acceptance bar is
zero findings on every one.

A copy of the JAX package's ``analysis/targets.py`` over the port's
runtime.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.controller import Controller, ExecutionPlan
from repro_torch.core.flowgraph import FlowGraph
from repro_torch.core.placement import Cluster
from repro_torch.core.profiler import CostModel
from repro_torch.core.scheduler import SchedulerConfig


@dataclass
class LintTarget:
    name: str
    graph: FlowGraph
    cycle_specs: Dict[str, Any] = field(default_factory=dict)
    cost_models: Dict[str, CostModel] = field(default_factory=dict)
    scheduler_cfg: SchedulerConfig = field(default_factory=SchedulerConfig)
    cluster: Cluster = field(default_factory=lambda: Cluster(
        num_nodes=1, devices_per_node=8))
    total_batch: int = 64
    # (src, dst) weight-sync edges (trainer -> generation workers)
    sync_edges: Tuple[Tuple[str, str], ...] = ()
    mode: str = "auto"
    # > 0: plan with the async off-policy dimension over this horizon
    async_iterations: int = 0


def _chain_cost_models(names) -> Dict[str, CostModel]:
    out: Dict[str, CostModel] = {}
    for i, n in enumerate(names):
        out[n] = CostModel(n, base_time=0.05 + 0.02 * i, slope_time=1e-3,
                           onload_time=0.2, offload_time=0.2)
    return out


def plan_for(target: LintTarget) -> ExecutionPlan:
    """Run the M2Flow transformation for a target (the artifact Pass 1/2
    actually lint)."""
    ctl = Controller(target.cluster, profiles=target.cost_models,
                     scheduler_cfg=target.scheduler_cfg)
    if target.async_iterations > 0:
        return ctl.plan_async(target.graph,
                              total_batch=target.total_batch,
                              iterations=target.async_iterations)
    return ctl.plan(target.graph, total_batch=target.total_batch,
                    mode=target.mode)


# ---------------------------------------------------------------------------
# Workflow-family targets (the three RL families the repo ships)
# ---------------------------------------------------------------------------
def grpo_target(mode: str = "auto") -> LintTarget:
    from repro_torch.rl.grpo_workflow import WORKFLOW_ORDER, grpo_graph
    group = 8
    return LintTarget(
        name=f"grpo[{mode}]",
        graph=grpo_graph(),
        cost_models=_chain_cost_models(WORKFLOW_ORDER),
        scheduler_cfg=SchedulerConfig(
            total_batch=64, granularity_divisors=(1, 2, 4),
            device_quantum=2, chunk_multiple=group),
        total_batch=64,
        sync_edges=(("actor", "rollout"), ("actor", "inference")),
        mode=mode)


def async_grpo_target() -> LintTarget:
    t = grpo_target()
    t.name = "grpo[async]"
    t.async_iterations = 8
    return t


def rlhf_target(mode: str = "auto") -> LintTarget:
    from repro_torch.rl.rlhf_workflow import rlhf_graph
    names = ("rollout", "inference", "reference", "critic_v", "reward",
             "actor")
    return LintTarget(
        name=f"rlhf[{mode}]",
        graph=rlhf_graph(),
        cost_models=_chain_cost_models(names),
        scheduler_cfg=SchedulerConfig(
            total_batch=32, granularity_divisors=(1, 2, 4),
            device_quantum=2, chunk_multiple=32),
        total_batch=32,
        sync_edges=(("actor", "rollout"), ("actor", "inference")),
        mode=mode)


def embodied_target(cycle_mode: Optional[str] = None) -> LintTarget:
    from repro_torch.rl.embodied_workflow import (
        embodied_cycle_specs,
        embodied_graph,
    )
    num_envs = 16
    cms = _chain_cost_models(
        ("simulator", "policy_gen", "advantage", "train"))
    return LintTarget(
        name=f"embodied[{cycle_mode or 'auto'}]",
        graph=embodied_graph(),
        cycle_specs=embodied_cycle_specs(horizon=8, chunks=2),
        cost_models=cms,
        scheduler_cfg=SchedulerConfig(
            total_batch=num_envs, granularity_divisors=(1,),
            chunk_multiple=num_envs, device_quantum=2,
            cycle_mode=cycle_mode, cycle_chunks=2),
        total_batch=num_envs,
        sync_edges=(("train", "policy_gen"),))


def workflow_targets() -> List[LintTarget]:
    return [
        grpo_target(),
        grpo_target("collocated"),
        grpo_target("disaggregated"),
        async_grpo_target(),
        rlhf_target(),
        embodied_target(),
        embodied_target("collocated"),
        embodied_target("hybrid"),
    ]


# ---------------------------------------------------------------------------
# Example targets (every examples/*.py that builds a flow graph)
# ---------------------------------------------------------------------------
def deep_research_target() -> LintTarget:
    """The graph ``examples/deep_research.py`` plans (its policy <-> tool
    loop, reward and train), with its CycleSpec and cost models.  The
    example imports the JAX package, so the port builds the same
    artifacts from its own types instead of loading it."""
    from repro_torch.core.flowgraph import cycle_node_name
    from repro_torch.core.pipeline import CycleSpec

    g = FlowGraph()
    for w in ("policy_gen", "search_tool", "reward", "train"):
        g.add_worker(w)
    g.add_edge("policy_gen", "search_tool")
    g.add_edge("search_tool", "policy_gen")  # the tool loop
    g.add_edge("policy_gen", "reward")
    g.add_edge("reward", "train")
    name = cycle_node_name(("policy_gen", "search_tool"))
    return LintTarget(
        name="example:deep_research",
        graph=g,
        cycle_specs={name: CycleSpec(order=("policy_gen", "search_tool"),
                                     steps=2, chunks=2)},
        cost_models={
            "policy_gen": CostModel("policy_gen", base_time=0.05,
                                    slope_time=2e-3, onload_time=0.2,
                                    offload_time=0.2),
            "search_tool": CostModel("search_tool", base_time=0.08,
                                     slope_time=1e-4, scalable=False,
                                     max_useful_devices=2),
            "reward": CostModel("reward", base_time=0.01, slope_time=1e-5),
            "train": CostModel("train", base_time=0.1, slope_time=1e-3,
                               onload_time=0.4, offload_time=0.3),
        },
        scheduler_cfg=SchedulerConfig(
            total_batch=64, granularity_divisors=(1, 2, 4),
            device_quantum=2),
        total_batch=64,
        sync_edges=(("train", "policy_gen"),))


def example_targets() -> List[LintTarget]:
    """Graphs the examples plan: quickstart / reasoning_grpo run the
    GRPO chain, async_grpo plans it with the async dimension,
    embodied_ppo runs the embodied cycle, deep_research builds its own
    policy↔tool loop (serve_batch has no flow graph)."""
    q = grpo_target()
    q.name = "example:quickstart"
    a = async_grpo_target()
    a.name = "example:async_grpo"
    e = embodied_target()
    e.name = "example:embodied_ppo"
    return [q, a, e, deep_research_target()]


def all_targets() -> List[LintTarget]:
    return workflow_targets() + example_targets()
