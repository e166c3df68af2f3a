"""The port's control plane against the JAX package's: the flowgraph
(``networkx`` there, the standard library here), the scheduler, the
controller's plans and placement, and the event simulator, on the GRPO
chain, the RLHF diamond, the embodied cycle and random graphs made from a
numpy seed.  Orders are compared exactly: the order of nodes decides the
plan (cuts are enumerated over the topological order and the scheduler
keeps the first of equal candidates), and times are equal floats."""
import dataclasses

import numpy as np
import pytest

from repro.core import Cluster as JCluster
from repro.core import Controller as JController
from repro.core import FlowGraph as JFlowGraph
from repro.core import Simulator as JSimulator
from repro.core.profiler import CostModel as JCostModel
from repro.core.profiler import paper_like_profiles
from repro.core.scheduler import Scheduler as JScheduler
from repro.core.scheduler import SchedulerConfig as JSchedulerConfig
from repro.rl.embodied_workflow import embodied_graph
from repro.rl.grpo_workflow import grpo_graph as jax_grpo_graph
from repro.rl.rlhf_workflow import rlhf_graph
from repro_torch.core import Cluster, Controller, FlowGraph, Simulator
from repro_torch.core.flowgraph import (
    DiGraph,
    GraphCycleError,
    ancestors,
    condensation,
    strongly_connected_components,
    topological_sort,
)
from repro_torch.core.profiler import CostModel
from repro_torch.core.scheduler import Scheduler, SchedulerConfig
from repro_torch.rl.grpo_workflow import grpo_graph


def _port_graph(jg: JFlowGraph) -> FlowGraph:
    """The same graph built in the port: nodes, then edges, each in the
    JAX graph's insertion order (so every adjacency list has its order)."""
    g = FlowGraph()
    for n in jg.nodes:
        g.add_worker(n)
    for u, v in jg.edges():
        g.add_edge(u, v, channel=jg.g.edges[u, v]["channel"],
                   nbytes=jg.g.edges[u, v]["nbytes"])
    return g


def _random_graph(seed: int, cyclic: bool):
    """(jax graph, port graph) over 2-8 workers named in a shuffled
    order, some edges added before their nodes; DAG edges go forward in
    a hidden order, cyclic ones anywhere."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9))
    names = [f"w{int(i)}" for i in rng.permutation(n)]
    ops = [("node", nm) for nm in names if rng.random() < 0.7]
    for _ in range(int(rng.integers(1, 2 * n + 1))):
        a, b = (int(x) for x in rng.integers(0, n, 2))
        if a == b:
            continue
        if not cyclic and a > b:
            a, b = b, a
        ops.append(("edge", names[a], names[b]))
    graphs = []
    for cls in (JFlowGraph, FlowGraph):
        g = cls()
        for op in ops:
            if op[0] == "node":
                g.add_worker(op[1])
            else:
                g.add_edge(op[1], op[2], channel=f"{op[1]}->{op[2]}")
        graphs.append(g)
    return graphs


NAMED = {"grpo": jax_grpo_graph, "rlhf": rlhf_graph,
         "embodied": embodied_graph}
RANDOM_DAGS = list(range(24))
RANDOM_CYCLIC = list(range(100, 112))


def _pairs():
    out = [pytest.param(NAMED[k](), None, id=k) for k in NAMED]
    out += [pytest.param(*_random_graph(s, False), id=f"dag{s}")
            for s in RANDOM_DAGS]
    out += [pytest.param(*_random_graph(s, True), id=f"cyclic{s}")
            for s in RANDOM_CYCLIC]
    return out


def _both(jg, tg=None):
    return jg, (tg if tg is not None else _port_graph(jg))


def test_port_grpo_graph_is_jaxs():
    jg, tg = jax_grpo_graph(), grpo_graph()
    assert tg.nodes == jg.nodes and tg.edges() == jg.edges()
    assert [tg.g.edge_data(u, v)["channel"] for u, v in tg.edges()] == \
        [jg.g.edges[u, v]["channel"] for u, v in jg.edges()]


@pytest.mark.parametrize("jg,tg", _pairs())
def test_condense_and_cuts_match_jax_in_order(jg, tg):
    jg, tg = _both(jg, tg)
    assert tg.nodes == jg.nodes and tg.edges() == jg.edges()
    jd, jm = jg.condense()
    td, tm = tg.condense()
    assert td.nodes == jd.nodes and td.edges() == jd.edges()
    assert list(tm.items()) == list(jm.items())
    import networkx as nx
    assert list(topological_sort(td.g)) == list(nx.topological_sort(jd.g))
    jcuts, tcuts = list(jd.st_cuts()), list(td.st_cuts())
    assert tcuts == jcuts
    for s, t in jcuts:
        for part in (s, t):
            a, b = jd.subgraph(part), td.subgraph(part)
            assert b.nodes == a.nodes and b.edges() == a.edges()


@pytest.mark.parametrize("seed", RANDOM_CYCLIC[:6])
def test_strongly_connected_components_in_networkx_order(seed):
    import networkx as nx
    jg, tg = _random_graph(seed, True)
    want = [sorted(c) for c in nx.strongly_connected_components(jg.g)]
    assert [sorted(c) for c in strongly_connected_components(tg.g)] == want
    dag, members = condensation(tg.g)
    jc = nx.condensation(jg.g)
    assert dag.nodes == list(jc.nodes) and dag.edges == list(jc.edges)
    assert [sorted(members[i]) for i in dag.nodes] == \
        [sorted(jc.nodes[i]["members"]) for i in jc.nodes]


def test_ancestors_and_cycle_error():
    g = DiGraph()
    for u, v in (("a", "b"), ("b", "c"), ("x", "c"), ("c", "d")):
        g.add_edge(u, v)
    assert ancestors(g, "d") == {"a", "b", "c", "x"}
    assert ancestors(g, "a") == set()
    g.add_edge("d", "a")
    with pytest.raises(GraphCycleError):
        list(topological_sort(g))


# ---------------------------------------------------------------------------
# scheduler, controller and simulator
# ---------------------------------------------------------------------------
ROLE = {"rollout": "rollout", "policy_gen": "rollout",
        "inference": "inference", "reference": "inference",
        "critic_v": "inference", "reward": "reward", "advantage": "reward",
        "actor": "training", "train": "training", "simulator": "simulator"}


def _profiles(nodes):
    """Paper-like cost models for ``nodes`` in both packages (the same
    numbers, separate objects); unnamed workers take them in turn."""
    base = paper_like_profiles(gen_tail=8.0)
    kinds = sorted(base)
    jp, tp = {}, {}
    for i, n in enumerate(nodes):
        src = base[ROLE.get(n, kinds[i % len(kinds)])]
        fields = {f.name: getattr(src, f.name)
                  for f in dataclasses.fields(src)}
        fields["name"] = n
        jp[n], tp[n] = JCostModel(**fields), CostModel(**fields)
    return jp, tp


def _sched_cfg(cls, M):
    return cls(total_batch=M, granularity_divisors=(1, 2, 4),
               device_quantum=2, chunk_multiple=4)


PLAN_GRAPHS = [pytest.param(NAMED[k](), None, id=k) for k in NAMED] + [
    pytest.param(*_random_graph(s, False), id=f"dag{s}")
    for s in RANDOM_DAGS[:10]] + [
    pytest.param(*_random_graph(s, True), id=f"cyclic{s}")
    for s in RANDOM_CYCLIC[:4]]


@pytest.mark.parametrize("jg,tg", PLAN_GRAPHS)
@pytest.mark.parametrize("mode", ["collocated", "disaggregated", "auto"])
def test_controller_plans_match_jax(jg, tg, mode):
    jg, tg = _both(jg, tg)
    jp, tp = _profiles(jg.nodes)
    for M in (8, 16, 32):
        jc = JController(JCluster(num_nodes=1, devices_per_node=8),
                         profiles=jp,
                         scheduler_cfg=_sched_cfg(JSchedulerConfig, M))
        tc = Controller(Cluster(num_nodes=1, devices_per_node=8),
                        profiles=tp,
                        scheduler_cfg=_sched_cfg(SchedulerConfig, M))
        want = jc.plan(jg, total_batch=M, mode=mode)
        got = tc.plan(tg, total_batch=M, mode=mode)
        assert repr(got.schedule) == repr(want.schedule), (M, mode)
        assert got.est_time == want.est_time
        assert list(got.placement.items()) == list(want.placement.items())
        assert got.members == want.members
        assert got.pretty() == want.pretty()
        jr = JSimulator(jp, want.members).run(want.schedule, M)
        tr = Simulator(tp, got.members).run(got.schedule, M)
        assert tr.makespan == jr.makespan
        assert repr(tr.spans) == repr(jr.spans)


@pytest.mark.parametrize("jg,tg", PLAN_GRAPHS[:3] + PLAN_GRAPHS[3:7])
def test_plan_async_and_simulator_match_jax(jg, tg):
    jg, tg = _both(jg, tg)
    jp, tp = _profiles(jg.nodes)
    for M, iters, depths in ((16, 4, [1]), (32, 6, [1, 2])):
        jc = JController(JCluster(num_nodes=1, devices_per_node=8),
                         profiles=jp,
                         scheduler_cfg=_sched_cfg(JSchedulerConfig, M))
        tc = Controller(Cluster(num_nodes=1, devices_per_node=8),
                        profiles=tp,
                        scheduler_cfg=_sched_cfg(SchedulerConfig, M))
        want = jc.plan_async(jg, total_batch=M, iterations=iters,
                             depths=depths)
        got = tc.plan_async(tg, total_batch=M, iterations=iters,
                            depths=depths)
        assert (got.mode, repr(got.schedule), got.est_time) == \
            (want.mode, repr(want.schedule), want.est_time)
        assert list(got.placement.items()) == list(want.placement.items())
        jr = JSimulator(jp, want.members).run_iterations(
            want.schedule, M, iters)
        tr = Simulator(tp, got.members).run_iterations(
            got.schedule, M, iters)
        assert tr.makespan == jr.makespan
        assert repr(tr.spans) == repr(jr.spans)


@pytest.mark.parametrize("n_devices,M", [(8, 32), (64, 256)])
def test_scheduler_search_matches_jax_on_paper_profiles(n_devices, M):
    """The bare Scheduler at the paper-like profiles' own names (the
    rollout -> inference -> training chain of the JAX async tests),
    sync and async, with the number of cuts it evaluated."""
    jg = JFlowGraph()
    for w in ("rollout", "inference", "training"):
        jg.add_worker(w)
    jg.add_edge("rollout", "inference")
    jg.add_edge("inference", "training")
    tg = _port_graph(jg)
    jp, tp = _profiles(jg.nodes)
    js = JScheduler(jp, JSchedulerConfig(total_batch=M, device_quantum=8))
    ts = Scheduler(tp, SchedulerConfig(total_batch=M, device_quantum=8))
    want, got = js.schedule(jg, n_devices, M), ts.schedule(tg, n_devices, M)
    assert (got[0], repr(got[1])) == (want[0], repr(want[1]))
    want = js.schedule_async(jg, n_devices, M, iterations=8)
    got = ts.schedule_async(tg, n_devices, M, iterations=8)
    assert (got[0], repr(got[1])) == (want[0], repr(want[1]))
    assert ts.evaluated_cuts == js.evaluated_cuts
