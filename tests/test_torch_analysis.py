"""The port's flowlint passes 1-2 (``repro_torch.analysis``) against the
JAX package's: every pass-1/2 case of the JAX tests runs on the same
graph or plan in both packages, and the port's findings (code, severity,
subject, message, in order) equal JAX's; the strict controller rejects
a corrupted plan before any worker is bound and accepts the clean one;
``LockOrderRecorder`` against a real ``DeviceLock``."""
import dataclasses
import threading
import time
from types import SimpleNamespace

import pytest

import repro.analysis as ja
import repro.analysis.concurrency as jconc
import repro.analysis.plan_checks as jplan
import repro.analysis.targets as jtargets
import repro.core.controller as jctl
import repro.core.flowgraph as jfg
import repro.core.pipeline as jpipe
import repro.core.placement as jplace
import repro.core.scheduler as jsched
import repro_torch.analysis as ta
import repro_torch.analysis.concurrency as tconc
import repro_torch.analysis.plan_checks as tplan
import repro_torch.analysis.targets as ttargets
import repro_torch.core.controller as tctl
import repro_torch.core.flowgraph as tfg
import repro_torch.core.pipeline as tpipe
import repro_torch.core.placement as tplace
import repro_torch.core.scheduler as tsched
from repro_torch.analysis.concurrency import LockOrderRecorder
from repro_torch.analysis.findings import (
    Finding,
    FlowLintError,
    filter_findings,
    format_findings,
)
from repro_torch.core.channel import DeviceLock, set_lock_observer
from repro_torch.core.flowgraph import DiGraph, NoCycle, find_cycle


def _pkg(an, conc, plan, targets, ctl, fg, pipe, place, sched):
    return SimpleNamespace(
        analyze=an.analyze, analyze_target=an.analyze_target,
        check_graph=plan.check_graph, check_plan=plan.check_plan,
        check_cost_models=plan.check_cost_models,
        ChannelDecl=conc.ChannelDecl, ChannelTopology=conc.ChannelTopology,
        LockSite=conc.LockSite, build_topology=conc.build_topology,
        check_topology=conc.check_topology, targets=targets,
        plan_for=targets.plan_for, Controller=ctl.Controller,
        FlowGraph=fg.FlowGraph, cycle_node_name=fg.cycle_node_name,
        CycleSpec=pipe.CycleSpec, Cluster=place.Cluster, Leaf=sched.Leaf,
        Pipelined=sched.Pipelined, Async=sched.Async)


JAX = _pkg(ja, jconc, jplan, jtargets, jctl, jfg, jpipe, jplace, jsched)
PORT = _pkg(ta, tconc, tplan, ttargets, tctl, tfg, tpipe, tplace, tsched)


def _key(findings):
    return [(f.code, f.severity, f.subject, f.message, f.hint, f.pass_name)
            for f in findings]


def _rewrite(P, node, fn):
    node = fn(node)
    if isinstance(node, P.Leaf):
        return node
    return dataclasses.replace(node, s=_rewrite(P, node.s, fn),
                               t=_rewrite(P, node.t, fn))


# ---------------------------------------------------------------------------
# the cases: each builds its artifact in package P and returns the findings
# ---------------------------------------------------------------------------
def _two_cycle(P):
    g = P.FlowGraph()
    g.add_worker("a")
    g.add_worker("b")
    g.add_edge("a", "b")
    g.add_edge("b", "a")
    return g


def _grpo_plan(P, mode="disaggregated"):
    t = P.targets.grpo_target(mode)
    return t, P.plan_for(t)


def _check(P, t, plan, **kw):
    kw.setdefault("graph", t.graph)
    return P.check_plan(plan, cluster=t.cluster, cfg=t.scheduler_cfg, **kw)


def p101(P):
    return P.check_graph(_two_cycle(P), {})


def p102(P):
    specs = {P.cycle_node_name(("a", "b")): P.CycleSpec(order=("a",),
                                                         steps=2)}
    return P.check_graph(_two_cycle(P), specs)


def p103(P):
    g = P.targets.grpo_target().graph
    g.add_worker("stray")
    return P.check_graph(g, {})


def p104(P):
    g = P.FlowGraph()
    for n in ("a", "b", "c", "d", "e", "f"):
        g.add_worker(n)
    g.add_edge("a", "b")
    g.add_edge("c", "d")
    g.add_edge("f", "e")
    return P.check_graph(g, {})


def p105(P):
    return P.check_cost_models(P.targets.grpo_target().graph, {})


def p201(P):
    t, plan = _grpo_plan(P)
    plan.placement["ghost"] = [6, 7]
    return _check(P, t, plan)


def p202(P):
    t, plan = _grpo_plan(P)
    plan.placement["rollout"] = []
    return _check(P, t, plan)


def p203(P):
    t, plan = _grpo_plan(P)
    plan.placement["actor"] = [6, 99]
    return _check(P, t, plan)


def p204(P):
    class OneDeadCluster(P.Cluster):
        def device_alive(self, global_id):
            return global_id != 7

    t, plan = _grpo_plan(P)
    return P.check_plan(plan, graph=t.graph,
                        cluster=OneDeadCluster(num_nodes=1,
                                               devices_per_node=8),
                        cfg=t.scheduler_cfg)


def p205(P):
    t, plan = _grpo_plan(P)
    plan.placement["inference"] = list(plan.placement["rollout"])
    return _check(P, t, plan)


def p206(P):
    t, plan = _grpo_plan(P)
    sched = dataclasses.replace(plan.schedule, n_s=0)
    return _check(P, t, dataclasses.replace(plan, schedule=sched))


def p207(P):
    t, plan = _grpo_plan(P)
    return _check(P, t, plan, sync_edges=(("actor", "ghost"),))


def p208(P):
    t, plan = _grpo_plan(P)
    plan.placement["rollout"] = []
    return _check(P, t, plan, sync_edges=(("actor", "rollout"),))


def p209(P):
    t, plan = _grpo_plan(P)
    sched = _rewrite(P, plan.schedule,
                     lambda n: dataclasses.replace(n, granularity=12)
                     if isinstance(n, P.Pipelined) else n)
    return _check(P, t, dataclasses.replace(plan, schedule=sched))


def p210(P):
    t = P.targets.async_grpo_target()
    plan = P.plan_for(t)
    sched = _rewrite(P, plan.schedule,
                     lambda n: dataclasses.replace(n, depth=-1)
                     if isinstance(n, P.Async) else n)
    return _check(P, t, dataclasses.replace(plan, schedule=sched))


def p211(P):
    t = P.targets.embodied_target()
    plan = P.plan_for(t)
    plan.placement[P.cycle_node_name(("policy_gen", "simulator"))] = [
        0, 1, 2, 3]
    return P.check_plan(dataclasses.replace(plan, members={}),
                        cluster=t.cluster, cfg=t.scheduler_cfg)


def p212(P):
    t = P.targets.embodied_target()
    return _check(P, t, P.plan_for(t), cycle_specs={"bogus": object()})


def _hybrid_leaf_mutation(P, **change):
    t = P.targets.embodied_target("hybrid")
    plan = P.plan_for(t)
    sched = _rewrite(P, plan.schedule,
                     lambda n: dataclasses.replace(n, **change)
                     if isinstance(n, P.Leaf) and n.cycle_mode == "hybrid"
                     else n)
    return _check(P, t, dataclasses.replace(plan, schedule=sched),
                  cycle_specs=t.cycle_specs)


def p213(P):
    return _hybrid_leaf_mutation(P, member_devices=(4,))


def p214(P):
    return _hybrid_leaf_mutation(P, cycle_chunks=0)


def _hybrid_topology(P):
    t = P.targets.embodied_target("hybrid")
    return P.build_topology(t.graph, P.plan_for(t), t.cycle_specs)


def hybrid_ring_clean(P):
    return P.check_topology(_hybrid_topology(P))


def c101(P):
    topo = _hybrid_topology(P)
    for ch in topo.channels.values():
        ch.primed = 0
    return P.check_topology(topo)


def c102(P):
    topo = _hybrid_topology(P)
    for ch in topo.channels.values():
        if ch.name.startswith("ring:"):
            ch.capacity = 1
    ring0 = [c for c in topo.channels.values()
             if c.name.startswith("ring:") and c.name.endswith(":0")][0]
    ring0.primed = 10
    return P.check_topology(topo)


def c103(P):
    topo = P.ChannelTopology()
    topo.add_channel(P.ChannelDecl("aq", kind="async", capacity=0,
                                   staleness_bound=-1, gate_offset=-1))
    topo.put("rollout", "aq")
    topo.get("actor", "aq")
    return P.check_topology(topo)


def c104(P):
    topo = P.ChannelTopology()
    topo.add_channel(P.ChannelDecl("aq", kind="async", capacity=4,
                                   staleness_bound=1, gate_offset=3))
    topo.put("rollout", "aq")
    topo.get("actor", "aq")
    return P.check_topology(topo)


def c105(P):
    topo = P.ChannelTopology()
    topo.add_channel(P.ChannelDecl("dangling"))
    topo.get("actor", "dangling")
    return P.check_topology(topo)


def _ranked(P, devices):
    topo = P.ChannelTopology()
    topo.ranks = {"producer": 1, "consumer": 0}  # inverted
    topo.edges = [("producer", "consumer")]
    topo.devices = devices
    return P.check_topology(topo)


def c106(P):
    return _ranked(P, {"producer": {0, 1}, "consumer": {1, 2}})


def c106_disjoint(P):
    return _ranked(P, {"producer": {0, 1}, "consumer": {2, 3}})


def c107(P):
    topo = P.ChannelTopology()
    topo.lock_sites = [P.LockSite("w1", ("L1", "L2")),
                       P.LockSite("w2", ("L2", "L1"))]
    return P.check_topology(topo)


def c107_three_locks(P):
    """A longer inversion ring behind an acyclic prefix: the cycle
    reported must be the one networkx's find_cycle walks to."""
    topo = P.ChannelTopology()
    topo.lock_sites = [P.LockSite("w0", ("L0", "L1")),
                       P.LockSite("w1", ("L1", "L2", "L3")),
                       P.LockSite("w2", ("L3", "L4")),
                       P.LockSite("w3", ("L4", "L2")),
                       P.LockSite("w4", ("L3", "L1"))]
    return P.check_topology(topo)


def c108(P):
    topo = P.ChannelTopology()
    topo.add_channel(P.ChannelDecl("leaky", closed_on_failure=False))
    topo.put("rollout", "leaky")
    topo.get("actor", "leaky")
    out = P.check_topology(topo)
    topo.ports[-1].timeout = 5.0  # a timeout makes the get interruptible
    return out + P.check_topology(topo)


def async_gate(P):
    t = P.targets.async_grpo_target()
    topo = P.build_topology(t.graph, P.plan_for(t), {})
    aqs = [c for c in topo.channels.values() if c.kind == "async"]
    assert len(aqs) == 1 and aqs[0].capacity == max(aqs[0].staleness_bound,
                                                     1)
    return P.check_topology(topo)


def analyze_min_severity(P):
    g = P.targets.grpo_target().graph
    g.add_worker("stray")  # P103 is a warning
    assert P.analyze(graph=g, min_severity="error") == []
    return P.analyze(graph=g)


# case -> the codes JAX's own test expects (the port must give JAX's
# findings exactly, and these codes)
CASES = {
    "p101": (p101, {"P101"}), "p102": (p102, {"P102"}),
    "p103": (p103, {"P103"}), "p104": (p104, {"P104"}),
    "p105": (p105, {"P105"}), "p201": (p201, {"P201"}),
    "p202": (p202, {"P202"}), "p203": (p203, {"P203"}),
    "p204": (p204, {"P204"}), "p205": (p205, {"P205"}),
    "p206": (p206, {"P206"}), "p207": (p207, {"P207"}),
    "p208": (p208, {"P208", "P202"}), "p209": (p209, {"P209"}),
    "p210": (p210, {"P210"}), "p211": (p211, {"P211"}),
    "p212": (p212, {"P212"}), "p213": (p213, {"P213"}),
    "p214": (p214, {"P214"}), "hybrid_ring_clean": (hybrid_ring_clean,
                                                    set()),
    "c101": (c101, {"C101"}), "c102": (c102, {"C102"}),
    "c103": (c103, {"C103"}), "c104": (c104, {"C104"}),
    "c105": (c105, {"C105"}), "c106": (c106, {"C106"}),
    "c106_disjoint": (c106_disjoint, set()), "c107": (c107, {"C107"}),
    "c107_three_locks": (c107_three_locks, {"C107"}),
    "c108": (c108, {"C108"}), "async_gate": (async_gate, set()),
    "analyze_min_severity": (analyze_min_severity, {"P103"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_findings_equal_jax(case):
    fn, want_codes = CASES[case]
    want = _key(fn(JAX))
    got = _key(fn(PORT))
    assert got == want
    assert {k[0] for k in got} == want_codes


@pytest.mark.parametrize("name", [t.name for t in jtargets.all_targets()])
def test_targets_are_clean_in_both(name):
    (jt,) = [t for t in jtargets.all_targets() if t.name == name]
    (tt,) = [t for t in ttargets.all_targets() if t.name == name]
    assert ja.analyze_target(jt) == []
    assert ta.analyze_target(tt) == [], format_findings(ta.analyze_target(tt))
    # and the plans they lint are the same plans
    jp, tp = jtargets.plan_for(jt), ttargets.plan_for(tt)
    assert tp.placement == jp.placement and tp.est_time == jp.est_time


def test_findings_format_and_filter():
    f = Finding("P999", "error", "x", "boom", hint="fix it",
                pass_name="plan")
    assert "P999" in f.format() and "fix it" in f.format()
    assert filter_findings([f], "warning") == [f]
    assert "clean" in format_findings([])


# ---------------------------------------------------------------------------
# find_cycle and the weak components in networkx's order
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("edges", [
    [("a", "b"), ("b", "a")],
    [("a", "a")],
    [("x", "y"), ("y", "z"), ("z", "w"), ("w", "y"), ("x", "w")],
    [("p", "q"), ("q", "r"), ("p", "s"), ("s", "t"), ("t", "p"),
     ("r", "q")],
    [("a", "b"), ("b", "c")],
])
def test_find_cycle_is_networkx_find_cycle(edges):
    import networkx as nx

    g, ng = DiGraph(), nx.DiGraph()
    for u, v in edges:
        g.add_edge(u, v)
        ng.add_edge(u, v)
    try:
        want = nx.find_cycle(ng)
    except nx.NetworkXNoCycle:
        with pytest.raises(NoCycle):
            find_cycle(g)
        return
    assert find_cycle(g) == want


def test_weak_components_are_networkx_components():
    import networkx as nx

    edges = [("a", "b"), ("c", "d"), ("e", "d"), ("f", "g"), ("g", "h"),
             ("i", "i")]
    g, ng = DiGraph(), nx.DiGraph()
    for n in "zyxabcdefghi":
        g.add_node(n)
        ng.add_node(n)
    for u, v in edges:
        g.add_edge(u, v)
        ng.add_edge(u, v)
    got = [list(c) for c in tfg.weakly_connected_components(g)]
    want = [list(c) for c in nx.weakly_connected_components(ng)]
    assert got == want


# ---------------------------------------------------------------------------
# strict mode: a corrupted plan is rejected before any worker executes
# ---------------------------------------------------------------------------
def _strict_controller(P):
    t = P.targets.grpo_target()
    ctl = P.Controller(t.cluster, profiles=t.cost_models,
                       scheduler_cfg=t.scheduler_cfg, strict=True)
    return t, ctl, ctl.plan(t.graph, total_batch=t.total_batch)


def test_strict_rejects_corrupted_plan_before_execution():
    t, ctl, plan = _strict_controller(PORT)
    plan.placement["rollout"] = [99]  # device outside the cluster
    calls, bound = [], []
    ctl.bind_placement = lambda *a: bound.append(a)
    task_fns = {n: (lambda w, c, n=n: calls.append(n) or c)
                for n in t.graph.nodes}
    with pytest.raises(FlowLintError) as ei:
        ctl.execute(plan, {}, task_fns, {"x": 0})
    assert any(f.code == "P203" for f in ei.value.findings)
    assert calls == [] and bound == []  # before bind_placement / any task
    # JAX's strict controller rejects the same plan with the same findings
    jt, jc, jp = _strict_controller(JAX)
    jp.placement["rollout"] = [99]
    with pytest.raises(ja.FlowLintError) as je:
        jc.execute(jp, {}, {}, {"x": 0})
    assert _key(ei.value.findings) == _key(je.value.findings)


def test_strict_accepts_clean_plan():
    _, ctl, plan = _strict_controller(PORT)
    ctl._lint(plan, None)  # no raise


def test_non_strict_controller_skips_lint():
    t = ttargets.grpo_target()
    ctl = tctl.Controller(t.cluster, profiles=t.cost_models,
                          scheduler_cfg=t.scheduler_cfg)
    assert ctl.strict is False


def test_kernel_pass_and_cross_card_moves_raise_naming_their_items():
    """What this port still lacks raises, naming its ROADMAP item: the
    kernel pass (11b) and moving an engine to another card (12)."""
    with pytest.raises(NotImplementedError, match="item 11b"):
        ta.analyze(kernels=True)
    from repro_torch.configs import get_config
    from repro_torch.rl.workers import RolloutWorker

    cfg = get_config("yi-9b").reduced().replace(
        vocab_size=32, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128)
    w = RolloutWorker("rollout/x", cfg=cfg, devices=(0,), device="cpu")
    try:
        # a slice that folds onto another card than the engine's
        w.mesh_of = lambda devices: ("cuda:1",)
        with pytest.raises(NotImplementedError, match="item 12"):
            w.bind_devices((1,))
    finally:
        w.shutdown()


# ---------------------------------------------------------------------------
# runtime hygiene: LockOrderRecorder vs a real DeviceLock
# ---------------------------------------------------------------------------
def test_lock_recorder_validates_priority_grants():
    rec = LockOrderRecorder()
    prev = set_lock_observer(rec)
    try:
        lock = DeviceLock("L")
        lock.set_priority("prod", 0, (0, 1))
        lock.set_priority("cons", 1, (0, 1))
        assert lock.acquire("warm")  # park both rivals in the wait set
        done = []

        def contend(w):
            lock.acquire(w)
            done.append(w)
            lock.release(w)

        threads = [threading.Thread(target=contend, args=(w,))
                   for w in ("cons", "prod")]
        for th in threads:
            th.start()
        deadline = time.time() + 5.0
        while time.time() < deadline:
            with lock._cv:
                if len(lock._waiting) == 2:
                    break
            time.sleep(0.005)
        lock.release("warm")
        for th in threads:
            th.join(timeout=5.0)
        assert sorted(done) == ["cons", "prod"]
        # rank 0 producer must be granted before the rank 1 consumer
        assert rec.grants("L") == ["warm", "prod", "cons"]
        assert rec.violations() == []
    finally:
        set_lock_observer(prev)


def test_lock_recorder_flags_inverted_grant():
    rec = LockOrderRecorder()
    rec.record("wait", "L", "cons", 1)
    rec.record("wait", "L", "prod", 0)
    rec.record("grant", "L", "cons", 1)
    assert rec.violations()  # granted over a waiting lower rank


def test_lock_recorder_ignores_timed_out_waiter():
    rec = LockOrderRecorder()
    rec.record("wait", "L", "cons", 1)
    rec.record("wait", "L", "prod", 0)
    rec.record("leave", "L", "prod", 0)  # prod's acquire timed out
    rec.record("grant", "L", "cons", 1)
    assert rec.violations() == []


def test_device_lock_timeout_emits_leave():
    rec = LockOrderRecorder()
    prev = set_lock_observer(rec)
    try:
        lock = DeviceLock("L")
        assert lock.acquire("holder")
        assert lock.acquire("rival", timeout=0.05) is False
        lock.release("holder")
        kinds = [(k, w) for k, _, w, _ in rec.events]
        assert ("leave", "rival") in kinds
        assert rec.violations() == []
    finally:
        set_lock_observer(prev)
