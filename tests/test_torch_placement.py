"""The port's binding placement on the cases of the JAX package's
placement tests: PlacementManager diff/rebind, Cluster invariants,
ContextSwitcher measurement feedback, weight sync as a copy."""
import numpy as np
import pytest
import torch

from repro_torch.comm.primitives import reset_router
from repro_torch.comm.resharding import timed_weight_sync, transfer_stats
from repro_torch.core import (
    Channel,
    Cluster,
    ContextSwitcher,
    Controller,
    FlowGraph,
    PlacementManager,
    Worker,
)
from repro_torch.core.profiler import CostModel
from repro_torch.core.scheduler import Async, Leaf, Pipelined, Temporal, leaves

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh_state():
    reset_router()
    Channel.reset_all()
    yield
    reset_router()
    Channel.reset_all()


class StageWorker(Worker):
    """Minimal schedulable worker with registered state."""

    def __init__(self, name, *, devices=(), with_opt=False):
        super().__init__(name, devices=devices, device="cpu")
        self.register_state("params", {"w": torch.arange(8.0)})
        if with_opt:
            self.register_state("opt", {"m": torch.zeros(8)})

    def run_stage(self, chunk):
        self.get_state("params")  # force lazy onload, like a real task
        return dict(chunk)


def chain_graph(names):
    g = FlowGraph()
    prev = None
    for n in names:
        g.add_worker(n)
        if prev is not None:
            g.add_edge(prev, n)
        prev = n
    return g


def chain_profiles(names, **kw):
    return {n: CostModel(n, base_time=0.1, slope_time=0.01,
                         onload_time=0.2, offload_time=0.2, **kw)
            for n in names}


def make_controller(names, n_devices=8, per_worker=2):
    cluster = Cluster(num_nodes=1, devices_per_node=n_devices)
    workers = {n: StageWorker(f"{n}/0",
                              devices=cluster.allocate(n, per_worker))
               for n in names}
    task_fns = {n: (lambda w, c: w.run_stage(c)) for n in names}
    ctl = Controller(cluster, profiles=chain_profiles(names))
    return ctl, workers, task_fns


# ---------------------------------------------------------------------------
# Controller.execute makes the plan binding (acceptance criterion)
# ---------------------------------------------------------------------------
def test_execute_rebinds_devices_across_modes():
    """Planning two different modes and executing must rebind the
    workers' device slices to each plan's placement."""
    names = ("a", "b")
    ctl, workers, fns = make_controller(names)
    g = chain_graph(names)
    batch = {"x": np.ones((8, 2), np.float32)}

    plan_col = ctl.plan(g, total_batch=8, mode="collocated")
    ctl.execute(plan_col, workers, fns, batch)
    col_devs = {n: tuple(workers[n].devices) for n in names}
    for n in names:
        assert list(col_devs[n]) == plan_col.placement[n]
    # collocated: both workers share the full device set
    assert set(col_devs["a"]) == set(col_devs["b"]) == set(range(8))

    plan_dis = ctl.plan(g, total_batch=8, mode="disaggregated")
    ctl.execute(plan_dis, workers, fns, batch)
    dis_devs = {n: tuple(workers[n].devices) for n in names}
    for n in names:
        assert list(dis_devs[n]) == plan_dis.placement[n]
    # disaggregated: disjoint slices — and different from before
    assert not (set(dis_devs["a"]) & set(dis_devs["b"]))
    assert dis_devs != col_devs


def test_placement_manager_leaves_no_stale_allocations():
    names = ("a", "b")
    ctl, workers, fns = make_controller(names)
    g = chain_graph(names)
    for mode in ("collocated", "disaggregated", "collocated"):
        plan = ctl.plan(g, total_batch=8, mode=mode)
        ctl.bind_placement(plan, workers)
        # every managed owner's allocation equals the plan's slice exactly
        for n in names:
            assert sorted(ctl.cluster._allocations[n]) == \
                sorted(plan.placement[n]), (mode, n)
        assert set(ctl.cluster._allocations) == set(plan.placement)


def test_placement_manager_idempotent_and_scoped():
    cluster = Cluster(num_nodes=1, devices_per_node=8)
    cluster.allocate("foreign", 2, device_ids=[6, 7], exclusive=True)
    pm = PlacementManager(cluster)
    changed = pm.apply({"a": [0, 1], "b": [2, 3]})
    assert changed == {}  # no live workers passed
    first = dict(cluster._allocations)
    pm.apply({"a": [0, 1], "b": [2, 3]})  # idempotent
    assert cluster._allocations == first
    # foreign exclusive owner untouched by both applies
    assert cluster._allocations["foreign"] == [6, 7]
    # a changed plan drops the old slice, keeps the foreign one
    pm.apply({"a": [4, 5]})
    assert "b" not in cluster._allocations
    assert cluster._allocations["a"] == [4, 5]
    assert cluster._allocations["foreign"] == [6, 7]


def test_worker_bind_devices_updates_router_and_mesh():
    w = StageWorker("w/0", devices=(0, 1))
    mesh_before = w.device_mesh
    assert mesh_before is not None
    w.bind_devices((2, 3, 4))
    assert w.devices == (2, 3, 4)
    assert w.router.placement("w/0")["devices"] == [2, 3, 4]
    # state survived the rebind
    np.testing.assert_array_equal(
        np.asarray(w.get_state("params")["w"]), np.arange(8.0))
    w.shutdown()


# ---------------------------------------------------------------------------
# Plan placement invariants: spatial sides disjoint, temporal sides shared
# ---------------------------------------------------------------------------
def _check_sides(node, placement):
    if isinstance(node, Leaf):
        return
    s_workers = [l.worker for l in leaves(node.s)]
    t_workers = [l.worker for l in leaves(node.t)]
    s_devs = set().union(*(set(placement[w]) for w in s_workers))
    t_devs = set().union(*(set(placement[w]) for w in t_workers))
    if isinstance(node, (Pipelined, Async)):
        assert not (s_devs & t_devs), (type(node).__name__, s_devs, t_devs)
    elif isinstance(node, Temporal):
        assert s_devs & t_devs, ("Temporal sides must share", s_devs, t_devs)
    _check_sides(node.s, placement)
    _check_sides(node.t, placement)


def test_plan_placement_disjoint_spatial_shared_temporal():
    names = ("a", "b", "c")
    ctl, _, _ = make_controller(names)
    g = chain_graph(names)
    for mode in ("collocated", "disaggregated", "auto"):
        plan = ctl.plan(g, total_batch=16, mode=mode)
        _check_sides(plan.schedule, plan.placement)


def test_async_plan_placement_sides_disjoint():
    names = ("a", "b")
    ctl, _, _ = make_controller(names)
    # make `a` long-tailed so the async overlap wins
    ctl.profiles["a"].tail_factor = 8.0
    g = chain_graph(names)
    plan = ctl.plan_async(g, total_batch=16, iterations=8, depths=[1])
    if isinstance(plan.schedule, Async):
        _check_sides(plan.schedule, plan.placement)


# ---------------------------------------------------------------------------
# Cluster rebinding invariants (satellite)
# ---------------------------------------------------------------------------
def test_cluster_free_reallocate_roundtrip_preserves_exclusivity():
    c = Cluster(num_nodes=1, devices_per_node=4)
    c.allocate("t", 2, device_ids=[0, 1], exclusive=True)
    c.free("t")
    # round-trip: the same owner can re-take the slice exclusively...
    c.allocate("t", 2, device_ids=[0, 1], exclusive=True)
    # ...and exclusivity is enforced again after the round-trip
    with pytest.raises(ValueError, match="exclusively held"):
        c.allocate("r", 1, device_ids=[0])
    c.free("t")
    # after the final free the devices are ordinary again
    assert c.allocate("r", 1, device_ids=[0]) == [0]


# ---------------------------------------------------------------------------
# ContextSwitcher: per-key offload, prefetch, measured feedback
# ---------------------------------------------------------------------------
def test_worker_per_key_offload():
    w = StageWorker("pk/0", devices=(0,), with_opt=True)
    moved = w.offload(keys=("opt",))
    assert moved == ("opt",)
    assert w.offloaded and w.offloaded_keys() == ("opt",)
    # params stayed resident: reading must NOT pull opt back
    assert w._state["params"] is not None
    w.get_state("params")
    assert "opt" in w._offloaded
    moved = w.offload()  # the rest
    assert moved == ("params",)
    assert set(w.onload()) == {"opt", "params"}
    assert not w.offloaded
    w.shutdown()


def test_context_switcher_measures_and_feeds_cost_models():
    names = ("a", "b", "c")
    ctl, workers, fns = make_controller(names)
    # zero the assumed costs so any non-zero value must be measured
    for cm in ctl.profiles.values():
        cm.onload_time = cm.offload_time = 0.0
    g = chain_graph(names)
    plan = ctl.plan(g, total_batch=8, mode="collocated")
    batch = {"x": np.ones((8, 2), np.float32)}
    ctl.execute(plan, workers, fns, batch)  # iter 1: offloads measured
    ctl.execute(plan, workers, fns, batch)  # iter 2: onloads measured too
    assert ctl.switch_stats, "no switches measured on a collocated plan"
    assert ctl.profiles["a"].offload_time > 0.0
    # b was offloaded at iter-1's second cut and prefetch-onloaded at
    # iter-2's first cut — its measured onload must be in the CostModel
    assert "onload_time" in ctl.switch_stats.get("b", {})
    assert ctl.profiles["b"].onload_time > 0.0
    # per-key records exist
    switcher = ctl._switcher
    assert any(r.kind == "offload" for r in switcher.records)
    assert any(r.kind == "onload" for r in switcher.records)


def test_context_switcher_switch_frees_before_onloading():
    workers = {"x": StageWorker("x/0", devices=(0,), with_opt=True),
               "y": StageWorker("y/0", devices=(0,))}
    workers["y"].offload()
    sw = ContextSwitcher(workers)
    sw.switch(["x"], ["y"])
    assert workers["x"].offloaded
    assert not workers["y"].offloaded
    # optimizer state was offloaded as its own record, before params
    keys = [r.key for r in sw.records
            if r.worker == "x" and r.kind == "offload"]
    assert keys.index("opt") < keys.index("params")
    # memory discipline on shared devices: the incoming side's onload
    # happened strictly AFTER the outgoing side finished offloading
    assert [r.kind for r in sw.records] == \
        ["offload", "offload", "onload"]


def test_onload_places_state_on_workers_mesh():
    """Regression: state offloaded across a bind_devices rebind must
    onload onto the device of the worker's NEW slice."""
    w = StageWorker("mv/0", devices=(0,), with_opt=True)
    w.offload()
    assert w._host_state["params"]["w"].device.type == "cpu"
    w.bind_devices((1, 2))
    w.onload()
    assert w.device_mesh == (torch.device("cpu"),)
    leaf = w.get_state("params")["w"]
    assert leaf.device == w.device
    torch.testing.assert_close(leaf, torch.arange(8.0))
    w.shutdown()


# ---------------------------------------------------------------------------
# End-to-end acceptance: the GRPO runner goes through the binding path
# ---------------------------------------------------------------------------
def test_grpo_runner_binding_placement_and_measured_costs():
    """After iteration 1: workers are bound to the plan's placement,
    weight-sync cost is measured (not assumed) in the CostModels, and
    re-planning a different mode rebinds the device slices."""
    from repro_torch.configs import get_config
    from repro_torch.rl import GRPOConfig, GRPORunner
    from repro_torch.train import TrainHParams
    from repro_torch.train.optimizer import AdamWConfig

    cfg = get_config("yi-9b").reduced().replace(
        vocab_size=32, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128)
    rl = GRPOConfig(batch_size=8, group_size=4, iterations=2,
                    max_new_tokens=4, mode="collocated", seed=0,
                    profile_batches=(4, 8))
    runner = GRPORunner(cfg, rl, TrainHParams(optimizer=AdamWConfig(lr=1e-3)),
                        device="cpu")
    runner.run(verbose=False)

    # (1) binding placement: every worker sits on its plan slice
    for name, w in runner.workers.items():
        assert list(w.devices) == runner.plan.placement[name], name
    assert set(runner.rollout.devices) == set(range(8))  # temporal share

    # (2) measured weight sync in the CostModels + byte accounting
    prof = runner.controller.profiles
    assert prof["rollout"].sync_time > 0.0
    assert prof["rollout"].sync_bytes > 0.0
    assert runner.sync_stats["syncs"] >= 2 and runner.sync_stats["bytes"] > 0

    # (3) context switches measured during execution
    assert runner.controller.switch_stats

    # (4) a different mode rebinds to different (disjoint) slices
    runner.mode = "disaggregated"
    runner.plan_execution()
    runner.run_iteration(2)
    devs = {n: set(w.devices) for n, w in runner.workers.items()}
    assert list(runner.rollout.devices) == runner.plan.placement["rollout"]
    assert not (devs["rollout"] & devs["actor"])
    assert set(runner.rollout.devices) != set(range(8))


def test_rollout_rebind_keeps_engine_cache_on_the_worker_device():
    """A rebind within the slices that fold onto the engine's device keeps
    the paged pool and weights where they are, and generation still
    works end to end after it."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.rl.workers import RolloutWorker

    cfg = get_config("yi-9b").reduced().replace(
        vocab_size=32, d_model=32, num_heads=2, num_kv_heads=2, head_dim=16,
        d_ff=64)
    w = RolloutWorker("ro/0", cfg=cfg, max_new_tokens=2, seed=0,
                      devices=(0, 1), device="cpu")
    w.update_weights(init_model(None, cfg, device="cpu"))
    prompts = np.ones((2, 4), np.int32)
    w.generate({"prompt_tokens": prompts})
    w.bind_devices((2, 3))
    assert w.devices == (2, 3)
    assert w.engine.cache.k.device == w.device
    out = w.generate({"prompt_tokens": prompts})
    assert out["tokens"].shape[0] == 2
    w.shutdown()


def test_rollout_rebind_onto_another_card_raises(monkeypatch):
    """A rebind onto a card the host does not have raises and leaves the
    worker, its state and its engine where they were (the port never
    falls back to the CPU)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.rl.workers import RolloutWorker

    cfg = get_config("yi-9b").reduced().replace(
        vocab_size=32, d_model=32, num_heads=2, num_kv_heads=2, head_dim=16,
        d_ff=64)
    w = RolloutWorker("ro2/0", cfg=cfg, max_new_tokens=2, devices=(0,),
                      device="cpu")
    w.update_weights(init_model(torch.Generator().manual_seed(0), cfg,
                                device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        w.bind_devices((1,), platform="cuda")
    assert w.devices == (0,) and w.device == torch.device("cpu")
    assert w.engine.device.type == "cpu"
    assert all(x.device.type == "cpu"
               for x in tree_leaves_of(w.get_state("params")))
    w.shutdown()


def _rebind_worker(arch: str, name: str):
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.rl.workers import RolloutWorker

    cfg = get_config(arch).reduced().replace(vocab_size=32)
    w = RolloutWorker(name, cfg=cfg, max_new_tokens=3, seed=0, temperature=0.0,
                      devices=(0, 1), engine="paged", device="cpu")
    w.update_weights(init_model(torch.Generator().manual_seed(0), cfg,
                                device="cpu"))
    return w


@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-370m"])
def test_rollout_rebind_moves_engine_cache(arch):
    """JAX's regression on the port: the engine's cache (a paged pool, or
    the state cache with its zero row and prompt snapshots) and the
    applied weights follow a rebind onto another device, one copy of
    the weights shared by worker and engine, the old storage dropped.
    The CPU has no second device to come back from, so the move goes to
    the meta device; the card's tests and chip_smoke.py bind cuda -> cpu
    -> cuda and compare tokens.  A rebind whose slice folds onto the same
    device generates the tokens of a worker never rebound."""
    import gc
    import weakref

    prompts = np.arange(1, 9, dtype=np.int32).reshape(2, 4) % 30 + 1
    still = _rebind_worker(arch, f"still/{arch}")
    want = [still.generate({"prompt_tokens": prompts})["tokens"]
            for _ in range(2)]
    w = _rebind_worker(arch, f"moved/{arch}")
    np.testing.assert_array_equal(
        w.generate({"prompt_tokens": prompts})["tokens"], want[0])
    w.bind_devices((4, 5))  # folds onto the CPU again: nothing moves
    np.testing.assert_array_equal(
        w.generate({"prompt_tokens": prompts})["tokens"], want[1])
    eng = w.engine
    old = [weakref.ref(x) for x in tree_leaves_of(eng.cache)]
    w.bind_devices((2, 3), platform="meta")
    assert w.device.type == "meta" and eng.device.type == "meta"
    assert eng.layout.device.type == "meta"
    assert all(x.device.type == "meta" for x in tree_leaves_of(eng.cache))
    params = tree_leaves_of(w.get_state("params"))
    assert params and all(x.device.type == "meta" for x in params)
    # the applied weights are the worker's own tensors, not a second copy
    assert all(a is b for a, b in zip(tree_leaves_of(eng.params), params))
    if hasattr(eng.layout, "_zero_row"):
        rows = [eng.layout._zero_row, *eng.layout._exact.values()]
        assert len(rows) > 1
        assert all(x.device.type == "meta"
                   for row in rows for x in tree_leaves_of(row))
    gc.collect()
    assert all(r() is None for r in old)  # the CPU storage is gone
    still.shutdown()
    w.shutdown()


def tree_leaves_of(tree):
    from repro_torch.utils.treeutil import pytree_flatten

    return pytree_flatten(tree)[0]


# ---------------------------------------------------------------------------
# Weight sync through the resharding data plane
# ---------------------------------------------------------------------------
def test_timed_weight_sync_onto_worker_device():
    w = StageWorker("dst/0", devices=(0, 1))
    params = {"w": torch.ones((4, 4)), "b": torch.zeros(4)}
    dst = w.sync_destination(params)
    synced, dt = timed_weight_sync(params, dst)
    assert dt >= 0.0 and synced is dst
    np.testing.assert_array_equal(np.asarray(synced["w"]), np.ones((4, 4)))
    # a copy: the source's next in-place update leaves it alone
    assert synced["w"].data_ptr() != params["w"].data_ptr()
    params["w"].add_(1.0)
    np.testing.assert_array_equal(np.asarray(synced["w"]), np.ones((4, 4)))
    stats = transfer_stats(params)
    assert stats["bytes"] == 4 * 4 * 4 + 4 * 4 and stats["arrays"] == 2
    w.shutdown()
