"""Kill-and-recover on the port's runtime (``repro_torch.rl.runner``,
``repro_torch.launch.cluster``), as the JAX package's fault tests run it:
a deterministic toy workflow whose recovered run equals the
fresh-resume baseline bit for bit, the runner's failure bounds, host
death on a ``SimulatedCluster``, and kill-and-recover against
fresh-resume for the three workflow families at the JAX test's sizes.
Each compares the port's faulted run with the port's own baseline."""
import shutil

import numpy as np
import pytest
import torch

from repro_torch.comm.primitives import global_router, reset_router
from repro_torch.core import FlowGraph, SchedulerConfig
from repro_torch.core.faults import FaultInjector, FaultSpec, InjectedFault
from repro_torch.core.worker import Worker, WorkerFailure
from repro_torch.launch.cluster import SimulatedCluster, cluster_from_env
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.rl.runner import WorkflowRunner
from repro_torch.utils.treeutil import pytree_leaves

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# SimulatedCluster
# ---------------------------------------------------------------------------
def test_simulated_cluster_host_death_and_restore():
    c = SimulatedCluster(num_nodes=2, devices_per_node=4)
    assert c.num_hosts == 2 and c.host_devices(1) == [4, 5, 6, 7]
    assert c.host_of(5) == "host1"
    a = c.allocate("a", 2)
    b = c.allocate("b", 4)
    touched = c.fail_host(1)
    assert touched == sorted(o for o, ids in (("a", a), ("b", b))
                             if set(ids) & {4, 5, 6, 7})
    assert c.available_devices() == [0, 1, 2, 3]
    assert c.alive_hosts() == [0] and not c.device_alive(4)
    c.restore_host(1)
    assert c.available_devices() == list(range(8))


def test_cluster_from_env(monkeypatch):
    monkeypatch.setenv("REPRO_DRYRUN_HOSTS", "3")
    monkeypatch.setenv("REPRO_DRYRUN_DEVICES", "2")
    c = cluster_from_env()
    assert (c.num_nodes, c.devices_per_node) == (3, 2)
    c = cluster_from_env(hosts=1, devices_per_host=4)
    assert (c.num_nodes, c.devices_per_node) == (1, 4)


# ---------------------------------------------------------------------------
# deterministic toy workflow: recovery == fresh-resume, bit-exact
# ---------------------------------------------------------------------------
class ToyTrainer(Worker):
    def __init__(self, name, devices=()):
        super().__init__(name, devices=devices, device="cpu")
        self.register_state("params", torch.zeros(4, dtype=torch.float64))
        self.register_state("opt", torch.zeros(1, dtype=torch.float64))

    def params(self):
        return self.get_state("params")

    def train(self, chunk):
        p = self.get_state("params")
        o = self.get_state("opt")
        x = torch.from_numpy(np.asarray(chunk["x"], np.float64))
        p = p + 0.01 * x.mean(dim=0)
        o = o + 1.0
        self.set_state("params", p)
        self.set_state("opt", o)
        out = dict(chunk)
        out["metric"] = float(p.sum())
        return out


class ToyRollout(Worker):
    def __init__(self, name, devices=()):
        super().__init__(name, devices=devices, device="cpu")
        self._wsum = 0.0

    def update_weights(self, params, version=None):
        self._wsum = float(sum(float(l.sum()) for l in pytree_leaves(params)))

    def gen(self, chunk):
        out = dict(chunk)
        out["x"] = np.asarray(chunk["x"], np.float64) + self._wsum
        return out


class ToyRunner(WorkflowRunner):
    weight_sync_workers = ("rollout",)
    versioned_sync_worker = None

    def __init__(self, **kw):
        self._count = 0
        kw.setdefault("iterations", 4)
        kw.setdefault("batch_size", 8)
        kw.setdefault("mode", "collocated")
        kw.setdefault("profile_batches", (4,))
        kw.setdefault("cluster",
                      SimulatedCluster(num_nodes=2, devices_per_node=2))
        super().__init__(**kw)

    def build_workers(self):
        self.actor = ToyTrainer(
            "trainer/0", devices=self.cluster.allocate("trainer", 2))
        self.rollout = ToyRollout(
            "rollout/0", devices=self.cluster.allocate("rollout", 2))
        return {"rollout": self.rollout, "trainer": self.actor}

    def build_task_fns(self):
        return {"rollout": lambda w, c: w.gen(c),
                "trainer": lambda w, c: w.train(c)}

    def build_graph(self):
        g = FlowGraph()
        g.add_worker("rollout")
        g.add_worker("trainer")
        g.add_edge("rollout", "trainer")
        return g

    def make_batch(self):
        self._count += 1
        base = np.linspace(0.0, 1.0, self.batch_size * 4).reshape(
            self.batch_size, 4)
        return {"x": base * self._count}

    def reset_stream(self):
        self._count = 0

    def scheduler_config(self):
        return SchedulerConfig(total_batch=self.batch_size,
                               granularity_divisors=(1, 2))

    def _record_stats(self, it, wall, out):
        st = (it, float(out["metric"]))
        self.stats.append(st)
        return st

    def log_iteration(self, st):
        pass


def _spy_dead_workers(runner):
    """Keep the workers each recovery tears down (to check they let go of
    their tensors)."""
    dead = []
    recover = runner.recover

    def spy(verbose=True):
        dead.extend(runner.workers.values())
        return recover(verbose)

    runner.recover = spy
    return dead


def _toy_three_stage(tmp_path, role, mode, k=2, total=5, kill_host=False):
    """Stage 1 advances a run to a checkpoint at iteration k; stage 2
    resumes with a kill at (k, invocation 0) and recovers; stage 3 is the
    uninterrupted baseline resumed from a copy of the same checkpoint.
    Returns (faulted_runner, baseline_runner, dead workers)."""
    ck = str(tmp_path / f"ck-{role}-{mode}")
    ck_base = ck + "-baseline"
    # batch 2 pins the disaggregated granularity sweep to one candidate
    batch = 2 if mode == "disaggregated" else 8

    reset_router()
    warm = ToyRunner(iterations=k, mode=mode, batch_size=batch,
                     checkpoint_dir=ck, checkpoint_every=1)
    warm.run(verbose=False)
    shutil.copytree(ck, ck_base)

    reset_router()
    cluster = SimulatedCluster(num_nodes=2, devices_per_node=2)
    inj = FaultInjector(FaultSpec(role, iteration=k, invocation=0,
                                  kill_host=kill_host), cluster=cluster)
    faulted = ToyRunner(iterations=total, mode=mode, batch_size=batch,
                        checkpoint_dir=ck, checkpoint_every=1,
                        fault_injector=inj, cluster=cluster)
    dead = _spy_dead_workers(faulted)
    faulted.run(verbose=False)
    assert inj.fired
    assert faulted.recoveries == 1
    assert faulted.recovery_log[0].worker == role

    reset_router()
    baseline = ToyRunner(iterations=total, mode=mode, batch_size=batch,
                         checkpoint_dir=ck_base, checkpoint_every=1)
    baseline.run(verbose=False)
    assert baseline.recoveries == 0
    return faulted, baseline, dead


@pytest.mark.parametrize("role", ["rollout", "trainer"])
@pytest.mark.parametrize("mode", ["collocated", "disaggregated"])
def test_toy_recovery_is_bit_exact(tmp_path, role, mode):
    faulted, baseline, dead = _toy_three_stage(tmp_path, role, mode)
    # post-recovery trajectory identical to the fresh-resume baseline
    assert faulted.stats == baseline.stats
    assert torch.equal(faulted.actor.params(), baseline.actor.params())
    assert torch.equal(faulted.actor.get_state("opt"),
                       baseline.actor.get_state("opt"))
    # the torn-down incarnation let go of every tensor it held
    assert dead and all(v is None for w in dead for v in w._state.values())
    assert set(faulted.recovery_seconds) == {"teardown", "rebuild",
                                             "profile", "resume"}


def test_toy_recovery_after_host_death_uses_survivors(tmp_path):
    faulted, baseline, _ = _toy_three_stage(tmp_path, "trainer",
                                            "collocated", kill_host=True)
    alive = set(faulted.cluster.available_devices())
    assert len(alive) == 2  # one of the two hosts died
    for name, devs in faulted.plan.placement.items():
        assert set(devs) <= alive, (name, devs)
    assert faulted.stats == baseline.stats


def test_no_stale_allocations_or_registrations_after_recovery(tmp_path):
    faulted, _, _ = _toy_three_stage(tmp_path, "rollout", "collocated", k=1,
                                     total=3)
    cluster = faulted.cluster
    planned = {n: sorted(d) for n, d in faulted.plan.placement.items() if d}
    assert {n: sorted(d) for n, d in cluster._allocations.items()} == planned
    router = global_router()
    assert set(router._workers) == {w.name
                                    for w in faulted.workers.values()}
    for w in faulted.workers.values():
        assert router.placement(w.name)["devices"] == list(w.devices)


def test_unhandled_failure_raises_when_not_fault_tolerant(tmp_path):
    reset_router()
    inj = FaultInjector(FaultSpec("rollout", iteration=1))
    runner = ToyRunner(iterations=3, fault_injector=inj,
                       fault_tolerant=False,
                       checkpoint_dir=str(tmp_path / "nt"),
                       checkpoint_every=1)
    with pytest.raises(WorkerFailure) as ei:
        runner.run(verbose=False)
    assert ei.value.worker == "rollout"
    assert isinstance(ei.value.original, InjectedFault)
    assert runner.recoveries == 0


def test_max_recoveries_bounds_the_loop(tmp_path):
    reset_router()

    class EveryIterationInjector(FaultInjector):
        def set_iteration(self, it):
            # re-target: this chaos monkey kills rollout EVERY iteration
            object.__setattr__(self, "spec",
                               FaultSpec("rollout", iteration=it))
            self.fired = False
            super().set_iteration(it)

    inj = EveryIterationInjector(FaultSpec("rollout", iteration=0))
    runner = ToyRunner(iterations=3, fault_injector=inj, max_recoveries=2,
                       checkpoint_dir=str(tmp_path / "mr"),
                       checkpoint_every=1)
    with pytest.raises(WorkerFailure):
        runner.run(verbose=False)
    assert runner.recoveries == 2


def test_recovery_is_traced_and_counted(tmp_path):
    """The run loop's worker-failure instant and its counter, as the JAX
    runner records them."""
    reset_router()
    inj = FaultInjector(FaultSpec("trainer", iteration=1))
    runner = ToyRunner(iterations=3, fault_injector=inj,
                       checkpoint_dir=str(tmp_path / "tr"),
                       checkpoint_every=1)
    reg = tmetrics.MetricsRegistry()
    prev = tmetrics.set_registry(reg)
    try:
        with ttrace.tracing() as tr:
            runner.run(verbose=False)
    finally:
        tmetrics.set_registry(prev)
    fails = tr.instants("fault")
    assert [i.name for i in fails] == ["worker-failure"]
    assert fails[0].args["worker"] == "trainer"
    assert fails[0].args["iteration"] == 1
    snap = reg.snapshot()
    assert snap["faults/recoveries"]["value"] == 1
    assert snap["runner/recoveries"]["value"] == 1


# ---------------------------------------------------------------------------
# kill-and-recover for the three workflow families on a 2-host simulated
# topology, at the JAX test's sizes
# ---------------------------------------------------------------------------
def _grpo_runner(ck, iterations, injector=None, cluster=None):
    from repro_torch.configs import get_config
    from repro_torch.rl import GRPOConfig, GRPORunner
    from repro_torch.train import TrainHParams
    from repro_torch.train.optimizer import AdamWConfig

    cfg = get_config("yi-9b").reduced().replace(
        vocab_size=32, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128)
    rl = GRPOConfig(batch_size=8, group_size=4, iterations=iterations,
                    max_new_tokens=4, mode="auto", seed=0,
                    profile_batches=(4, 8))
    return GRPORunner(
        cfg, rl, TrainHParams(optimizer=AdamWConfig(lr=1e-3)),
        cluster=cluster or SimulatedCluster(num_nodes=2, devices_per_node=4),
        device="cpu", checkpoint_dir=ck, checkpoint_every=1,
        fault_injector=injector)


def _rlhf_runner(ck, iterations, injector=None, cluster=None):
    from repro_torch.configs import get_config
    from repro_torch.rl import PPOConfig, RLHFRunner

    cfg = get_config("stablelm-12b").reduced().replace(
        vocab_size=32, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128)
    return RLHFRunner(
        cfg, PPOConfig(batch_size=8, iterations=iterations,
                       max_new_tokens=3, seed=0, profile_batches=(4, 8)),
        cluster=cluster or SimulatedCluster(num_nodes=2, devices_per_node=4),
        device="cpu", checkpoint_dir=ck, checkpoint_every=1,
        fault_injector=injector)


def _embodied_runner(ck, iterations, injector=None, cluster=None):
    from repro_torch.rl import EmbodiedPPOConfig, EmbodiedPPORunner

    rl = EmbodiedPPOConfig(num_envs=8, horizon=4, iterations=iterations,
                           mode="collocated", seed=0, max_steps=8,
                           profile_batches=(4, 8), checkpoint_dir=ck,
                           checkpoint_every=1)
    return EmbodiedPPORunner(
        rl,
        cluster=cluster or SimulatedCluster(num_nodes=2, devices_per_node=4),
        device="cpu", fault_injector=injector)


_FAMILIES = {
    # family -> (runner factory, role to kill, invocation, stat fields)
    "grpo": (_grpo_runner, "rollout", 0, ("mean_reward", "accuracy")),
    "rlhf": (_rlhf_runner, "actor", 0, ("mean_reward", "value_loss")),
    # invocation 2 = the simulator's third cycle step: a mid-loop
    # phase-boundary kill inside the collapsed cycle node
    "embodied": (_embodied_runner, "simulator", 2,
                 ("mean_reward", "success_rate")),
}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_kill_and_recover_e2e_matches_fresh_resume(tmp_path, family):
    make, role, invocation, fields = _FAMILIES[family]
    k, total = 1, 3
    ck = str(tmp_path / f"{family}-ck")
    ck_base = ck + "-baseline"

    reset_router()
    make(ck, iterations=k).run(verbose=False)
    shutil.copytree(ck, ck_base)

    reset_router()
    cluster = SimulatedCluster(num_nodes=2, devices_per_node=4)
    inj = FaultInjector(FaultSpec(role, iteration=k, invocation=invocation),
                        cluster=cluster)
    faulted = make(ck, iterations=total, injector=inj, cluster=cluster)
    dead = _spy_dead_workers(faulted)
    faulted.run(verbose=False)
    assert inj.fired
    assert faulted.recoveries == 1
    assert faulted.recovery_log[0].worker == role

    reset_router()
    baseline = make(ck_base, iterations=total)
    baseline.run(verbose=False)

    got = [s for s in faulted.stats if s.iteration >= k]
    want = [s for s in baseline.stats if s.iteration >= k]
    assert [s.iteration for s in got] == [s.iteration for s in want]
    for g, w in zip(got, want):
        for f in fields:
            assert np.isfinite(getattr(g, f))
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=1e-4, atol=1e-5, err_msg=f)
    # the trainer's final state equals the baseline's
    for a, b in zip(pytree_leaves(faulted.actor.params()),
                    pytree_leaves(baseline.actor.params())):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    # re-placement left no stale cluster allocations behind
    planned = {n: sorted(d) for n, d in faulted.plan.placement.items() if d}
    current = {n: sorted(d)
               for n, d in faulted.cluster._allocations.items()}
    assert current == planned
    # and the dead incarnation holds no tensors (nor engines)
    assert dead
    for w in dead:
        assert all(v is None for v in w._state.values()), w.name
        assert getattr(w, "engine", None) is None, w.name


def test_grpo_recovers_onto_surviving_host(tmp_path):
    """Host death: the run must finish on the surviving host's devices."""
    ck = str(tmp_path / "hostkill-ck")
    reset_router()
    cluster = SimulatedCluster(num_nodes=2, devices_per_node=4)
    inj = FaultInjector(FaultSpec("actor", iteration=1, kill_host=True),
                        cluster=cluster)
    runner = _grpo_runner(ck, iterations=3, injector=inj, cluster=cluster)
    stats = runner.run(verbose=False)
    assert runner.recoveries == 1
    assert len(cluster.available_devices()) == 4
    for name, devs in runner.plan.placement.items():
        assert all(cluster.device_alive(i) for i in devs), (name, devs)
    assert all(np.isfinite(s.mean_reward) for s in stats)
