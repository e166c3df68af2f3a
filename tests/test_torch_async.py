"""The port's async off-policy pipelining on the cases of the JAX
package's async tests: staleness bounds, version monotonicity,
importance-correction sync equivalence, and scheduler/simulator agreement
for Async schedules."""
import queue as _queue
import threading
import time

import numpy as np
import pytest

from repro_torch.core import (
    Async,
    AsyncPipelineDriver,
    AsyncQueue,
    FlowGraph,
    Scheduler,
    SchedulerConfig,
    Simulator,
    StalenessExceeded,
    async_makespan,
)
from repro_torch.core.profiler import paper_like_profiles
from repro_torch.rl.advantage import staleness_importance_weights


def grpo_graph():
    g = FlowGraph()
    for w in ("rollout", "inference", "training"):
        g.add_worker(w)
    g.add_edge("rollout", "inference")
    g.add_edge("inference", "training")
    return g


# ---------------------------------------------------------------------------
# AsyncQueue
# ---------------------------------------------------------------------------
def test_version_tags_must_be_monotone():
    q = AsyncQueue("mono", staleness_bound=4)
    q.put("a", version=0)
    q.put("b", version=2)
    with pytest.raises(ValueError):
        q.put("c", version=1)


def test_strict_policy_raises_beyond_bound():
    q = AsyncQueue("strict", staleness_bound=1)
    q.put("old", version=0)
    q.advance_consumer(2)  # trainer advanced 2 versions -> staleness 2 > 1
    with pytest.raises(StalenessExceeded):
        q.get()


def test_drop_policy_skips_stale_items():
    q = AsyncQueue("drop", staleness_bound=2, stale_policy="drop")
    q.put("old", version=0)
    q.put("fresh", version=4)
    q.advance_consumer(4)
    item = q.get()
    assert item.data == "fresh"
    assert q.dropped_stale == 1


def test_capacity_backpressure_blocks_producer():
    q = AsyncQueue("cap", staleness_bound=1)  # capacity 1
    q.put("a", version=0)
    with pytest.raises(_queue.Full):
        q.put("b", version=0, timeout=0.05)


def test_wait_for_version_gates_producer():
    q = AsyncQueue("gate", staleness_bound=0)
    done = []

    def waiter():
        q.wait_for_version(1)
        done.append(True)

    th = threading.Thread(target=waiter, daemon=True)
    th.start()
    time.sleep(0.05)
    assert not done  # still gated
    q.advance_consumer(1)
    th.join(timeout=1.0)
    assert done


# ---------------------------------------------------------------------------
# AsyncPipelineDriver: the bound holds under real thread interleavings
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("K", [0, 1, 2, 3])
def test_driver_staleness_never_exceeds_bound(K):
    iters = 12
    observed = []

    def produce(i, version):
        time.sleep(0.001 * (i % 3))  # jitter the interleaving
        return {"i": i, "gen_version": version}

    def consume(item):
        observed.append(d.queue.consumer_version - item.version)
        time.sleep(0.002)
        return item.data

    d = AsyncPipelineDriver(produce_fn=produce, consume_fn=consume,
                            staleness_bound=K, name=f"drv-{K}")
    out = d.run(iters)
    assert [o["i"] for o in out] == list(range(iters))  # ordered, complete
    assert max(observed) <= K
    assert d.queue.max_observed_staleness <= K


def test_driver_k0_is_fully_synchronous():
    """K=0: every item is generated at exactly the version that consumes
    it — bit-for-bit on-policy."""
    def produce(i, version):
        return {"i": i, "v": version}

    def consume(item):
        assert item.version == d.queue.consumer_version  # staleness == 0
        return item.data

    d = AsyncPipelineDriver(produce_fn=produce, consume_fn=consume,
                            staleness_bound=0, name="drv-sync")
    out = d.run(8)
    assert [o["v"] for o in out] == list(range(8))


def test_driver_syncs_weights_before_each_item():
    synced = []

    d = AsyncPipelineDriver(
        produce_fn=lambda i, v: i,
        consume_fn=lambda item: item.data,
        sync_fn=lambda v: synced.append(v),
        staleness_bound=1, name="drv-sync-fn")
    d.run(5)
    assert len(synced) == 5
    assert synced == sorted(synced)  # versions only move forward


def test_driver_propagates_producer_errors():
    def produce(i, version):
        if i == 2:
            raise RuntimeError("boom")
        return i

    d = AsyncPipelineDriver(produce_fn=produce,
                            consume_fn=lambda item: item.data,
                            staleness_bound=1, name="drv-err")
    with pytest.raises(RuntimeError, match="boom"):
        d.run(5)


# ---------------------------------------------------------------------------
# Importance correction
# ---------------------------------------------------------------------------
def test_importance_correction_is_identity_at_zero_staleness():
    rng = np.random.default_rng(0)
    behavior = rng.normal(size=(4, 10)).astype(np.float32)
    target = rng.normal(size=(4, 10)).astype(np.float32)
    mask = (rng.random((4, 10)) > 0.3).astype(np.float32)
    w = staleness_importance_weights(behavior, target, mask, staleness=0)
    np.testing.assert_array_equal(w, np.ones((4, 10), np.float32))


def test_importance_correction_truncates_without_double_counting():
    """The damper w must satisfy exp(delta) * w == min(exp(delta), clip):
    the loss's behavior-referenced ratio supplies the IS weight once; w
    only enforces the truncation."""
    behavior = np.zeros((1, 4), np.float32)
    target = np.array([[0.0, np.log(1.5), np.log(10.0), -1.0]], np.float32)
    mask = np.array([[1.0, 1.0, 1.0, 0.0]], np.float32)
    w = staleness_importance_weights(behavior, target, mask,
                                     staleness=2, clip_ratio=2.0)
    assert w[0, 0] == pytest.approx(1.0)   # ratio 1 -> untouched
    assert w[0, 1] == pytest.approx(1.0)   # ratio 1.5 < clip -> untouched
    # ratio 10 > clip: damper brings ratio * w down to exactly clip
    assert 10.0 * w[0, 2] == pytest.approx(2.0, rel=1e-6)
    assert w[0, 3] == pytest.approx(1.0)   # off-mask untouched


# ---------------------------------------------------------------------------
# Scheduler Async dimension + simulator agreement
# ---------------------------------------------------------------------------
def test_async_makespan_k0_is_serial():
    # K = 0 forbids any overlap: producer waits for every update
    assert async_makespan(2.0, 1.0, 0, 5) == pytest.approx(5 * 3.0)


def test_async_makespan_bottleneck_steady_state():
    # deep staleness budget: steady-state increment = bottleneck stage
    t = async_makespan(3.0, 1.0, 4, 10)
    assert t == pytest.approx(3.0 * 10 + 1.0)  # fill + producer-bound


def test_simulator_matches_scheduler_async_estimate():
    """The satellite acceptance test: event-simulated makespan of an Async
    schedule equals the scheduler's analytic recurrence."""
    profiles = paper_like_profiles(gen_tail=8.0)
    g = grpo_graph()
    cfg = SchedulerConfig(total_batch=256, device_quantum=8)
    sch = Scheduler(profiles, cfg)
    for K in (1, 2, 4):
        t_est, s = sch.schedule_async(g, 64, 256, iterations=8,
                                      depths=(K,))
        if not isinstance(s, Async):
            continue  # freshness tax kept it sync at this K
        res = Simulator(profiles).run(s, 256)
        assert res.makespan == pytest.approx(t_est, rel=1e-9)
        # spans cover every iteration of both sides
        iters = {sp.chunk for sp in res.spans if sp.kind == "compute"}
        assert iters == set(range(8))


def test_async_schedule_beats_sync_on_longtail():
    """With a heavy generation tail, some K >= 1 must strictly beat the
    sync horizon (this is the tentpole's raison d'etre)."""
    profiles = paper_like_profiles(gen_tail=8.0)
    g = grpo_graph()
    cfg = SchedulerConfig(total_batch=256, device_quantum=8)
    sch = Scheduler(profiles, cfg)
    iters = 8
    t_sync, _ = sch.schedule(g, 64, 256)
    t_async, s = sch.schedule_async(g, 64, 256, iterations=iters)
    assert isinstance(s, Async) and s.depth >= 1
    assert t_async < t_sync * iters


def test_async_search_never_worse_than_sync_horizon():
    """schedule_async's K=0 candidate IS the sync plan, so the returned
    cost can never exceed the sync horizon — on any profile shape."""
    for tail in (1.0, 4.0, 50.0):
        profiles = paper_like_profiles(gen_tail=tail)
        g = grpo_graph()
        sch = Scheduler(profiles, SchedulerConfig(total_batch=128,
                                                  device_quantum=8))
        t_sync, _ = sch.schedule(g, 32, 128)
        t_async, _ = sch.schedule_async(g, 32, 128, iterations=6)
        assert t_async <= t_sync * 6 + 1e-9


def test_sync_horizon_simulator_agreement():
    """run_iterations on a plain schedule = back-to-back replay."""
    profiles = paper_like_profiles()
    g = grpo_graph()
    sch = Scheduler(profiles, SchedulerConfig(total_batch=256,
                                              device_quantum=8))
    t_est, s = sch.schedule(g, 64, 256)
    res = Simulator(profiles).run_iterations(s, 256, 5)
    assert res.makespan == pytest.approx(5 * t_est, rel=1e-6)


# ---------------------------------------------------------------------------
# End-to-end: async GRPO on the real (tiny) workers
# ---------------------------------------------------------------------------
def test_grpo_async_depth_end_to_end():
    from repro_torch.configs import get_config
    from repro_torch.rl import GRPOConfig, GRPORunner
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import TrainHParams

    cfg = get_config("yi-9b").reduced().replace(
        vocab_size=32, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128)
    rl = GRPOConfig(batch_size=16, group_size=4, iterations=6,
                    max_new_tokens=3, mode="collocated", seed=0,
                    profile_batches=(8,), async_depth=2)
    runner = GRPORunner(cfg, rl, TrainHParams(
        optimizer=AdamWConfig(lr=1e-3, clip_norm=1.0)), device="cpu")
    stats = runner.run(verbose=False)
    assert len(stats) == 6
    assert runner._driver.queue.max_observed_staleness <= 2
    # the trainer really advanced one version per iteration
    assert runner._driver.version == 6
