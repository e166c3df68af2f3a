"""The port's GRPO runner (``repro_torch.rl.GRPORunner``) on the CPU: the
three execution modes on the quickstart's tiny config with the plans the
JAX runner makes from the same cost models, a two-iteration collocated
run against the JAX runner from the same bridged params, data, noise and
seeds, and the async horizon's version tags."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.primitives import reset_router as jax_reset_router
from repro.configs import get_config as jax_get_config
from repro.core.profiler import CostModel as JCostModel
from repro.core.profiler import paper_like_profiles
from repro.rl import GRPOConfig as JGRPOConfig
from repro.rl import GRPORunner as JGRPORunner
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.trainer import TrainHParams as JTrainHParams
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.comm.primitives import reset_router
from repro_torch.configs import get_config
from repro_torch.core import Channel
from repro_torch.core.profiler import CostModel
from repro_torch.core.scheduler import leaves
from repro_torch.rl import GRPOConfig, GRPORunner
from repro_torch.rl.advantage import staleness_importance_weights
from repro_torch.train import AdamWConfig, TrainHParams
from repro_torch.utils.treeutil import pytree_leaves

torch.set_num_threads(1)

QUICKSTART = dict(vocab_size=32, d_model=128, num_heads=4, num_kv_heads=2,
                  d_ff=256)
LR = 1e-3
LP_ATOL = 1e-4  # the recompute's tolerance in tests/test_torch_train.py
ROLE = {"rollout": "rollout", "inference": "inference", "reward": "reward",
        "actor": "training"}


@pytest.fixture(autouse=True)
def fresh_state():
    reset_router()
    jax_reset_router()
    Channel.reset_all()
    yield
    reset_router()
    jax_reset_router()
    Channel.reset_all()


@functools.lru_cache(maxsize=None)
def _cfgs():
    return (jax_get_config("yi-9b").reduced().replace(**QUICKSTART),
            get_config("yi-9b").reduced().replace(**QUICKSTART))


def _fixed_profiles():
    """The paper-like cost models under the GRPO workers' names, in both
    packages: what the two runners plan from in place of measurements."""
    base = paper_like_profiles(gen_tail=8.0)
    jp, tp = {}, {}
    for name, role in ROLE.items():
        f = {x.name: getattr(base[role], x.name)
             for x in dataclasses.fields(base[role])}
        f["name"] = name
        jp[name], tp[name] = JCostModel(**f), CostModel(**f)
    return jp, tp


def jax_base_seeds(seed, n):
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(int(jax.random.randint(sub, (), 0, 2**31 - 1)))
    return out


def jax_noise(seeds, positions, V):
    keys = jax.vmap(lambda s, p: jax.random.fold_in(jax.random.PRNGKey(s),
                                                    p))(
        jnp.asarray(seeds.cpu().numpy(), jnp.int32),
        jnp.asarray(positions.cpu().numpy(), jnp.int32))
    return np.array(jax.vmap(
        lambda k: jax.random.gumbel(k, (V,), jnp.float32))(keys))


def _record(runner):
    """Wrap the runner's task fns to keep a copy of what each stage
    returned, per call."""
    log = {n: [] for n in runner.task_fns}

    def wrap(name, fn):
        def run(w, c):
            out = fn(w, c)
            log[name].append({k: np.array(v) for k, v in out.items()
                              if k != "metrics"})
            return out
        return run

    runner.task_fns = {n: wrap(n, f) for n, f in runner.task_fns.items()}
    return log


@pytest.mark.parametrize("mode", ["collocated", "disaggregated", "auto"])
def test_runner_runs_each_mode_on_jaxs_plan(mode):
    jcfg, tcfg = _cfgs()
    kw = dict(batch_size=16, group_size=4, iterations=2, max_new_tokens=4,
              mode=mode, seed=0, profile_batches=(8, 16))
    jr = JGRPORunner(jcfg, JGRPOConfig(**kw), JTrainHParams(
        optimizer=JAdamWConfig(lr=LR)))
    tr = GRPORunner(tcfg, GRPOConfig(**kw), TrainHParams(
        optimizer=AdamWConfig(lr=LR)), device="cpu")
    jprof, tprof = _fixed_profiles()
    jr.controller.profiles, tr.controller.profiles = jprof, tprof
    jr.plan_execution()
    tr.plan_execution()
    assert type(tr.plan.schedule) is not None
    assert type(tr.plan.schedule).__name__ == \
        type(jr.plan.schedule).__name__
    assert repr(tr.plan.schedule) == repr(jr.plan.schedule)
    assert tr.plan.placement == jr.plan.placement
    assert tr.plan.est_time == jr.plan.est_time
    before = [t.clone() for t in pytree_leaves(tr.actor.params())]
    tr.run_loop(verbose=False)
    assert len(tr.stats) == 2
    assert all(np.isfinite(s.mean_reward) and s.wall_time > 0
               for s in tr.stats)
    assert all(np.isfinite(v) for v in tr.stats[-1].metrics.values())
    for name, w in tr.workers.items():  # the plan's placement is binding
        assert list(w.devices) == tr.plan.placement[name], name
    assert tr.sync_stats["syncs"] == 2 and tr.sync_stats["bytes"] > 0
    assert tr.throughput() > 0
    assert {lf.worker for lf in leaves(tr.plan.schedule)} == set(ROLE)
    if tr.stats[-1].metrics.get("grad_norm", 0.0) > 0:
        assert not all(torch.equal(a, b) for a, b in
                       zip(before, pytree_leaves(tr.actor.params())))


def test_profile_fits_cost_models_from_the_run():
    _, tcfg = _cfgs()
    rl = GRPOConfig(batch_size=8, group_size=4, iterations=1,
                    max_new_tokens=3, mode="collocated", seed=0,
                    profile_batches=(4, 8))
    tr = GRPORunner(tcfg, rl, TrainHParams(optimizer=AdamWConfig(lr=LR)),
                    device="cpu")
    tr.profile()
    prof = tr.controller.profiles
    assert set(prof) == set(ROLE)
    for name in ("rollout", "inference", "actor"):
        cm = prof[name]
        assert cm.base_time >= 0 and cm.slope_time >= 0
        assert cm.onload_time > 0 and cm.offload_time > 0
        assert cm.base_mem == tr.workers[name].state_bytes() > 0
    assert prof["rollout"].tail_factor >= 1.0
    assert prof["reward"].base_mem == 0
    tr.plan_execution()
    assert tr.plan.mode == "collocated"
    # the first iteration's sync is measured into the targets' models
    tr.run_iteration(0)
    for name in ("rollout", "inference"):
        assert prof[name].sync_time > 0
        assert prof[name].sync_bytes == tr.actor.state_bytes() / 3


def _parity_runs(iterations=2):
    """The JAX runner and the port's on the learning recipe's task (tiny
    config, groups of 8, one-digit sums) from the same params, data,
    base seeds, noise and cost models, collocated."""
    jcfg, tcfg = _cfgs()
    kw = dict(batch_size=32, group_size=8, iterations=iterations,
              max_new_tokens=3, mode="collocated", seed=0,
              profile_batches=(8,))
    jr = JGRPORunner(jcfg, JGRPOConfig(**kw), JTrainHParams(
        optimizer=JAdamWConfig(lr=LR, clip_norm=1.0), entropy_coef=0.02))
    jp = jax.tree.map(np.asarray, jr.actor.params())
    tr = GRPORunner(tcfg, GRPOConfig(**kw), TrainHParams(
        optimizer=AdamWConfig(lr=LR, clip_norm=1.0), entropy_coef=0.02),
        device="cpu", params=params_from_numpy(jp, device="cpu"))
    tr.rollout.seeds = iter(jax_base_seeds(0, iterations))
    tr.rollout.engine.layout.noise_fn = jax_noise
    logs = []
    for r in (jr, tr):
        r.data.max_operand = 3
        r.data.add_only = True
        logs.append(_record(r))
    jprof, tprof = _fixed_profiles()
    jr.controller.profiles, tr.controller.profiles = jprof, tprof
    for r in (jr, tr):
        r.plan_execution()
        r.run_loop(verbose=False)
    return jr, tr, logs


def test_two_collocated_iterations_match_jax():
    """Tokens, rewards, loss masks and advantages exactly, recomputed
    logprobs within 1e-4, the actor's params after two steps within 2 lr
    (as the two-step train test of tests/test_torch_train.py: where a
    gradient is ~0, Adam's step may flip its sign), and the last rollout
    scored by both actors' final params within 1e-4, which holds the
    last step itself."""
    jr, tr, (jlog, tlog) = _parity_runs()
    assert repr(tr.plan.schedule) == repr(jr.plan.schedule)
    assert len(tlog["actor"]) == len(jlog["actor"]) == 2
    for it in range(2):
        jo, to = jlog["rollout"][it], tlog["rollout"][it]
        np.testing.assert_array_equal(to["tokens"], jo["tokens"])
        np.testing.assert_allclose(to["logprobs"], jo["logprobs"],
                                   atol=LP_ATOL)
        np.testing.assert_array_equal(to["weight_versions"],
                                      jo["weight_versions"])
        np.testing.assert_allclose(tlog["inference"][it]["old_logprobs"],
                                   jlog["inference"][it]["old_logprobs"],
                                   atol=LP_ATOL)
        for k in ("rewards", "loss_mask", "advantages"):
            np.testing.assert_array_equal(tlog["reward"][it][k],
                                          jlog["reward"][it][k])
    # the run learned something: some group had a right answer
    assert any(np.abs(c["advantages"]).max() > 0 for c in tlog["reward"])
    assert [s.mean_reward for s in tr.stats] == \
        [s.mean_reward for s in jr.stats]
    for k, v in tr.stats[-1].metrics.items():
        np.testing.assert_allclose(v, jr.stats[-1].metrics[k], atol=1e-6,
                                   rtol=1e-4, err_msg=k)
    got = pytree_leaves(params_to_numpy(tr.actor.params()))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jr.actor.params()))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2 * LR, rtol=0)
    # the last step, which no later stage reads: the actors' final params
    # score the last rollout alike, and differently from the params it
    # was scored with before that step (so a wrong or missing last step
    # shows)
    chunk = {"tokens": tlog["rollout"][-1]["tokens"]}
    t_lp = tr.inference.compute_logprobs(
        chunk, key="lp", params=tr.actor.params())["lp"][:, 1:]
    j_lp = np.asarray(jr.inference.compute_logprobs(
        chunk, key="lp", params=jr.actor.params())["lp"])[:, 1:]
    np.testing.assert_allclose(t_lp, j_lp, atol=LP_ATOL)
    before = tlog["inference"][-1]["old_logprobs"][:, 1:]
    assert np.abs(t_lp - before).max() > 10 * LP_ATOL
    # and the synced rollout weights are the actor's of the last sync
    assert tr.sync_stats["syncs"] == jr.sync_stats["syncs"] == 2


def test_async_depth_one_keeps_version_tags_monotone():
    _, tcfg = _cfgs()
    rl = GRPOConfig(batch_size=16, group_size=4, iterations=5,
                    max_new_tokens=3, mode="collocated", seed=0,
                    profile_batches=(8,), async_depth=1)
    tr = GRPORunner(tcfg, rl, TrainHParams(
        optimizer=AdamWConfig(lr=LR, clip_norm=1.0)), device="cpu")
    log = _record(tr)
    tr.profile()
    tr.plan_execution()
    for calls in log.values():  # keep the horizon's calls only
        calls.clear()
    tr.run_loop(verbose=False)
    assert tr.plan.mode in ("async-1", "auto")
    assert len(tr.stats) == 5
    assert tr._driver.version == 5
    assert tr._driver.queue.max_observed_staleness <= 1
    tags = [int(c["weight_versions"].max()) for c in log["rollout"]]
    assert tags == sorted(tags), tags
    assert all(int(c["weight_versions"].min()) == int(
        c["weight_versions"].max()) for c in log["rollout"])
    # rollout i ran on the weights of update i or i - 1, never older
    assert len(tags) == 5
    assert all(i - 1 <= v <= i for i, v in enumerate(tags)), tags
    # the published snapshot is the actor's params as of the last update,
    # not the live tensors
    version, snap = tr._published
    assert version == 5
    for a, s in zip(pytree_leaves(tr.actor.params()), pytree_leaves(snap)):
        assert torch.equal(a, s) and a.data_ptr() != s.data_ptr()


def test_async_offpolicy_alias_and_fields_match_jax():
    for kw in ({}, {"async_offpolicy": True},
               {"async_offpolicy": True, "async_depth": 2},
               {"staleness_correction": False}):
        t, j = GRPOConfig(**kw), JGRPOConfig(**kw)
        assert (t.async_depth, t.async_offpolicy, t.staleness_correction) \
            == (j.async_depth, j.async_offpolicy, j.staleness_correction)
    assert GRPOConfig(async_offpolicy=True).async_depth == 1


@pytest.mark.parametrize("correct", [True, False])
def test_staleness_correction_only_when_asked(correct):
    """async_depth=1: with the correction off, every chunk reaches the
    actor with the reward worker's advantages untouched and is never
    re-scored, as the JAX runner leaves it; with it on, the stale chunks
    are re-scored at the current params and their advantages damped."""
    _, tcfg = _cfgs()
    rl = GRPOConfig(batch_size=16, group_size=4, iterations=4,
                    max_new_tokens=3, mode="collocated", seed=0,
                    profile_batches=(8,), async_depth=1,
                    staleness_correction=correct)
    tr = GRPORunner(tcfg, rl, TrainHParams(
        optimizer=AdamWConfig(lr=LR, clip_norm=1.0), entropy_coef=0.02),
        device="cpu")
    tr.data.max_operand = 3
    tr.data.add_only = True
    log = _record(tr)
    tr.profile()
    tr.plan_execution()
    for calls in log.values():
        calls.clear()
    seen = []
    actor_fn = tr.task_fns["actor"]

    def actor(w, c):
        seen.append({k: np.array(c[k]) for k in c if k != "metrics"}
                    | {"rescored": "target_logprobs" in c})
        return actor_fn(w, c)

    tr.task_fns["actor"] = actor
    tr.run_loop(verbose=False)
    by_tokens = {c["tokens"].tobytes(): c["advantages"]
                 for c in log["reward"]}
    stale = [c for c in seen if c["rescored"]]
    if not correct:
        assert not stale
        for c in seen:
            np.testing.assert_array_equal(
                c["advantages"], by_tokens[c["tokens"].tobytes()])
    else:
        assert stale  # the horizon ran ahead of the trainer
        for c in stale:  # damped by the truncated importance weight
            rho = staleness_importance_weights(
                c["old_logprobs"], c["target_logprobs"], c["loss_mask"],
                staleness=1, clip_ratio=rl.staleness_clip)
            np.testing.assert_array_equal(
                c["advantages"], by_tokens[c["tokens"].tobytes()] * rho)
        # re-scored at params newer than the behaviour's
        assert any(not np.array_equal(c["target_logprobs"],
                                      c["old_logprobs"]) for c in stale)
