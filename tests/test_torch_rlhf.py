"""The port's RLHF/PPO workflow (``repro_torch.rl.rlhf_workflow``) on the
CPU against the JAX package's, on the reduced stablelm of
``tests/test_rl.py::test_rlhf_ppo_four_model_workflow``: each worker on
the same chunk and bridged weights (critic values and a value step,
reference logprobs, a PPO actor step with the KL term, the reward's GAE),
the plans of the 6-node diamond in every mode, two collocated iterations
from the same bridged actor and critic, base seeds and noise, the
reference held apart from the actor it was cloned from, and that test's
own learning bar on the port."""
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
from repro.rl import rlhf_workflow as jrlhf
from repro.train.trainer import TrainHParams as JTrainHParams
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.comm.primitives import reset_router
from repro_torch.configs import get_config
from repro_torch.core import Channel, Scheduler, SchedulerConfig
from repro_torch.core.profiler import CostModel
from repro_torch.rl import rlhf_workflow as trlhf
from repro_torch.rl import PPOConfig, RLHFRunner
from repro_torch.train import TrainHParams, policy_loss
from repro_torch.utils.treeutil import pytree_leaves, tree_leaves, tree_map

from test_torch_grpo import _record, jax_base_seeds, jax_noise

torch.set_num_threads(1)

# the recompute's tolerance in tests/test_torch_train.py (f32, another
# summation order)
ATOL = 1e-4
LR = 1e-3  # the runner's default actor lr, and the critic's
# |grad| above which its sign is sure (tests/test_torch_workers.py)
GRAD_FLOOR = 1e-5
TINY = dict(vocab_size=32, d_model=128, num_heads=4, num_kv_heads=2,
            head_dim=32, d_ff=256)
PROMPT_LEN, B, S = 8, 8, 11
ROLE = {"rollout": "rollout", "inference": "inference",
        "reference": "inference", "critic_v": "inference",
        "reward": "reward", "actor": "training"}


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
def _setup():
    """(jax cfg, port cfg, the JAX actor's and critic's params, numpy)."""
    jcfg = jax_get_config("stablelm-12b").reduced().replace(**TINY)
    tcfg = get_config("stablelm-12b").reduced().replace(**TINY)
    ja = jrlhf.PPOActorWorker("actor/0", cfg=jcfg, hp=JTrainHParams(),
                              seed=0)
    jc = jrlhf.CriticWorker("critic/0", cfg=jcfg, seed=1)
    jp = jax.tree.map(np.asarray, ja.params())
    jcp = jax.tree.map(np.asarray, jc.get_state("params"))
    ja.shutdown()
    jc.shutdown()
    return jcfg, tcfg, jp, jcp


def _bridge(tree):
    return params_from_numpy(tree, device="cpu")


def _chunk(seed=0):
    """A scored rollout chunk: prompt + response tokens (some zeros past
    the end), behaviour and reference logprobs, advantages, returns and
    the response mask."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, TINY["vocab_size"], (B, S)).astype(np.int32)
    toks[1, -2:] = 0
    toks[4, -1:] = 0
    mask = np.zeros((B, S), np.float32)
    mask[:, PROMPT_LEN:] = toks[:, PROMPT_LEN:] != 0
    return {
        "tokens": toks,
        "answers": rng.integers(0, 7, B).astype(np.int32),
        "old_logprobs": (-2.0 - rng.random((B, S))).astype(np.float32),
        "ref_logprobs": (-2.0 - rng.random((B, S))).astype(np.float32),
        "advantages": (rng.standard_normal((B, S)) * mask).astype(np.float32),
        "returns": (rng.standard_normal((B, S)) * 3 * mask).astype(np.float32),
        "values": rng.standard_normal((B, S)).astype(np.float32),
        "loss_mask": mask,
    }


def _grads(loss_fn, params):
    """The gradient leaves of ``loss_fn(params)`` (port tensors, numpy)."""
    live = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    leaves = tree_leaves(live)
    grads = torch.autograd.grad(loss_fn(live), leaves, allow_unused=True)
    return [np.zeros(p.shape, np.float32) if g is None else g.numpy()
            for p, g in zip(leaves, grads)]


def _assert_update_matches(got, want, before, grads, lr):
    """The update p - p0 within 0.1 % of JAX's wherever |g| is clear of
    rounding, over half the elements with a gradient so held, and the
    step really moved the params (tests/test_torch_workers.py's bar)."""
    clear = total = 0
    moved = []
    for g, w, p0, gr in zip(got, want, before, grads):
        sure = np.abs(gr) > GRAD_FLOOR
        np.testing.assert_allclose((g - p0)[sure], (w - p0)[sure],
                                   rtol=1e-3, atol=1e-3 * lr)
        clear, total = clear + sure.sum(), total + (gr != 0).sum()
        moved.append(np.abs(g - p0).max())
    assert clear > 0.5 * total, (clear, total)
    assert max(moved) > 0.5 * lr


# ---------------------------------------------------------------------------
# workers against JAX
# ---------------------------------------------------------------------------
def test_critic_values_and_value_step_match_jax():
    jcfg, tcfg, _, jcp = _setup()
    jc = jrlhf.CriticWorker("critic/0", cfg=jcfg, seed=1)
    tc = trlhf.CriticWorker("critic/0", cfg=tcfg, params=_bridge(jcp),
                            device="cpu")
    chunk = _chunk()
    jv, tv = jc.values(chunk)["values"], tc.values(chunk)["values"]
    assert tv.shape == (B, S) and tv.dtype == np.float32
    np.testing.assert_allclose(tv, np.asarray(jv), atol=ATOL)
    grads = _grads(lambda p: (torch.square(
        trlhf.critic_values(p, tcfg, torch.tensor(chunk["tokens"]).long())
        - torch.tensor(chunk["returns"])) * torch.tensor(chunk["loss_mask"])
    ).sum() / float(chunk["loss_mask"].sum()), _bridge(jcp))
    jl = jc.train_value(chunk)["value_loss"]
    tl = tc.train_value(chunk)["value_loss"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_update_matches(
        pytree_leaves(params_to_numpy(tc.get_state("params"))),
        jax.tree.leaves(jax.tree.map(np.asarray, jc.get_state("params"))),
        jax.tree.leaves(jcp), grads, LR)
    assert tc.get_state("opt").step == 1


def test_reference_logprobs_match_jax_and_its_params_are_a_clone():
    jcfg, tcfg, jp, _ = _setup()
    actor = _bridge(jp)
    jr = jrlhf.ReferenceWorker("reference/0", cfg=jcfg,
                               params=jax.tree.map(jnp.asarray, jp))
    tr = trlhf.ReferenceWorker("reference/0", cfg=tcfg, params=actor,
                               device="cpu")
    chunk = _chunk(1)
    jl, tl = jr.ref_logprobs(chunk), tr.ref_logprobs(chunk)
    np.testing.assert_allclose(tl["ref_logprobs"],
                               np.asarray(jl["ref_logprobs"]), atol=ATOL)
    assert (tl["ref_logprobs"][:, 0] == 0).all()
    for a, r in zip(pytree_leaves(actor),
                    pytree_leaves(tr.get_state("params"))):
        assert torch.equal(a, r) and a.data_ptr() != r.data_ptr()
    # the actor's in-place steps leave the reference alone
    before = [r.clone() for r in pytree_leaves(tr.get_state("params"))]
    for a in pytree_leaves(actor):
        a.add_(1.0)
    assert all(torch.equal(b, r) for b, r in
               zip(before, pytree_leaves(tr.get_state("params"))))


def test_ppo_actor_step_with_kl_matches_jax():
    jcfg, tcfg, jp, _ = _setup()
    jhp = JTrainHParams(optimizer=jrlhf.AdamWConfig(lr=LR, clip_norm=1.0),
                        kl_coef=0.05, entropy_coef=0.02)
    thp = TrainHParams(optimizer=trlhf.AdamWConfig(lr=LR, clip_norm=1.0),
                       kl_coef=0.05, entropy_coef=0.02)
    ja = jrlhf.PPOActorWorker("actor/0", cfg=jcfg, hp=jhp, seed=0)
    ta = trlhf.PPOActorWorker("actor/0", cfg=tcfg, hp=thp,
                              params=_bridge(jp), device="cpu")
    chunk = _chunk(2)
    jm, tm = ja.train(chunk)["metrics"], ta.train(chunk)["metrics"]
    assert tm.keys() == jm.keys() and "kl_ref" in tm
    assert tm["kl_ref"] > 0
    for k in tm:
        np.testing.assert_allclose(tm[k], jm[k], atol=1e-6, rtol=1e-4,
                                   err_msg=k)
    batch = {k: torch.tensor(chunk[k]) for k in
             ("old_logprobs", "advantages", "loss_mask", "ref_logprobs")}
    batch["tokens"] = torch.tensor(chunk["tokens"]).long()
    grads = _grads(lambda p: policy_loss(tcfg, thp, p, batch)[0],
                   _bridge(jp))
    _assert_update_matches(
        pytree_leaves(params_to_numpy(ta.params())),
        jax.tree.leaves(jax.tree.map(np.asarray, ja.params())),
        jax.tree.leaves(jp), grads, LR)


def test_ppo_reward_worker_matches_jax():
    chunk = _chunk(3)
    # a few right answers: the reward lands on the last valid token
    chunk["tokens"][0, PROMPT_LEN:PROMPT_LEN + 2] = [3 + chunk["answers"][0],
                                                     2]
    jw = jrlhf.PPORewardWorker("reward/0", prompt_len=PROMPT_LEN)
    tw = trlhf.PPORewardWorker("reward/0", prompt_len=PROMPT_LEN)
    jo, to = jw.score(dict(chunk)), tw.score(dict(chunk))
    for k in ("rewards", "loss_mask", "advantages", "returns"):
        np.testing.assert_array_equal(to[k], np.asarray(jo[k]), err_msg=k)
    assert np.abs(to["advantages"]).max() > 0


# ---------------------------------------------------------------------------
# plans and the runner against JAX
# ---------------------------------------------------------------------------
def _fixed_profiles():
    base = paper_like_profiles(gen_tail=8.0)
    jp, tp = {}, {}
    for name, role in ROLE.items():
        f = {x.name: getattr(base[role], x.name)
             for x in dataclasses.fields(base[role])}
        f["name"] = name
        jp[name], tp[name] = JCostModel(**f), CostModel(**f)
    return jp, tp


@pytest.mark.parametrize("mode", ["collocated", "disaggregated", "auto"])
def test_rlhf_graph_plans_match_jax(mode):
    jcfg, tcfg, _, _ = _setup()
    kw = dict(batch_size=16, iterations=1, max_new_tokens=3, mode=mode,
              profile_batches=(8, 16))
    jr = jrlhf.RLHFRunner(jcfg, jrlhf.PPOConfig(**kw))
    tr = RLHFRunner(tcfg, PPOConfig(**kw), device="cpu")
    jprof, tprof = _fixed_profiles()
    jr.controller.profiles, tr.controller.profiles = jprof, tprof
    jr.plan_execution()
    tr.plan_execution()
    assert repr(tr.plan.schedule) == repr(jr.plan.schedule)
    assert tr.plan.placement == jr.plan.placement
    assert tr.plan.est_time == jr.plan.est_time
    assert tr.controller.scheduler_cfg.chunk_multiple == 16
    jr.teardown()
    tr.teardown()


def _parity_runs(iterations=2):
    """The JAX runner and the port's, collocated, from the same actor and
    critic params, data, base seeds, noise and cost models."""
    jcfg, tcfg, jp, jcp = _setup()
    kw = dict(batch_size=16, iterations=iterations, max_new_tokens=3,
              mode="collocated", seed=0, profile_batches=(8,))
    jr = jrlhf.RLHFRunner(jcfg, jrlhf.PPOConfig(**kw))
    # the JAX runner draws its own actor and critic from the seeds above
    for a, b in zip(jax.tree.leaves(jr.actor.params()), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), b)
    jr.critic.set_state("params", jax.tree.map(jnp.asarray, jcp))
    tr = RLHFRunner(tcfg, PPOConfig(**kw), device="cpu", params=_bridge(jp),
                    critic_params=_bridge(jcp))
    tr.rollout.seeds = iter(jax_base_seeds(0, iterations))
    tr.rollout.engine.layout.noise_fn = jax_noise
    logs = [_record(jr), _record(tr)]
    jprof, tprof = _fixed_profiles()
    jr.controller.profiles, tr.controller.profiles = jprof, tprof
    for r in (jr, tr):
        r.plan_execution()
        r.run_loop(verbose=False)
    return jr, tr, logs


def test_two_collocated_iterations_match_jax():
    """Tokens, rewards and loss masks exactly; values, advantages,
    returns and old/ref logprobs within 1e-4; the actor's and the
    critic's params after two steps within 2 lr, and the last rollout
    scored by both actors' and both critics' final params within 1e-4,
    which holds each last step itself (as the GRPO runner's parity
    test); the reference still the initial actor."""
    jr, tr, (jlog, tlog) = _parity_runs()
    assert repr(tr.plan.schedule) == repr(jr.plan.schedule)
    assert len(tlog["actor"]) == len(jlog["actor"]) == 2
    for it in range(2):
        np.testing.assert_array_equal(tlog["rollout"][it]["tokens"],
                                      jlog["rollout"][it]["tokens"])
        for stage, k in (("inference", "old_logprobs"),
                         ("reference", "ref_logprobs"),
                         ("critic_v", "values")):
            np.testing.assert_allclose(tlog[stage][it][k],
                                       jlog[stage][it][k], atol=ATOL,
                                       err_msg=k)
        for k in ("rewards", "loss_mask"):
            np.testing.assert_array_equal(tlog["reward"][it][k],
                                          jlog["reward"][it][k])
        for k in ("advantages", "returns"):
            np.testing.assert_allclose(tlog["reward"][it][k],
                                       jlog["reward"][it][k], atol=ATOL,
                                       err_msg=k)
    for s, j in zip(tr.stats, jr.stats):
        assert s.mean_reward == j.mean_reward
        np.testing.assert_allclose(s.value_loss, j.value_loss, rtol=1e-4)
        assert "kl_ref" in s.metrics
        for k, v in s.metrics.items():
            np.testing.assert_allclose(v, j.metrics[k], atol=1e-6,
                                       rtol=1e-4, err_msg=k)
    # the second step's KL is live: the actor moved off the reference
    assert tr.stats[-1].metrics["kl_ref"] > 0
    for got, want in ((tr.actor.params(), jr.actor.params()),
                      (tr.critic.get_state("params"),
                       jr.critic.get_state("params"))):
        for g, w in zip(pytree_leaves(params_to_numpy(got)),
                        jax.tree.leaves(jax.tree.map(np.asarray, want))):
            np.testing.assert_allclose(g, w, atol=2 * LR, rtol=0)
    # the last steps, which no later stage reads: the final params score
    # the last rollout alike, and differently from the params it was
    # scored with before those steps (so a wrong or missing step shows)
    tokens = tlog["rollout"][-1]["tokens"]
    t_lp = tr.inference.compute_logprobs(
        {"tokens": tokens}, key="lp", params=tr.actor.params())["lp"][:, 1:]
    j_lp = np.asarray(jr.inference.compute_logprobs(
        {"tokens": tokens}, key="lp",
        params=jr.actor.params())["lp"])[:, 1:]
    np.testing.assert_allclose(t_lp, j_lp, atol=ATOL)
    before = tlog["inference"][-1]["old_logprobs"][:, 1:]
    assert np.abs(t_lp - before).max() > 10 * ATOL
    _, tcfg, _, _ = _setup()
    with torch.no_grad():
        t_v = trlhf.critic_values(tr.critic.get_state("params"), tcfg,
                                  torch.from_numpy(tokens).long()).numpy()
    j_v = np.asarray(jrlhf.critic_values(jr.critic.get_state("params"),
                                         jr.cfg, jnp.asarray(tokens)))
    np.testing.assert_allclose(t_v, j_v, atol=ATOL)
    assert np.abs(t_v - tlog["critic_v"][-1]["values"]).max() > 10 * ATOL
    # the reference is still the initial actor, bit for bit, in storage
    # the actor does not share
    _, _, jp, _ = _setup()
    ref = pytree_leaves(tr.reference.get_state("params"))
    for r, p0, a in zip(ref, jax.tree.leaves(jp),
                        pytree_leaves(tr.actor.params())):
        np.testing.assert_array_equal(r.numpy(), p0)
        assert r.data_ptr() != a.data_ptr()
    assert not all(np.array_equal(a.numpy(), p0) for a, p0 in
                   zip(pytree_leaves(tr.actor.params()),
                       jax.tree.leaves(jp)))


def test_rlhf_ppo_four_model_workflow():
    """The JAX test's bar on the port: 12 iterations, a finite value loss
    that drops, the KL anchor live, the 6-node graph schedulable."""
    _, tcfg, _, _ = _setup()
    runner = RLHFRunner(tcfg, PPOConfig(batch_size=16, iterations=12,
                                        max_new_tokens=3), device="cpu")
    stats = runner.run(verbose=False)
    assert len(stats) == 12
    assert all(np.isfinite(s.value_loss) for s in stats)
    assert np.mean([s.value_loss for s in stats[-4:]]) < stats[0].value_loss
    assert "kl_ref" in stats[-1].metrics
    prof = paper_like_profiles()
    tprof = {}
    for name, role in ROLE.items():
        f = {x.name: getattr(prof[role], x.name)
             for x in dataclasses.fields(prof[role])}
        tprof[name] = CostModel(**f)
    t, s = Scheduler(tprof, SchedulerConfig(
        total_batch=64, device_quantum=8)).schedule(runner.graph(), 32, 64)
    assert np.isfinite(t) and s is not None
    runner.teardown()


def test_rlhf_runner_refuses_checkpointing_naming_item_6():
    _, tcfg, _, _ = _setup()
    with pytest.raises(NotImplementedError, match="item 6"):
        RLHFRunner(tcfg, PPOConfig(batch_size=8), device="cpu",
                   checkpoint_dir="ckpt")
