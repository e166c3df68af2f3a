"""The port's embodied PPO workflow (``repro_torch.rl.embodied_workflow``,
``rl.env``, ``SimulatorWorker``, ``RolloutWorker.act``, ``Engine.act``) on
the CPU: the env copy held to the JAX module's code; the JAX package's
env, GAE and cycle-execution cases of ``tests/test_embodied.py`` on the
port; the act path against JAX's under JAX's injected noise; the port's
own act noise under any chunking of the env batch; one iteration of the
runner against JAX's; and the JAX test's learning bar."""
import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.primitives import reset_router as jax_reset_router
from repro.core.profiler import CostModel as JCostModel
from repro.models import model as jmodel
from repro.rl import embodied_workflow as jemb
from repro.rl import env as jenv
from repro.rl import workers as jworkers
from repro.serve.engine import Engine as JEngine
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.comm.primitives import reset_router
from repro_torch.core import (
    Channel,
    CycleSpec,
    ExecutionFlowManager,
    Simulator,
    cycle_node_name,
)
from repro_torch.core.profiler import CostModel
from repro_torch.core.scheduler import Leaf, leaves
from repro_torch.models import model as tmodel
from repro_torch.rl import (
    EmbodiedPPOConfig,
    EmbodiedPPORunner,
    EnvConfig,
    VecReachEnv,
    gae_advantages,
)
from repro_torch.rl import embodied_workflow as temb
from repro_torch.rl import env as tenv
from repro_torch.rl.workers import RolloutWorker
from repro_torch.serve import Engine
from repro_torch.utils.treeutil import pytree_leaves

torch.set_num_threads(1)

LO, HI = temb.ACT_BASE, temb.ACT_BASE + temb.NUM_ACTIONS


@pytest.fixture(autouse=True)
def fresh_state():
    reset_router()
    jax_reset_router()
    Channel.reset_all()
    yield
    reset_router()
    jax_reset_router()
    Channel.reset_all()


def jax_act_noise(seed):
    """The JAX worker's act-path draws as a port ``act_noise_fn``: per env,
    gumbel(fold_in(fold_in(fold_in(PRNGKey(seed ^ 0x5EED), round), step),
    env id)), what ``jax.random.categorical`` adds to the logits."""
    key = jax.random.PRNGKey(seed ^ 0x5EED)

    def fn(rnd, step, ids, V):
        base = jax.random.fold_in(jax.random.fold_in(key, rnd), step)
        keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(
            jnp.asarray(ids, jnp.int32))
        return torch.from_numpy(np.array(jax.vmap(
            lambda k: jax.random.gumbel(k, (V,), jnp.float32))(keys)))

    return fn


def _policy():
    """(jax cfg, port cfg, the JAX actor's params as numpy)."""
    jcfg, tcfg = jemb.default_policy_config(), temb.default_policy_config()
    ja = jworkers.ActorWorker("a/0", cfg=jcfg, hp=jemb.TrainHParams(),
                              seed=0)
    jp = jax.tree.map(np.asarray, ja.params())
    ja.shutdown()
    return jcfg, tcfg, jp


def _obs_chunk(n, seed=0):
    env = VecReachEnv(EnvConfig(num_envs=n), seed=seed)
    return {"prompt_tokens": temb.obs_to_tokens(env.observe()),
            "env_ids": np.arange(n), "cycle_step": 3,
            "rollout_round": np.full(n, 2, np.int64)}


# ---------------------------------------------------------------------------
# the env: a copy of the JAX module
# ---------------------------------------------------------------------------
def _code(module) -> str:
    """The module's AST with every docstring removed."""
    tree = ast.parse(inspect.getsource(module))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def test_env_copy_differs_from_the_jax_module_only_in_docstrings():
    assert _code(tenv) == _code(jenv)


def test_env_step_returns_post_reset_obs_and_terminal_obs():
    env = VecReachEnv(EnvConfig(num_envs=4, max_steps=1), seed=0)
    obs, _, done, info = env.step(np.zeros(4, np.int64))
    assert done.all()
    np.testing.assert_allclose(obs[:, 3], 0.0)
    np.testing.assert_allclose(info["terminal_obs"][:, 3], 1.0)
    np.testing.assert_array_equal(obs, env.observe())


def test_env_splits_terminated_from_truncated():
    env = VecReachEnv(EnvConfig(num_envs=4, max_steps=8, eps=1e9), seed=0)
    _, _, done, info = env.step(np.zeros(4, np.int64))
    assert done.all()
    assert info["terminated"].all() and not info["truncated"].any()
    env = VecReachEnv(EnvConfig(num_envs=4, max_steps=1, eps=1e-9), seed=0)
    _, _, done, info = env.step(np.zeros(4, np.int64))
    assert done.all()
    assert info["truncated"].all() and not info["terminated"].any()


def test_env_subset_stepping_matches_full_batch():
    a = VecReachEnv(EnvConfig(num_envs=8, max_steps=2), seed=3)
    b = VecReachEnv(EnvConfig(num_envs=8, max_steps=2), seed=3)
    rng = np.random.default_rng(0)
    for _ in range(6):
        acts = rng.integers(0, 9, size=8)
        obs_a, rew_a, done_a, _ = a.step(acts)
        o1, r1, d1, _ = b.step(acts[:4], np.arange(4))
        o2, r2, d2, _ = b.step(acts[4:], np.arange(4, 8))
        np.testing.assert_array_equal(obs_a, np.concatenate([o1, o2]))
        np.testing.assert_array_equal(rew_a, np.concatenate([r1, r2]))
        np.testing.assert_array_equal(done_a, np.concatenate([d1, d2]))


def test_gae_truncation_bootstraps_termination_does_not():
    rewards = np.array([[1.0]], np.float32)
    values = np.array([[0.0], [5.0]], np.float32)
    term = np.array([[1.0]], np.float32)
    trunc = np.array([[1.0]], np.float32)
    zeros = np.zeros_like(term)
    adv_term, _ = gae_advantages(rewards, values, gamma=1.0, lam=1.0,
                                 terminated=term, truncated=zeros)
    adv_trunc, _ = gae_advantages(rewards, values, gamma=1.0, lam=1.0,
                                  terminated=zeros, truncated=trunc)
    assert adv_term[0, 0] == pytest.approx(1.0)
    assert adv_trunc[0, 0] == pytest.approx(6.0)
    adv_tv, _ = gae_advantages(rewards, values, gamma=1.0, lam=1.0,
                               terminated=zeros, truncated=trunc,
                               terminal_values=np.array([[2.0]], np.float32))
    assert adv_tv[0, 0] == pytest.approx(3.0)
    r2 = np.array([[1.0], [7.0]], np.float32)
    v2 = np.zeros((3, 1), np.float32)
    adv2, _ = gae_advantages(r2, v2, gamma=1.0, lam=1.0,
                             terminated=np.zeros((2, 1), np.float32),
                             truncated=np.array([[1.0], [0.0]], np.float32))
    assert adv2[0, 0] == pytest.approx(1.0)
    adv_legacy, _ = gae_advantages(rewards, values, term, gamma=1.0, lam=1.0)
    np.testing.assert_allclose(adv_legacy, adv_term)


# ---------------------------------------------------------------------------
# the act path against JAX's
# ---------------------------------------------------------------------------
def test_engine_act_matches_jax_under_jax_noise():
    jcfg, tcfg, jp = _policy()
    chunk = _obs_chunk(16)
    prompts = chunk["prompt_tokens"]
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(7), i))(
        jnp.arange(16, dtype=jnp.int32))
    jt, jl = JEngine(jcfg, max_new_tokens=1).act(
        jax.tree.map(jnp.asarray, jp), prompts, keys, action_lo=LO,
        action_hi=HI)
    noise = np.array(jax.vmap(lambda k: jax.random.gumbel(
        k, (tcfg.padded_vocab,), jnp.float32))(keys))
    eng = Engine(tcfg, device="cpu")
    params = params_from_numpy(jp, device="cpu")
    for arg in (torch.from_numpy(noise), lambda V: torch.from_numpy(noise)):
        tt, tl = eng.act(params, prompts, arg, action_lo=LO, action_hi=HI)
        assert tt.dtype == torch.int32 and tl.dtype == torch.float32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    assert ((tt >= LO) & (tt < HI)).all()
    # more than one action drawn: the noise, not the argmax, decides
    assert len(set(tt.tolist())) > 1


def _act_workers(seed=5):
    jcfg, tcfg, jp = _policy()
    kw = dict(max_new_tokens=1, engine="static", seed=seed,
              action_range=(LO, HI))
    jw = jworkers.RolloutWorker("policy_gen/0", cfg=jcfg, **kw)
    tw = RolloutWorker("policy_gen/0", cfg=tcfg, device="cpu", **kw)
    jw.update_weights(jax.tree.map(jnp.asarray, jp))
    tw.update_weights(params_from_numpy(jp, device="cpu"))
    return jw, tw


def test_rollout_worker_act_matches_jax_under_jax_noise():
    jw, tw = _act_workers()
    tw.act_noise_fn = jax_act_noise(5)
    chunk = _obs_chunk(16, seed=1)
    jo, to = jw.act(dict(chunk)), tw.act(dict(chunk))
    for k in ("action_tokens", "actions"):
        np.testing.assert_array_equal(to[k], np.asarray(jo[k]), err_msg=k)
    np.testing.assert_allclose(to["action_logprobs"],
                               np.asarray(jo["action_logprobs"]), atol=1e-5)
    assert to["action_tokens"].dtype == np.int32
    jw.shutdown()
    tw.shutdown()


def test_port_act_noise_is_the_same_under_any_chunking_of_the_env_batch():
    _, tw = _act_workers()
    chunk = _obs_chunk(16, seed=2)
    full = tw.act(dict(chunk))
    parts = [tw.act({k: (v[sl] if isinstance(v, np.ndarray) else v)
                     for k, v in chunk.items()})
             for sl in (slice(0, 5), slice(5, 6), slice(6, 16))]
    for k in ("action_tokens", "action_logprobs"):
        np.testing.assert_array_equal(
            full[k], np.concatenate([p[k] for p in parts]), err_msg=k)
    # the round and the step each change the draw
    other = tw.act(dict(chunk, cycle_step=4))
    later = tw.act(dict(chunk, rollout_round=np.full(16, 3, np.int64)))
    assert not np.array_equal(other["action_tokens"], full["action_tokens"])
    assert not np.array_equal(later["action_tokens"], full["action_tokens"])
    tw.shutdown()


def test_act_needs_the_static_engine_and_engine_takes_no_sampling_settings():
    """A paged worker acts through a hidden static engine of one new token
    (as JAX's does), drawing what a static worker draws; ``Engine`` keeps
    JAX's generation settings, which act does not read."""
    _, tcfg, jp = _policy()
    chunk = _obs_chunk(4)
    out = {}
    for kind in ("paged", "static"):
        w = RolloutWorker("policy_gen/0", cfg=tcfg, engine=kind,
                          action_range=(LO, HI), device="cpu")
        w.update_weights(params_from_numpy(jp, device="cpu"))
        out[kind] = w.act(dict(chunk))
        w.shutdown()
    for k in ("action_tokens", "action_logprobs", "actions"):
        np.testing.assert_array_equal(out["paged"][k], out["static"][k],
                                      err_msg=k)
    kw = dict(max_new_tokens=3, temperature=0.5, top_k=4, top_p=0.8,
              eos_token=7, pad_token=1)
    eng = Engine(tcfg, device="cpu", **kw)
    assert (eng.max_new_tokens, eng.temperature, eng.top_k, eng.top_p,
            eng.eos, eng.pad) == tuple(kw.values())
    params = params_from_numpy(jp, device="cpu")
    prompts = chunk["prompt_tokens"]
    noise = torch.zeros((prompts.shape[0], tcfg.padded_vocab))
    a = eng.act(params, prompts, noise, action_lo=LO, action_hi=HI)
    b = Engine(tcfg, device="cpu").act(params, prompts, noise, action_lo=LO,
                                       action_hi=HI)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# cycle execution on the port's runner (tests/test_embodied.py's cases)
# ---------------------------------------------------------------------------
def tiny_runner(mode: str, **kw) -> EmbodiedPPORunner:
    cfg = dict(num_envs=8, horizon=4, iterations=1, mode=mode, seed=0,
               profile_batches=(4, 8))
    cfg.update(kw)
    return EmbodiedPPORunner(EmbodiedPPOConfig(**cfg), device="cpu")


def run_one(runner: EmbodiedPPORunner):
    runner.profile()
    runner.plan_execution()
    runner._sync_weights()
    return runner.controller.execute(
        runner.plan, runner.workers, runner.task_fns, runner.make_batch(),
        cycle_specs=runner.cycle_specs())


def test_cycle_realizations_produce_identical_trajectories():
    out_c = run_one(tiny_runner("collocated"))
    out_h = run_one(tiny_runner("hybrid"))
    for k in ("action_tokens", "rewards", "terminated", "truncated",
              "obs", "terminal_obs", "tokens", "dones"):
        np.testing.assert_array_equal(
            np.asarray(out_c[k]), np.asarray(out_h[k]), err_msg=k)
    np.testing.assert_allclose(out_c["action_logprobs"],
                               out_h["action_logprobs"], atol=1e-5)
    assert out_c["successes"] == out_h["successes"]


def test_forced_modes_recorded_on_leaf_and_honored_by_executor():
    for mode in ("collocated", "hybrid"):
        runner = tiny_runner(mode)
        run_one(runner)
        cyc = [lf for lf in leaves(runner.plan.schedule)
               if lf.worker.startswith("cycle(")]
        assert len(cyc) == 1
        assert cyc[0].cycle_mode == mode
        log = runner.controller.last_cycle_log
        assert len(log) == 1
        node, ran_mode, member_devices, chunks = log[0]
        assert ran_mode == mode
        assert member_devices == cyc[0].member_devices
        if mode == "hybrid":
            assert member_devices is not None
            assert sum(member_devices) <= cyc[0].devices
            assert chunks == cyc[0].cycle_chunks


def test_executor_honors_leaf_not_rederivation():
    runner = tiny_runner("auto")
    runner.profile()
    runner.plan_execution()
    name = cycle_node_name(("policy_gen", "simulator"))
    members = {name: ("policy_gen", "simulator")}
    for leaf, want in (
            (Leaf(name, 4, 8, cycle_mode="collocated"), "collocated"),
            (Leaf(name, 4, 8, cycle_mode="hybrid",
                  member_devices=(2, 2)), "hybrid")):
        mgr = ExecutionFlowManager(runner.workers, runner.task_fns,
                                   members=members,
                                   cycle_specs=runner.cycle_specs())
        out = mgr.run(leaf, runner.make_batch())
        assert mgr.cycle_log[0][1] == want
        assert out["rewards"].shape == (runner.rl.horizon, 8)


def test_cycle_placement_binds_member_workers():
    r_h = tiny_runner("hybrid")
    r_h.profile()
    r_h.plan_execution()
    pl = r_h.plan.placement
    assert "policy_gen" in pl and "simulator" in pl
    assert not set(pl["policy_gen"]) & set(pl["simulator"])
    r_c = tiny_runner("collocated")
    r_c.profile()
    r_c.plan_execution()
    pl = r_c.plan.placement
    assert pl["policy_gen"] == pl["simulator"]


def test_simulator_replays_recorded_realization():
    profiles = {
        "sim": CostModel("sim", base_time=1.0, scalable=False,
                         max_useful_devices=1),
        "gen": CostModel("gen", base_time=0.0, slope_time=0.01),
    }
    members = {"cycle(gen+sim)": ("gen", "sim")}
    sim = Simulator(profiles, members)
    col = Leaf("cycle(gen+sim)", 4, 16, cycle_mode="collocated")
    hyb = Leaf("cycle(gen+sim)", 4, 16, cycle_mode="hybrid",
               member_devices=(3, 1), cycle_chunks=2)
    t_col = sim.run(col, 16).makespan
    t_hyb = sim.run(hyb, 16).makespan
    assert t_hyb > t_col
    assert t_col == pytest.approx(1.0 + 0.01 * 16 / 4)


def test_cycle_specs_match_jax():
    t = temb.embodied_cycle_specs(horizon=5, chunks=3)
    j = jemb.embodied_cycle_specs(horizon=5, chunks=3)
    assert list(t) == list(j)
    for name in t:
        assert isinstance(t[name], CycleSpec)
        assert (t[name].order, t[name].steps, t[name].prime,
                t[name].chunks) == (j[name].order, j[name].steps,
                                    j[name].prime, j[name].chunks)
    assert temb.VOCAB == jemb.VOCAB and temb.SEQ == jemb.SEQ
    obs = VecReachEnv(EnvConfig(num_envs=6), seed=4).observe()
    np.testing.assert_array_equal(temb.obs_to_tokens(obs),
                                  jemb.obs_to_tokens(obs))


# ---------------------------------------------------------------------------
# one iteration against the JAX runner
# ---------------------------------------------------------------------------
def _fixed_profiles(cls):
    return {"simulator": cls("simulator", base_time=0.2, scalable=False,
                             max_useful_devices=1),
            "policy_gen": cls("policy_gen", base_time=0.05,
                              slope_time=0.002),
            "advantage": cls("advantage", base_time=0.001),
            "train": cls("train", base_time=0.1, slope_time=0.001)}


def test_one_iteration_matches_jax_under_jax_noise():
    """Actions, rewards, the terminated/truncated split and advantages
    equal, behaviour logprobs within 1e-5, the policy after the update
    within 2 lr of JAX's, and the trajectory's action logprobs under both
    final policies within 1e-4, which holds the update itself (as the
    GRPO runner's parity test)."""
    kw = dict(num_envs=8, horizon=6, iterations=1, mode="collocated",
              seed=0, max_steps=4, profile_batches=(8,))
    jr = jemb.EmbodiedPPORunner(jemb.EmbodiedPPOConfig(**kw))
    jp = jax.tree.map(np.asarray, jr.actor.params())
    tr = EmbodiedPPORunner(EmbodiedPPOConfig(**kw), device="cpu",
                           params=params_from_numpy(jp, device="cpu"))
    tr.policy.act_noise_fn = jax_act_noise(0)
    outs = []
    for r, cls in ((jr, JCostModel), (tr, CostModel)):
        r.controller.profiles = _fixed_profiles(cls)
        r.plan_execution()
        r._sync_weights()
        outs.append(r.controller.execute(
            r.plan, r.workers, r.task_fns, r.make_batch(),
            cycle_specs=r.cycle_specs()))
    jo, to = outs
    assert repr(tr.plan.schedule) == repr(jr.plan.schedule)
    for k in ("action_tokens", "actions", "rewards", "terminated",
              "truncated", "tokens", "advantages", "loss_mask"):
        np.testing.assert_array_equal(np.asarray(to[k]), np.asarray(jo[k]),
                                      err_msg=k)
    assert np.asarray(to["terminated"]).any() or \
        np.asarray(to["truncated"]).any()
    np.testing.assert_allclose(to["action_logprobs"], jo["action_logprobs"],
                               atol=1e-5)
    lr = tr.rl.lr
    moved = []
    for g, w, p0 in zip(pytree_leaves(params_to_numpy(tr.actor.params())),
                        jax.tree.leaves(jax.tree.map(np.asarray,
                                                     jr.actor.params())),
                        jax.tree.leaves(jp)):
        np.testing.assert_allclose(g, w, atol=2 * lr, rtol=0)
        moved.append(np.abs(g - p0).max())
    assert max(moved) > 0.5 * lr
    # the update scores the trajectory's actions alike under both final
    # policies, and differently from the policy that drew them (so a
    # wrong or missing step shows)
    tokens = np.asarray(to["tokens"])

    def action_lps(logits):
        lp = np.asarray(logits, np.float32)[:, -2, LO:HI]
        lp = lp - np.log(np.exp(lp - lp.max(-1, keepdims=True)).sum(
            -1, keepdims=True)) - lp.max(-1, keepdims=True)
        return np.take_along_axis(lp, tokens[:, -1:] - LO, -1)[:, 0]

    with torch.no_grad():
        t_lp = action_lps(tmodel.forward(tr.actor.params(), tr.model_cfg,
                                         torch.from_numpy(tokens).long())[0])
    j_lp = action_lps(jmodel.forward(jr.actor.params(), jr.model_cfg,
                                     jnp.asarray(tokens))[0])
    np.testing.assert_allclose(t_lp, j_lp, atol=1e-4)
    before = np.asarray(to["action_logprobs"]).reshape(-1)
    assert np.abs(t_lp - before).max() > 10 * 1e-4
    for k, v in tr.actor.metrics_history[-1].items():
        np.testing.assert_allclose(v, jr.actor.metrics_history[-1][k],
                                   atol=1e-6, rtol=1e-4, err_msg=k)


def test_embodied_runner_learns_above_random():
    rl = EmbodiedPPOConfig(num_envs=32, horizon=12, iterations=30,
                           mode="auto", seed=0, profile_batches=(16, 32))
    runner = EmbodiedPPORunner(rl, device="cpu")
    runner.run(verbose=False)
    curve = runner.success_curve()
    first = float(np.mean(curve[:5]))
    last = float(np.mean(curve[-10:]))
    assert last > first + 0.1, (first, last)
    assert last > 0.2, last


def test_embodied_runner_refuses_checkpointing_naming_item_6(tmp_path):
    with pytest.raises(NotImplementedError, match="item 6"):
        tiny_runner("collocated", checkpoint_dir=str(tmp_path / "ck"),
                    checkpoint_every=1)
