"""The port's GRPO workers (``repro_torch.rl.workers``) on the CPU against
the JAX package's, on the same chunk (made from a seed with numpy) and
the same bridged weights, on reduced yi-9b and on the quickstart's tiny
config: rollout tokens (at temperature 0, and above it with the JAX
engine's noise and base seeds injected), recomputed logprobs, rewards and
advantages, one train step; then the port's own state handling:
offload/onload, the weight sync as a copy, and the errors that name the
ROADMAP items left out (checkpointing, strict lint)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.primitives import reset_router as jax_reset_router
from repro.configs import get_config as jax_get_config
from repro.rl import workers as jworkers
from repro.train import data as jdata
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.trainer import TrainHParams as JTrainHParams
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.comm.primitives import reset_router
from repro_torch.configs import get_config
from repro_torch.core import Channel
from repro_torch.rl import GRPOConfig, GRPORunner
from repro_torch.rl.workers import (
    ActorWorker,
    InferenceWorker,
    RewardWorker,
    RolloutWorker,
)
from repro_torch.train import data as tdata
from repro_torch.train import AdamWConfig, TrainHParams, policy_loss
from repro_torch.utils.treeutil import pytree_leaves, tree_leaves, tree_map

torch.set_num_threads(1)

# the recompute's tolerance in tests/test_torch_train.py (f32, another
# summation order)
LP_ATOL = 1e-4
LR = 1e-3
# |grad| above which its sign is sure: ten times the gradient atol of
# tests/test_torch_train.py
GRAD_FLOOR = 1e-5
QUICKSTART = dict(vocab_size=32, d_model=128, num_heads=4, num_kv_heads=2,
                  d_ff=256)
CONFIGS = {"yi-9b-reduced": {}, "quickstart": QUICKSTART}
GROUP, QUERIES, PROMPT_LEN = 4, 4, 8


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
def _setup(name):
    """(jax cfg, port cfg, jax params as the JAX actor draws them)."""
    jcfg = jax_get_config("yi-9b").reduced().replace(**CONFIGS[name])
    tcfg = get_config("yi-9b").reduced().replace(**CONFIGS[name])
    jactor = jworkers.ActorWorker(
        "actor/0", cfg=jcfg, hp=JTrainHParams(), seed=0)
    jp = jax.tree.map(np.asarray, jactor.params())
    jactor.shutdown()
    return jcfg, tcfg, jp


def _bridge(jp):
    return params_from_numpy(jp, device="cpu")


def _chunk(seed=0):
    """One GRPO chunk: QUERIES prompts, each repeated GROUP times, from
    both packages' datasets (which must agree)."""
    j = jdata.PromptDataset(QUERIES, prompt_len=PROMPT_LEN, seed=seed)
    t = tdata.PromptDataset(QUERIES, prompt_len=PROMPT_LEN, seed=seed)
    jb, tb = j.next_batch(), t.next_batch()
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
    return {k: np.repeat(v, GROUP, axis=0) for k, v in tb.items()}


def jax_base_seeds(seed, n, process_index=0):
    """The base seeds a JAX RolloutWorker draws in its first ``n``
    generate calls (split its key, randint the half)."""
    key = jax.random.PRNGKey(seed + process_index)
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(int(jax.random.randint(sub, (), 0, 2**31 - 1)))
    return out


def jax_noise(seeds, positions, V):
    """The JAX engine's own per-request Gumbel draws, as numpy."""
    keys = jax.vmap(lambda s, p: jax.random.fold_in(jax.random.PRNGKey(s),
                                                    p))(
        jnp.asarray(seeds.cpu().numpy(), jnp.int32),
        jnp.asarray(positions.cpu().numpy(), jnp.int32))
    return np.array(jax.vmap(
        lambda k: jax.random.gumbel(k, (V,), jnp.float32))(keys))


def _rollouts(name, temperature, calls=1, **kw):
    """Both packages' rollout workers over ``calls`` chunks; the port's
    fed the JAX worker's base seeds (and its noise above temperature 0)."""
    jcfg, tcfg, jp = _setup(name)
    jw = jworkers.RolloutWorker("rollout/0", cfg=jcfg, max_new_tokens=6,
                                temperature=temperature, seed=0, **kw)
    tw = RolloutWorker("rollout/0", cfg=tcfg, max_new_tokens=6,
                       temperature=temperature, seed=0, device="cpu", **kw)
    jw.update_weights(jax.tree.map(jnp.asarray, jp), version=1)
    tw.update_weights(_bridge(jp), version=1)
    tw.seeds = iter(jax_base_seeds(0, calls))
    if temperature > 0:
        tw.engine.layout.noise_fn = jax_noise
    outs = []
    for c in range(calls):
        chunk = _chunk(c)
        outs.append((jw.generate(chunk), tw.generate(chunk)))
    jw.shutdown()
    tw.shutdown()
    return outs


def _assert_same_rollout(jo, to):
    np.testing.assert_array_equal(to["tokens"], np.asarray(jo["tokens"]))
    np.testing.assert_array_equal(to["lengths"], np.asarray(jo["lengths"]))
    np.testing.assert_array_equal(to["weight_versions"],
                                  np.asarray(jo["weight_versions"]))
    np.testing.assert_allclose(to["logprobs"], np.asarray(jo["logprobs"]),
                               atol=LP_ATOL)


# ---------------------------------------------------------------------------
# rollout, inference, reward, actor against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", CONFIGS)
def test_rollout_matches_jax_at_temp0(name):
    (jo, to), = _rollouts(name, 0.0)
    _assert_same_rollout(jo, to)
    assert (to["weight_versions"] == 1).all()


@pytest.mark.parametrize("name", CONFIGS)
def test_rollout_with_jax_noise_and_seeds_matches_jax(name):
    outs = _rollouts(name, 1.0, calls=2, top_k=8, top_p=0.9)
    for jo, to in outs:
        _assert_same_rollout(jo, to)
    # the two calls drew different base seeds: different samples
    assert not np.array_equal(outs[0][1]["tokens"][:, PROMPT_LEN:],
                              outs[1][1]["tokens"][:, PROMPT_LEN:])


def test_rollout_seed_stream_is_seeded_and_replaceable():
    _, tcfg, jp = _setup("quickstart")
    ws = [RolloutWorker(f"r/{i}", cfg=tcfg, max_new_tokens=4, seed=3,
                        process_index=i, device="cpu") for i in (0, 0, 1)]
    firsts = [next(w.seeds) for w in ws]
    assert firsts[0] == firsts[1] != firsts[2]
    assert next(ws[0].seeds) != firsts[0]
    w = ws[0]
    w.update_weights(_bridge(jp))
    w.seeds = iter([5, 5])
    chunk = _chunk()
    a, b = w.generate(chunk), w.generate(chunk)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("name", CONFIGS)
def test_inference_and_reward_match_jax(name):
    jcfg, tcfg, jp = _setup(name)
    (jo, _), = _rollouts(name, 1.0)
    chunk = {k: np.asarray(v) for k, v in jo.items()}
    ji = jworkers.InferenceWorker("inference/0", cfg=jcfg)
    ti = InferenceWorker("inference/0", cfg=tcfg, device="cpu")
    ji.update_weights(jax.tree.map(jnp.asarray, jp))
    ti.update_weights(_bridge(jp))
    jc, tc = ji.compute_logprobs(chunk), ti.compute_logprobs(chunk)
    np.testing.assert_allclose(tc["old_logprobs"],
                               np.asarray(jc["old_logprobs"]), atol=LP_ATOL)
    # explicit params score without touching the registered ones
    other = _bridge(jax.tree.map(lambda a: a * 0.5, jp))
    t2 = ti.compute_logprobs(chunk, key="target_logprobs", params=other)
    assert not np.allclose(t2["target_logprobs"], tc["old_logprobs"])
    assert "old_logprobs" not in t2
    assert ti.get_state("params") is not other
    jr = jworkers.RewardWorker("reward/0", prompt_len=PROMPT_LEN,
                               group_size=GROUP)
    tr = RewardWorker("reward/0", prompt_len=PROMPT_LEN, group_size=GROUP)
    # a few right answers, so some groups have non-zero advantages
    toks = np.array(tc["tokens"])
    for i in range(0, toks.shape[0], 3):
        ans = jdata.encode_digits(int(chunk["answers"][i])) + [jdata.EOS]
        toks[i, PROMPT_LEN:PROMPT_LEN + len(ans)] = ans
    tc["tokens"] = toks
    jrw, trw = jr.score(dict(tc)), tr.score(dict(tc))
    for k in ("rewards", "loss_mask", "advantages"):
        np.testing.assert_array_equal(trw[k], np.asarray(jrw[k]))
    assert (trw["rewards"] > 0).any() and np.abs(trw["advantages"]).max() > 0


def _train_chunk(tcfg, seed=1, B=8, S=14):
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, S), np.float32)
    mask[:, PROMPT_LEN:] = 1.0
    return {
        "tokens": rng.integers(3, tcfg.vocab_size, (B, S)).astype(np.int32),
        "old_logprobs": (-rng.random((B, S)) * 4).astype(np.float32) * mask,
        "advantages": (rng.standard_normal((B, 1)) * mask).astype(
            np.float32),
        "loss_mask": mask,
    }


def _policy_grads(tcfg, hp, jp, chunk):
    """The port's policy-loss gradient at the bridged params, as numpy
    leaves in ``pytree_leaves`` order."""
    params = tree_map(lambda t: t.requires_grad_(), _bridge(jp))
    batch = {"tokens": torch.tensor(chunk["tokens"], dtype=torch.long)}
    for k in ("old_logprobs", "advantages", "loss_mask"):
        batch[k] = torch.tensor(chunk[k], dtype=torch.float32)
    loss, _ = policy_loss(tcfg, hp, params, batch)
    return [g.numpy() for g in torch.autograd.grad(loss, tree_leaves(params))]


@pytest.mark.parametrize("name", CONFIGS)
def test_actor_train_step_matches_jax(name):
    """One step from the JAX actor's own init: metrics tightly, and the
    update p - p0 within 0.1 % of JAX's wherever the gradient is clear of
    rounding (|g| > GRAD_FLOOR, ten times the gradient tolerance of
    tests/test_torch_train.py).  There Adam's first step is
    lr * g / (|g| + eps), so a step of the wrong sign or size fails;
    where g ~ 0 to rounding its sign may flip, and those elements are
    left out."""
    jcfg, tcfg, jp = _setup(name)
    jhp = JTrainHParams(optimizer=JAdamWConfig(lr=LR), entropy_coef=0.01)
    thp = TrainHParams(optimizer=AdamWConfig(lr=LR), entropy_coef=0.01)
    ja = jworkers.ActorWorker("actor/0", cfg=jcfg, hp=jhp, seed=0)
    ta = ActorWorker("actor/0", cfg=tcfg, hp=thp, params=_bridge(jp),
                     device="cpu")
    chunk = _train_chunk(tcfg)
    jm, tm = ja.train(chunk)["metrics"], ta.train(chunk)["metrics"]
    assert tm.keys() == jm.keys()
    for k in tm:
        np.testing.assert_allclose(tm[k], jm[k], atol=1e-6, rtol=1e-4,
                                   err_msg=k)
    got = pytree_leaves(params_to_numpy(ta.params()))
    want = jax.tree.leaves(jax.tree.map(np.asarray, ja.params()))
    grads = _policy_grads(tcfg, thp, jp, chunk)
    clear = total = 0
    moved = []
    for g, w, p0, gr in zip(got, want, jax.tree.leaves(jp), grads):
        sure = np.abs(gr) > GRAD_FLOOR
        np.testing.assert_allclose((g - p0)[sure], (w - p0)[sure],
                                   rtol=1e-3, atol=1e-3 * LR)
        clear, total = clear + sure.sum(), total + (gr != 0).sum()
        moved.append(np.abs(g - p0).max())
    # most elements with a gradient are held to JAX's update
    assert clear > 0.5 * total, (clear, total)
    assert max(moved) > 0.5 * LR  # the step really moved the params
    assert ta.get_state("opt").step == int(ja.get_state("opt").step) == 1


def test_actor_draws_its_own_params_from_its_seed():
    _, tcfg, _ = _setup("quickstart")
    hp = TrainHParams()
    a, b, c = (ActorWorker(f"a/{i}", cfg=tcfg, hp=hp, seed=s, device="cpu")
               for i, s in enumerate((0, 0, 1)))
    la, lb, lc = (pytree_leaves(w.params()) for w in (a, b, c))
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not all(torch.equal(x, y) for x, y in zip(la, lc))
    assert all(x.dtype == torch.float32 for x in la)


# ---------------------------------------------------------------------------
# the port's own state handling
# ---------------------------------------------------------------------------
def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in pytree_leaves(tree)
               if isinstance(t, torch.Tensor))


def test_actor_offload_onload_round_trip_bit_for_bit():
    _, tcfg, jp = _setup("quickstart")
    ta = ActorWorker("actor/0", cfg=tcfg, hp=TrainHParams(), device="cpu",
                     params=_bridge(jp))
    ta.train(_train_chunk(tcfg))  # non-zero moments
    params, opt = ta._state["params"], ta._state["opt"]
    p_bytes, o_bytes = _nbytes(params), _nbytes(opt)
    assert ta.state_bytes() == p_bytes + o_bytes
    p_before = [t.clone() for t in pytree_leaves(params)]
    o_before = [t.clone() if isinstance(t, torch.Tensor) else t
                for t in pytree_leaves(opt)]
    # the optimizer state alone: params stay put, the same tensors
    assert ta.offload(keys=("opt",)) == ("opt",)
    assert ta.state_bytes() == p_bytes
    assert ta._state["params"] is params
    assert all(torch.equal(a, b)
               for a, b in zip(pytree_leaves(params), p_before))
    host = ta._host_state["opt"]
    assert host.step == opt.step
    assert all(h.device.type == "cpu" and h.data_ptr() != o.data_ptr()
               for h, o in zip(pytree_leaves(host.mu), pytree_leaves(opt.mu)))
    assert ta.offload() == ("params",)
    assert ta.state_bytes() == 0
    assert set(ta.onload()) == {"opt", "params"}
    assert ta.state_bytes() == p_bytes + o_bytes
    for a, b in zip(pytree_leaves(ta._state["params"]), p_before):
        assert torch.equal(a, b) and a.device == ta.device
    for a, b in zip(pytree_leaves(ta._state["opt"]), o_before):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    ta.train(_train_chunk(tcfg, seed=2))  # the onloaded state trains on


def test_rollout_offload_releases_the_engines_weights():
    _, tcfg, jp = _setup("quickstart")
    tw = RolloutWorker("rollout/0", cfg=tcfg, max_new_tokens=3,
                       device="cpu")
    tw.update_weights(_bridge(jp), version=4)
    tw.generate(_chunk())
    assert tw.engine.params is tw._state["params"]
    tw.update_weights(_bridge(jp), version=5)  # pending at the offload
    assert tw.offload() == ("params",)
    assert tw.engine.params is None and tw.engine.weight_version == 5
    out = tw.generate(_chunk())  # onloads, hands the engine its weights
    assert (out["weight_versions"] == 5).all()
    assert tw.engine.params is tw._state["params"]


def _tiny_runner(**kw):
    _, tcfg, jp = _setup("quickstart")
    rl = GRPOConfig(batch_size=8, group_size=4, iterations=1,
                    max_new_tokens=3, mode="collocated", seed=0,
                    profile_batches=(4, 8), **kw)
    return GRPORunner(tcfg, rl, TrainHParams(optimizer=AdamWConfig(lr=LR)),
                      device="cpu", params=_bridge(jp))


def test_weight_sync_copies_into_the_targets_own_tensors():
    runner = _tiny_runner()
    dt = runner._sync_weights()
    assert dt >= 0.0 and runner.sync_stats["syncs"] == 1
    actor = pytree_leaves(runner.actor.params())
    targets = {n: pytree_leaves(runner.workers[n].get_state("params"))
               for n in ("rollout", "inference")}
    for leaves in targets.values():
        for a, t in zip(actor, leaves):
            assert torch.equal(a, t) and a.data_ptr() != t.data_ptr()
    assert runner.sync_stats["bytes"] == 2 * sum(
        t.numel() * t.element_size() for t in actor)
    kept = {n: [t.clone() for t in ls] for n, ls in targets.items()}
    # a second sync writes into the same tensors
    runner._sync_weights()
    for n, ls in targets.items():
        now = pytree_leaves(runner.workers[n].get_state("params"))
        assert all(a is b for a, b in zip(now, ls))
    # the actor's next in-place step leaves the synced weights alone
    chunk = _train_chunk(runner.model_cfg)
    runner.actor.train(chunk)
    assert not all(torch.equal(a, k)
                   for a, k in zip(pytree_leaves(runner.actor.params()),
                                   kept["rollout"]))
    for n, ls in targets.items():
        assert all(torch.equal(t, k) for t, k in zip(ls, kept[n])), n
    # and the async horizon's published snapshot too
    snap = runner.snapshot_params()
    snap_kept = [t.clone() for t in pytree_leaves(snap)]
    runner.actor.train(_train_chunk(runner.model_cfg, seed=3))
    assert all(torch.equal(t, k)
               for t, k in zip(pytree_leaves(snap), snap_kept))


def test_sync_into_an_offloaded_target_replaces_its_host_copy():
    runner = _tiny_runner()
    runner._sync_weights()
    inf = runner.workers["inference"]
    inf.offload()
    runner.actor.train(_train_chunk(runner.model_cfg))
    runner._sync_weights()
    assert not inf.offloaded
    for a, t in zip(pytree_leaves(runner.actor.params()),
                    pytree_leaves(inf.get_state("params"))):
        assert torch.equal(a, t) and a.data_ptr() != t.data_ptr()


def test_left_out_items_raise_naming_their_roadmap_item():
    _, tcfg, _ = _setup("quickstart")
    rl = GRPOConfig(batch_size=8, group_size=4, iterations=1)
    with pytest.raises(NotImplementedError, match="item 6"):
        GRPORunner(tcfg, rl, device="cpu", checkpoint_dir="ckpt")
    with pytest.raises(NotImplementedError, match="item 6"):
        GRPORunner(tcfg, rl, device="cpu", fault_injector=object())
    from repro_torch.core import Cluster, Controller
    with pytest.raises(NotImplementedError, match="item 11"):
        Controller(Cluster(), strict=True)
