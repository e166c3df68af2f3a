"""The port's full-sequence forward, logprob recompute, policy loss, AdamW
and train step (on the CPU) against the JAX package, from the same
bridged weights and inputs made from a seed with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.models import attention as jattn
from repro import train as jtrain
from repro.configs import get_config as jax_get_config
from repro.rl import advantage as jadv
from repro.train import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.bridge import (
    opt_state_from_numpy,
    opt_state_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.models import attention as tattn
from repro_torch.models import forward
from repro_torch.rl import advantage as tadv
from repro_torch.serve import PagedEngine
from repro_torch.train import (
    AdamWConfig,
    TrainHParams,
    adamw_update,
    init_adamw,
    lm_loss,
    make_prefill_step,
    make_train_step,
    policy_loss,
)
from repro_torch.train import optimizer as topt
from repro_torch.utils.treeutil import global_norm, tree_leaves, tree_map

# one intra-op thread: the test workers share the host's cores, and more
# threads in each oversubscribe them (the port's files take ~78 s under
# -n 6 with torch's default threads, ~50 s with one)
torch.set_num_threads(1)


DENSE = ["yi-9b", "qwen2.5-7b", "stablelm-12b", "codeqwen1.5-7b"]
# f32 end to end: the same math in another summation order
LOGIT_TOL = 1e-4


# one compiled init per config: eager init compiles op by op, ~2x slower
_jinit = jax.jit(jmodels.init_model, static_argnums=1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bridge(jparams):
    return params_from_numpy(_np(jparams), device="cpu")


def _flat(tree):
    """{'/a/b': leaf} for a nested dict (torch or numpy leaves)."""
    out = {}

    def rec(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                rec(f"{prefix}/{k}", v)
            else:
                out[f"{prefix}/{k}"] = np.asarray(
                    v.detach().float() if isinstance(v, torch.Tensor) else v)
    rec("", tree)
    return out


def _close_trees(got, want, **tol):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in g:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)


def tiny_cfg(name="yi-9b"):
    kw = dict(vocab_size=64, d_model=64, num_heads=4, num_kv_heads=2,
              head_dim=16, d_ff=128)
    return (jax_get_config(name).reduced().replace(**kw),
            tconfigs.get_config(name).reduced().replace(**kw))


def _rl_batch(rng, B, S, vocab, ref=False):
    tokens = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    mask = np.zeros((B, S), np.float32)
    mask[:, S // 2:] = 1.0
    batch = {
        "tokens": tokens,
        "old_logprobs": (-3.0 + 0.3 * rng.standard_normal((B, S))).astype(
            np.float32),
        "advantages": rng.standard_normal((B, S)).astype(np.float32) * mask,
        "loss_mask": mask,
    }
    if ref:
        batch["ref_logprobs"] = (-3.0 + 0.3 * rng.standard_normal(
            (B, S))).astype(np.float32)
    return batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", DENSE)
def test_forward_matches_jax(name, use_kernel):
    """Reduced configs (2 layers, d 256, GQA, qkv bias, qk-norm) from the
    same weights: the port's logits against JAX's sdpa path and its
    Pallas path (interpret)."""
    jcfg = jax_get_config(name).reduced()
    tcfg = tconfigs.get_config(name).reduced()
    jp = _jinit(jax.random.PRNGKey(1), jcfg)
    tokens = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, size=(2, 64)).astype(np.int32)
    want, want_aux = jax.jit(lambda p, t: jmodels.forward(
        p, jcfg, t, use_kernel=use_kernel))(jp, jnp.asarray(tokens))
    got, aux = forward(_bridge(jp), tcfg, torch.from_numpy(tokens).long())
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert float(aux) == float(want_aux) == 0.0


def test_forward_remat_and_hidden():
    """remat recomputes each layer in the backward and changes nothing;
    return_hidden gives JAX's final hidden state."""
    jcfg, tcfg = tiny_cfg()
    jp = _jinit(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(0).integers(0, 64, size=(2, 20))
    _, _, want_h = jax.jit(lambda p, t: jmodels.forward(
        p, jcfg, t, return_hidden=True))(jp, jnp.asarray(tokens))
    out = []
    for remat in (False, True):
        params = tree_map(lambda t: t.requires_grad_(), _bridge(jp))
        logits, _, h = forward(params, tcfg, torch.from_numpy(tokens),
                               remat=remat, return_hidden=True)
        grads = torch.autograd.grad(logits.square().mean(),
                                    tree_leaves(params))
        out.append((logits.detach(), h.detach(), grads))
    np.testing.assert_allclose(out[0][1].numpy(), np.asarray(want_h),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    torch.testing.assert_close(out[0][0], out[1][0], atol=0, rtol=0)
    for a, b in zip(out[0][2], out[1][2]):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("Sq,Sk,window", [(5, 5, 0), (3, 8, 0), (6, 6, 2),
                                          (4, 9, 3)])
def test_causal_mask_matches_jax(Sq, Sk, window):
    got = tattn.causal_mask(Sq, Sk, window)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jattn.causal_mask(Sq, Sk, window)))


def test_forward_ports_the_dense_kind_only():
    """``forward`` ports every kind, the VLM and encoder-decoder ones
    among them: at the tiny widths of this file (64 wide, heads of 16)
    their logits are JAX's, with and without remat, from the embeddings
    in ``extra``."""
    for arch, key, n in (("llama-3.2-vision-90b", "image_embeds", 16),
                         ("whisper-large-v3", "frame_embeds", 32)):
        jcfg, tcfg = tiny_cfg(arch)
        jp = _jinit(jax.random.PRNGKey(0), jcfg)
        if "cross_layers" in jp:  # tanh(0) would skip the cross layers
            jp["cross_layers"]["gate"] = jnp.full_like(
                jp["cross_layers"]["gate"], 0.5)
        rng = np.random.default_rng(4)
        tokens = rng.integers(0, 64, size=(2, 10)).astype(np.int32)
        emb = rng.standard_normal((2, n, 64)).astype(np.float32)
        want, _ = jax.jit(lambda p, t, e: jmodels.forward(
            p, jcfg, t, {key: e}))(jp, jnp.asarray(tokens), jnp.asarray(emb))
        for remat in (False, True):
            got, aux = forward(_bridge(jp), tcfg,
                               torch.from_numpy(tokens).long(),
                               {key: torch.from_numpy(emb)}, remat=remat)
            assert float(aux) == 0.0
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL)


# ---------------------------------------------------------------------------
# logprob recompute
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["yi-9b", "qwen2.5-7b"])
def test_prefill_step_matches_jax(name):
    jcfg = jax_get_config(name).reduced()
    tcfg = tconfigs.get_config(name).reduced()
    jp = _jinit(jax.random.PRNGKey(3), jcfg)
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, size=(3, 37)).astype(np.int32)
    want = jax.jit(jtrain.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(tokens)})
    got = make_prefill_step(tcfg)(_bridge(jp),
                                  {"tokens": torch.from_numpy(tokens)})
    assert got.shape == tokens.shape and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_prefill_step_alignment():
    """Entry t scores tokens[t] given the prefix; entry 0 is unused."""
    jcfg, tcfg = tiny_cfg()
    params = _bridge(_jinit(jax.random.PRNGKey(0), jcfg))
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 64, (2, 12)))
    lp = make_prefill_step(tcfg)(params, {"tokens": toks})
    assert lp.shape == toks.shape
    assert float(lp[:, 0].abs().max()) == 0.0
    assert bool((lp[:, 1:] <= 0).all())


def test_engine_logprobs_match_recompute():
    """The train-inference mismatch on the CPU in f32: the paged engine's
    behaviour logprobs (temperature 1, unfiltered policy) equal the
    recomputed logprobs of the generated tokens."""
    tcfg = tconfigs.get_config("yi-9b").reduced()
    params = _bridge(_jinit(jax.random.PRNGKey(4),
                                        jax_get_config("yi-9b").reduced()))
    prompts = np.random.default_rng(4).integers(3, tcfg.vocab_size, (4, 9))
    eng = PagedEngine(tcfg, max_batch=4, page_size=4, max_new_tokens=6,
                      temperature=1.0, top_k=8, top_p=0.9, eos_token=-1,
                      prefill_chunk=8, device="cpu")
    res = eng.generate(params, prompts, seed=5)
    lp = make_prefill_step(tcfg)(params, {"tokens": res.tokens.long()})
    np.testing.assert_allclose(lp[:, 9:].numpy(), res.logprobs[:, 9:].numpy(),
                               atol=1e-4, rtol=1e-5)


# ---------------------------------------------------------------------------
# policy loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("entropy_coef,kl_coef", [(0.0, 0.0), (0.01, 0.1)])
def test_policy_loss_value_and_grads_match_jax(entropy_coef, kl_coef):
    """Loss, every metric and every param gradient, with the entropy term
    (padded-vocab mask) and the k3 KL against ref_logprobs."""
    jcfg, tcfg = tiny_cfg("qwen2.5-7b")
    jcfg = jcfg.replace(vocab_size=60)  # 60 of 64 padded: the mask matters
    tcfg = tcfg.replace(vocab_size=60)
    jp = _jinit(jax.random.PRNGKey(5), jcfg)
    batch = _rl_batch(np.random.default_rng(5), 3, 16, 60, ref=True)
    kw = dict(entropy_coef=entropy_coef, kl_coef=kl_coef, clip_eps_low=0.1,
              clip_eps_high=0.3)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: jtrain.policy_loss(jcfg, jtrain.TrainHParams(**kw), p,
                                        b), has_aux=True))(jp, _jbatch(batch))
    params = tree_map(lambda t: t.requires_grad_(), _bridge(jp))
    loss, metrics = policy_loss(tcfg, TrainHParams(**kw), params,
                                _tbatch(batch))
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert metrics.keys() == want_m.keys()
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(want_m[k]),
                                   atol=1e-6, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-4)
    got_g = tree_map(lambda _: None, params)
    it = iter(grads)
    got_g = tree_map(lambda _: next(it), got_g)
    _close_trees(got_g, _np(want_g), atol=1e-6, rtol=1e-4)


def test_lm_loss_matches_jax():
    jcfg, tcfg = tiny_cfg()
    jp = _jinit(jax.random.PRNGKey(6), jcfg)
    toks = np.random.default_rng(6).integers(0, 64, (2, 10)).astype(np.int32)
    want, _ = jax.jit(lambda p, t: jtrain.lm_loss(
        jcfg, jtrain.TrainHParams(), p, {"tokens": t}))(jp, jnp.asarray(toks))
    got, m = lm_loss(tcfg, TrainHParams(), _bridge(jp),
                     {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(m["ce"]) == float(got)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def _opt_inputs(rng, scale):
    shapes = {"w": (6, 5), "stack": {"a": (3, 4, 2), "ln": (3, 4)},
              "bias": (7,)}

    def draw(s):
        return rng.standard_normal(s).astype(np.float32)

    params = {k: ({kk: draw(ss) for kk, ss in s.items()}
                  if isinstance(s, dict) else draw(s))
              for k, s in shapes.items()}
    grads = jax.tree.map(lambda p: scale * draw(p.shape), params)
    mu = jax.tree.map(lambda p: 0.1 * draw(p.shape), params)
    nu = jax.tree.map(lambda p: np.abs(0.1 * draw(p.shape)), params)
    return params, grads, mu, nu


@pytest.mark.parametrize("cfg", [
    # the clip is active (global norm ~ 30 > 1), decay, warmup + cosine
    dict(lr=1e-2, weight_decay=0.1, clip_norm=1.0, warmup_steps=3,
         total_steps=20),
    dict(lr=3e-3, clip_norm=0.0),
    dict(lr=1e-2, weight_decay=0.05, clip_norm=100.0, warmup_steps=10),
])
def test_adamw_update_matches_jax(cfg):
    """From the same params, grads and non-zero moments at step 4: params,
    moments, step, grad_norm and lr."""
    rng = np.random.default_rng(7)
    params, grads, mu, nu = _opt_inputs(rng, scale=5.0)
    acfg = dict(cfg)
    jstate = jopt.AdamWState(step=jnp.int32(4),
                             mu=jax.tree.map(jnp.asarray, mu),
                             nu=jax.tree.map(jnp.asarray, nu))
    wp, ws, wm = jax.jit(jopt.adamw_update, static_argnums=0)(
        jopt.AdamWConfig(**acfg), jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, grads), jstate)
    tp = params_from_numpy(params, device="cpu")
    tg = params_from_numpy(grads, device="cpu")
    ts = opt_state_from_numpy(_np(jstate), device="cpu")
    gp, gs, gm = adamw_update(AdamWConfig(**acfg), tp, tg, ts)
    assert gp is tp  # updated in place
    assert gs.step == int(ws.step) == 5
    np.testing.assert_allclose(float(gm["grad_norm"]), float(wm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(gm["lr"]), float(wm["lr"]), rtol=1e-6)
    _close_trees(gs.mu, _np(ws.mu), atol=1e-7, rtol=1e-5)
    _close_trees(gs.nu, _np(ws.nu), atol=1e-7, rtol=1e-5)
    _close_trees(gp, _np(wp), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 50, 109, 110, 200])
def test_schedule_lr_matches_jax(step):
    cfg = dict(lr=2.0, warmup_steps=10, total_steps=110, min_lr_frac=0.1)
    want = jopt.schedule_lr(jopt.AdamWConfig(**cfg), jnp.int32(step))
    got = topt.schedule_lr(AdamWConfig(**cfg), step)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_adamw_matches_manual_reference():
    cfg = AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, clip_norm=0.0,
                      weight_decay=0.0)
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.5])}
    p2, _, _ = adamw_update(cfg, p, g, init_adamw(p))
    # manual first step: m=0.1*g/(1-0.9), v=0.01*g^2/(1-0.99) -> delta=g/|g|
    mhat = 0.1 * 0.5 / (1 - 0.9)
    vhat = 0.01 * 0.25 / (1 - 0.99)
    expect = 1.0 - 0.1 * mhat / (np.sqrt(vhat) + 1e-8)
    assert float(p2["w"][0]) == pytest.approx(expect, rel=1e-5)


@pytest.mark.parametrize("max_norm,scale", [(1.0, 3.0), (0.1, 0.01),
                                            (10.0, 100.0), (5.0, 0.5)])
def test_clip_by_global_norm(max_norm, scale):
    g = {"a": torch.ones(4) * scale, "b": {"c": -torch.ones(5) * scale}}
    clipped, norm = topt.clip_by_global_norm(g, max_norm)
    assert float(norm) == pytest.approx(3.0 * scale, rel=1e-6)
    assert float(global_norm(clipped)) == pytest.approx(
        min(max_norm, 3.0 * scale), rel=1e-5)
    want, wnorm = jopt.clip_by_global_norm(
        {"a": jnp.ones(4) * scale, "b": {"c": -jnp.ones(5) * scale}},
        max_norm)
    _close_trees(clipped, _np(want), rtol=1e-6)


def test_sgd_update_in_place():
    p = {"w": torch.tensor([1.0, 2.0])}
    p2, st, m = topt.sgd_update(0.5, p, {"w": torch.tensor([2.0, -4.0])},
                                topt.init_sgd(p))
    assert p2 is p and st.step == 1
    torch.testing.assert_close(p["w"], torch.tensor([0.0, 4.0]))
    assert float(m["grad_norm"]) == pytest.approx(np.sqrt(20.0))


def test_opt_state_bridge_round_trip():
    params = params_from_numpy(_opt_inputs(np.random.default_rng(0), 1.0)[0],
                               device="cpu")
    st = init_adamw(params)
    st = st._replace(step=3)
    back = opt_state_from_numpy(opt_state_to_numpy(st), device="cpu")
    assert back.step == 3
    _close_trees(back.mu, params_to_numpy(st.mu), atol=0)
    assert all(t.dtype == torch.float32 for t in tree_leaves(back.nu))


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nm", [1, 2])
def test_train_step_matches_jax_two_steps(nm):
    """Two steps from bridged params and non-zero moments (JAX's state after
    one step), with the clip active: metrics and grad_norm tightly, moments
    tightly, params within 2 * lr (where g ~ 0 the Adam step is close to
    lr * sign(g) and may flip)."""
    jcfg, tcfg = tiny_cfg()
    lr = 1e-3
    jhp = jtrain.TrainHParams(
        optimizer=jopt.AdamWConfig(lr=lr, clip_norm=0.5, weight_decay=0.01),
        n_microbatches=nm, entropy_coef=0.01)
    thp = TrainHParams(optimizer=AdamWConfig(lr=lr, clip_norm=0.5,
                                             weight_decay=0.01),
                       n_microbatches=nm, entropy_coef=0.01)
    rng = np.random.default_rng(8)
    batches = [_rl_batch(rng, 4, 12, 64) for _ in range(3)]
    jp = _jinit(jax.random.PRNGKey(8), jcfg)
    jst = jtrain.init_adamw(jp)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jhp))
    jp, jst, _ = jstep(jp, jst, _jbatch(batches[0]))
    tp, tst = _bridge(jp), opt_state_from_numpy(_np(jst), device="cpu")
    tstep = make_train_step(tcfg, thp)
    for batch in batches[1:]:
        jp, jst, jm = jstep(jp, jst, _jbatch(batch))
        tp, tst, tm = tstep(tp, tst, _tbatch(batch))
        assert tm.keys() == jm.keys()
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-6,
                                       rtol=1e-4, err_msg=k)
        assert tst.step == int(jst.step)
        _close_trees(tst.mu, _np(jst.mu), atol=1e-7, rtol=1e-3)
        _close_trees(tst.nu, _np(jst.nu), atol=1e-10, rtol=1e-3)
        _close_trees(tp, _np(jp), atol=2 * lr, rtol=0)


def test_microbatch_accumulation_matches_full_batch():
    """n_microbatches must not change the update (uniform masks: the mean
    of microbatch means equals the global mean)."""
    jcfg, tcfg = tiny_cfg()
    jp = _jinit(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    B, S = 8, 16
    batch = _tbatch({
        "tokens": rng.integers(0, 64, (B, S)).astype(np.int32),
        "old_logprobs": np.full((B, S), -2.0, np.float32),
        "advantages": rng.standard_normal((B, S)).astype(np.float32),
        "loss_mask": np.ones((B, S), np.float32)})
    out = []
    for nm in (1, 4):
        params = _bridge(jp)
        p, _, m = make_train_step(tcfg, TrainHParams(n_microbatches=nm))(
            params, init_adamw(params), batch)
        out.append(p)
    _close_trees(out[0], params_to_numpy(out[1]), atol=5e-3, rtol=5e-3)


def test_policy_loss_zero_advantage_gives_zero_grad_signal():
    jcfg, tcfg = tiny_cfg()
    params = _bridge(_jinit(jax.random.PRNGKey(0), jcfg))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (2, 8)))
    batch = {"tokens": toks,
             "old_logprobs": make_prefill_step(tcfg)(params,
                                                     {"tokens": toks}),
             "advantages": torch.zeros((2, 8)),
             "loss_mask": torch.ones((2, 8))}
    _, _, m = make_train_step(tcfg, TrainHParams())(
        params, init_adamw(params), batch)
    assert float(m["pg_loss"]) == pytest.approx(0.0, abs=1e-6)
    assert float(m["ratio_mean"]) == pytest.approx(1.0, rel=1e-4)


def test_lm_overfit_tiny_batch():
    """Supervised sanity: the stack drives CE down on one repeated batch."""
    jcfg, tcfg = tiny_cfg()
    params = _bridge(_jinit(jax.random.PRNGKey(0), jcfg))
    opt = init_adamw(params)
    step = make_train_step(tcfg, TrainHParams(
        optimizer=AdamWConfig(lr=3e-3, clip_norm=1.0)), loss_fn=lm_loss)
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(1).integers(0, 64, (4, 16)))}
    losses = []
    for _ in range(40):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


# ---------------------------------------------------------------------------
# GRPO advantages (host-side numpy copy)
# ---------------------------------------------------------------------------
def test_grpo_advantages_match_jax_package():
    rng = np.random.default_rng(9)
    rewards = rng.random(12).astype(np.float32)
    mask = (rng.random((12, 7)) > 0.3).astype(np.float32)
    for g in (1, 3, 4, 12):
        np.testing.assert_array_equal(tadv.grpo_advantages(rewards, g),
                                      jadv.grpo_advantages(rewards, g))
    adv = tadv.grpo_advantages(rewards, 4)
    np.testing.assert_array_equal(tadv.broadcast_to_tokens(adv, mask),
                                  jadv.broadcast_to_tokens(adv, mask))
