"""The VLM and encoder-decoder kinds of the port (``repro_torch.models``)
on the CPU against the JAX package, from the same bridged weights and
inputs made from a seed with numpy: ``forward``, ``encode``,
``precompute_cross_caches``, ``prefill``, ``make_prefill_step``,
``policy_loss`` and a train step; ``decode_step`` against ``forward``
for every kind (the JAX package's own bar), against JAX's row by row, and
through ``make_serve_step``; and the config registry equal to JAX's."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro import train as jtrain
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.train import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.bridge import opt_state_from_numpy, params_from_numpy
from repro_torch.models import model as tmodel
from repro_torch.train import (
    AdamWConfig,
    TrainHParams,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    policy_loss,
)
from repro_torch.utils.treeutil import tree_leaves, tree_map

torch.set_num_threads(1)

# f32 end to end, the tolerances of tests/test_torch_train.py
LOGIT_TOL = 1e-4
CROSS = ["llama-3.2-vision-90b", "whisper-large-v3"]
# one arch of each kind, as tests/test_models.py's KIND_ARCHS
KIND_ARCHS = ["codeqwen1.5-7b", "granite-moe-3b-a800m", "mamba2-370m",
              "zamba2-2.7b", "llama-3.2-vision-90b", "whisper-large-v3"]
TINY = dict(vocab_size=64, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=128)


def _nodrop(cfg):
    if cfg.moe is not None:
        return cfg.replace(moe=dataclasses.replace(
            cfg.moe,
            capacity_factor=float(cfg.moe.num_experts) / cfg.moe.top_k))
    return cfg


@functools.lru_cache(maxsize=None)
def _model(arch, tiny=True):
    """(jax cfg, port cfg, jax params, port params): ``arch`` reduced (and
    narrowed when ``tiny``), the weights nudged by seeded noise and a VLM's
    cross gates set to 0.5, so the cross layers count."""
    kw = TINY if tiny else {}
    jcfg = _nodrop(jax_get_config(arch).reduced().replace(**kw))
    tcfg = _nodrop(tconfigs.get_config(arch).reduced().replace(**kw))
    rng = np.random.default_rng(1)
    jp = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32), jmodels.init_model(jax.random.PRNGKey(1), jcfg))
    if "cross_layers" in jp:
        jp["cross_layers"]["gate"] = np.full_like(
            jp["cross_layers"]["gate"], 0.5)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), params_from_numpy(
        jp, device="cpu")


def _extra(cfg, B, seed=2):
    """The stub frontend's embeddings: image tokens or audio frames."""
    rng = np.random.default_rng(seed)
    if cfg.kind == "vlm":
        key, n = "image_embeds", cfg.num_image_tokens
    elif cfg.kind == "encdec":
        key, n = "frame_embeds", cfg.encoder_seq_len
    else:
        return {}
    return {key: (0.5 * rng.standard_normal((B, n, cfg.d_model))).astype(
        np.float32)}


def _tokens(cfg, B, S, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in tree.items()}


def _flat(tree, leaf=None):
    """{'/a/b': leaf(x)} for a nested dict (as numpy by default)."""
    out = {}

    def rec(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                rec(f"{prefix}/{k}", v)
            elif leaf is not None:
                out[f"{prefix}/{k}"] = leaf(v)
            else:
                out[f"{prefix}/{k}"] = np.asarray(
                    v.detach() if isinstance(v, torch.Tensor) else v)
    rec("", tree)
    return out


def _close_trees(got, want, **tol):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in g:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)


# ---------------------------------------------------------------------------
# the registry and the param trees
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", jax_list_archs())
def test_registry_and_param_tree_match_jax(arch):
    """Every arch of JAX's zoo is the port's, full and reduced, and the
    port's ``init_model`` gives JAX's tree: keys, shapes and types."""
    assert tconfigs.list_archs() == jax_list_archs()
    for red in (False, True):
        j, t = jax_get_config(arch), tconfigs.get_config(arch)
        if red:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    jcfg = jax_get_config(arch).reduced()
    want = jax.eval_shape(lambda k: jmodels.init_model(k, jcfg),
                          jax.random.PRNGKey(0))
    got = tmodel.init_model(torch.Generator().manual_seed(0),
                            tconfigs.get_config(arch).reduced(),
                            device="cpu")
    assert _flat(got, lambda v: (tuple(v.shape), str(v.dtype)[6:])) == \
        _flat(want, lambda v: (tuple(v.shape), str(v.dtype)))


# ---------------------------------------------------------------------------
# full-sequence paths of the cross-attention kinds
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", CROSS)
def test_forward_matches_jax(arch):
    jcfg, tcfg, jp, tp = _model(arch, tiny=False)
    tokens, extra = _tokens(jcfg, 2, 24), _extra(jcfg, 2)
    want, want_aux, want_h = jax.jit(lambda p, t, e: jmodels.forward(
        p, jcfg, t, e, return_hidden=True))(jp, jnp.asarray(tokens),
                                            _j(extra))
    got, aux, h = tmodel.forward(tp, tcfg, torch.from_numpy(tokens).long(),
                                 _t(extra), return_hidden=True)
    assert got.shape == want.shape and float(aux) == float(want_aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    # the extra matters, and remat changes nothing
    other = tmodel.forward(tp, tcfg, torch.from_numpy(tokens).long(),
                           _t(_extra(jcfg, 2, seed=9)))[0]
    assert (other - got).abs().max() > 1e-3
    remat = tmodel.forward(tp, tcfg, torch.from_numpy(tokens).long(),
                           _t(extra), remat=True)[0]
    torch.testing.assert_close(remat, got, atol=0, rtol=0)
    with pytest.raises(AssertionError, match="needs"):
        tmodel.forward(tp, tcfg, torch.from_numpy(tokens).long())


def test_encode_matches_jax():
    """The encoder alone: bidirectional (a later frame changes an earlier
    frame's output), then ``ln_enc``."""
    jcfg, tcfg, jp, tp = _model("whisper-large-v3", tiny=False)
    frames = _extra(jcfg, 2)["frame_embeds"]
    want = jax.jit(lambda p, f: jmodels.model.encode(p, jcfg, f))(
        jp, jnp.asarray(frames))
    got = tmodel.encode(tp, tcfg, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    changed = frames.copy()
    changed[:, -1] += 1.0
    moved = tmodel.encode(tp, tcfg, torch.from_numpy(changed))
    assert (moved[:, 0] - got[:, 0]).abs().max() > 1e-4


@pytest.mark.parametrize("arch", CROSS)
def test_precompute_cross_caches_matches_jax(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    extra = _extra(jcfg, 2)
    want = jmodels.precompute_cross_caches(
        jp, jcfg, _j(extra), jmodels.init_decode_state(jcfg, 2, 8))
    state = tmodel.init_decode_state(tcfg, 2, 8, device="cpu")
    assert not any(t.abs().max() for t in state.cross_kv)
    got = tmodel.precompute_cross_caches(tp, tcfg, _t(extra), state)
    for a, b in zip(got.cross_kv, want.cross_kv):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
    # the input state is not written
    assert not any(t.abs().max() for t in state.cross_kv)
    if tcfg.kind == "encdec":  # a given encoder output is used as it is
        enc = tmodel.encode(tp, tcfg, torch.from_numpy(extra["frame_embeds"]))
        again = tmodel.precompute_cross_caches(tp, tcfg, {"encoder_out": enc},
                                               state)
        for a, b in zip(again.cross_kv, got.cross_kv):
            torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("arch", CROSS)
def test_prefill_with_extra_matches_jax(arch):
    """``prefill`` with the embeddings: cross caches filled, the prompt
    decoded a position at a time, the last logits JAX's."""
    jcfg, tcfg, jp, tp = _model(arch)
    tokens, extra = _tokens(jcfg, 2, 7), _extra(jcfg, 2)
    want, wst = jmodels.prefill(jp, jcfg, jnp.asarray(tokens),
                                jmodels.init_decode_state(jcfg, 2, 10),
                                _j(extra))
    got, st = tmodel.prefill(tp, tcfg, torch.from_numpy(tokens).long(),
                             tmodel.init_decode_state(tcfg, 2, 10,
                                                      device="cpu"),
                             _t(extra))
    assert got.shape == want.shape == (2, 1, tcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    np.testing.assert_allclose(st.kv.k.numpy(), np.asarray(wst.kv.k),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_array_equal(st.kv.positions.numpy(),
                                  np.asarray(wst.kv.positions))


@pytest.mark.parametrize("arch", CROSS)
def test_prefill_step_matches_jax(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    batch = {"tokens": _tokens(jcfg, 3, 17), **_extra(jcfg, 3)}
    want = jax.jit(jtrain.make_prefill_step(jcfg))(jp, _j(batch))
    got = make_prefill_step(tcfg)(tp, _t(batch))
    assert got.shape == batch["tokens"].shape and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    blind = make_prefill_step(tcfg)(tp, _t({**batch, **_extra(jcfg, 3, 8)}))
    assert (blind - got).abs().max() > 1e-4


def _rl_batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, S), np.float32)
    mask[:, S // 2:] = 1.0
    return {"tokens": _tokens(cfg, B, S, seed),
            "old_logprobs": (-3.0 + 0.3 * rng.standard_normal((B, S))).astype(
                np.float32),
            "advantages": (rng.standard_normal((B, S)) * mask).astype(
                np.float32),
            "loss_mask": mask,
            "ref_logprobs": (-3.0 + 0.3 * rng.standard_normal((B, S))).astype(
                np.float32),
            **_extra(cfg, B, seed)}


@pytest.mark.parametrize("arch", CROSS)
def test_policy_loss_value_and_grads_match_jax(arch):
    """Loss, every metric and every param gradient (the cross layers' and
    the encoder's among them), with entropy and KL terms on."""
    jcfg, tcfg, jp, tp = _model(arch)
    batch = _rl_batch(jcfg, 3, 12, 4)
    kw = dict(entropy_coef=0.01, kl_coef=0.1, clip_eps_low=0.1,
              clip_eps_high=0.3)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p, b: jtrain.policy_loss(jcfg, jtrain.TrainHParams(**kw), p,
                                        b), has_aux=True))(jp, _j(batch))
    params = tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    loss, metrics = policy_loss(tcfg, TrainHParams(**kw), params, _t(batch))
    grads = torch.autograd.grad(loss, tree_leaves(params))
    assert metrics.keys() == want_m.keys()
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(want_m[k]), atol=1e-6, rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-4)
    it = iter(grads)
    _close_trees(tree_map(lambda _: next(it), params),
                 jax.tree.map(np.asarray, want_g), atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("arch", CROSS)
def test_train_step_matches_jax(arch):
    """One step in two microbatches (each with its own embeddings) from
    the same params and fresh moments: metrics, moments and params within
    the tolerances of tests/test_torch_train.py."""
    jcfg, tcfg, jp, tp = _model(arch)
    lr = 1e-3
    opt = dict(lr=lr, clip_norm=0.5, weight_decay=0.01)
    jhp = jtrain.TrainHParams(optimizer=jopt.AdamWConfig(**opt),
                              n_microbatches=2, entropy_coef=0.01)
    thp = TrainHParams(optimizer=AdamWConfig(**opt), n_microbatches=2,
                       entropy_coef=0.01)
    batch = _rl_batch(jcfg, 4, 12, 5)
    jst = jtrain.init_adamw(jp)
    jp2, jst2, jm = jax.jit(jtrain.make_train_step(jcfg, jhp))(
        jp, jst, _j(batch))
    tst = opt_state_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")
    params = tree_map(lambda t: t.clone(), tp)
    params, tst, tm = make_train_step(tcfg, thp)(params, tst, _t(batch))
    assert tm.keys() == jm.keys()
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-6,
                                   rtol=1e-4, err_msg=k)
    _close_trees(tst.mu, jax.tree.map(np.asarray, jst2.mu), atol=1e-7,
                 rtol=1e-3)
    _close_trees(params, jax.tree.map(np.asarray, jp2), atol=2 * lr, rtol=0)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", KIND_ARCHS)
def test_decode_matches_forward(arch):
    """Decoding token by token with the cache (cross caches precomputed)
    reproduces the full-sequence forward (tests/test_models.py's bar),
    and each step's logits are JAX's decode_step's."""
    jcfg, tcfg, jp, tp = _model(arch, tiny=False)
    B, S = 2, 16
    tokens, extra = _tokens(jcfg, B, S, seed=1), _extra(jcfg, B, seed=1)
    ref, _ = tmodel.forward(tp, tcfg, torch.from_numpy(tokens).long(),
                            _t(extra) or None)
    st = tmodel.init_decode_state(tcfg, B, S + 4, device="cpu")
    jst = jmodels.init_decode_state(jcfg, B, S + 4)
    if extra:
        st = tmodel.precompute_cross_caches(tp, tcfg, _t(extra), st)
        jst = jmodels.precompute_cross_caches(jp, jcfg, _j(extra), jst)
    jstep = jax.jit(lambda p, t, s, i: jmodels.decode_step(p, jcfg, t, s, i))
    outs = []
    for i in range(S):
        lg, st = tmodel.decode_step(tp, tcfg,
                                    torch.from_numpy(tokens[:, i:i + 1]).long(),
                                    st, i)
        jlg, jst = jstep(jp, jnp.asarray(tokens[:, i:i + 1]), jst,
                         jnp.int32(i))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    rel = float((dec - ref).abs().max() / ref.abs().max())
    assert rel < 2e-3, (arch, rel)


@pytest.mark.parametrize("arch", ["yi-9b", "granite-moe-3b-a800m",
                                  "llama-3.2-vision-90b", "whisper-large-v3"])
def test_rows_at_their_own_positions_decode_as_alone(arch):
    """A batch whose rows sit at different positions (the port's (B,)
    ``pos``) gives each row what it gives alone; the input state is not
    written."""
    _, tcfg, _, tp = _model(arch)
    tokens = torch.from_numpy(_tokens(tcfg, 2, 9, seed=6)).long()
    extra = _t(_extra(tcfg, 2, seed=6))

    def run(rows, lengths):
        st = tmodel.init_decode_state(tcfg, len(rows), 12, device="cpu")
        if extra:
            st = tmodel.precompute_cross_caches(
                tp, tcfg, {k: v[rows] for k, v in extra.items()}, st)
        logits = []
        for i in range(max(lengths)):
            pos = torch.tensor([min(i, n - 1) for n in lengths])
            tok = tokens[rows][torch.arange(len(rows)), pos][:, None]
            before = [t.clone() for t in st.kv]
            lg, new = tmodel.decode_step(tp, tcfg, tok, st, pos)
            for a, b in zip(before, st.kv):
                torch.testing.assert_close(a, b, atol=0, rtol=0)
            # a row past its length repeats its last position: keep its
            # old state there
            keep = torch.tensor([i >= n for n in lengths])
            st = new._replace(kv=type(new.kv)(*(
                torch.where(keep.view(1, -1, *[1] * (a.dim() - 2)), a, b)
                for a, b in zip(st.kv, new.kv))))
            logits.append(lg[:, 0])
        return [logits[n - 1][j] for j, n in enumerate(lengths)]

    both = run([0, 1], [9, 5])
    alone = run([0], [9]) + run([1], [5])
    for a, b in zip(both, alone):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_serve_step_is_one_decode_step():
    jcfg, tcfg, jp, tp = _model("whisper-large-v3")
    extra = _extra(jcfg, 2)
    st = tmodel.precompute_cross_caches(
        tp, tcfg, _t(extra), tmodel.init_decode_state(tcfg, 2, 6,
                                                      device="cpu"))
    jst = jmodels.precompute_cross_caches(
        jp, jcfg, _j(extra), jmodels.init_decode_state(jcfg, 2, 6))
    tok = _tokens(jcfg, 2, 1)
    got, _ = make_serve_step(tcfg)(tp, torch.from_numpy(tok).long(), st, 0)
    want, _ = jtrain.make_serve_step(jcfg)(jp, jnp.asarray(tok), jst,
                                           jnp.int32(0))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
