"""The port's static ``Engine`` (``repro_torch.serve.engine``) on the CPU
against the JAX package's, on the same left-padded prompts (made from a
seed with numpy) and the same bridged weights, for every arch of the
zoo: tokens equal and logprobs within 1e-4 at temperature 0 with an EOS
hit, and above it under the JAX engine's own draws; the port's paged
engine against its static one per covered arch; a windowed KV ring that
wraps; the rollout worker's fallback onto the static engine for an arch
no paged layout covers, and a paged worker's act."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.primitives import reset_router as jax_reset_router
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.models import init_model as jax_init_model
from repro.rl import workers as jworkers
from repro.serve import Engine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.comm.primitives import reset_router
from repro_torch.configs import get_config
from repro_torch.core import Channel
from repro_torch.models import model as tmodel
from repro_torch.rl.workers import RolloutWorker
from repro_torch.serve import Engine, PagedEngine, covers

torch.set_num_threads(1)

LP_ATOL = 1e-4
VOCAB = 64  # as tests/test_arch_serve.py
NEW = 8


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
def _model(arch, window=0):
    """(jax cfg, port cfg, jax params, port params) for ``arch`` reduced
    to a vocabulary of 64, every weight nudged by seeded noise so biases,
    norm scales and a VLM's cross gate are not at their init constants."""
    kw = dict(vocab_size=VOCAB, max_seq_len=128, sliding_window=window)
    jcfg = jax_get_config(arch).reduced().replace(**kw)
    tcfg = get_config(arch).reduced().replace(**kw)
    rng = np.random.default_rng(0)
    jp = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32), jax_init_model(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), params_from_numpy(
        jp, device="cpu")


def _prompts(seed=1, lengths=(6, 4, 2)):
    """Left-padded prompts of unequal length (PAD 0 on the left)."""
    rng = np.random.default_rng(seed)
    S = max(lengths)
    out = np.zeros((len(lengths), S), np.int32)
    for i, n in enumerate(lengths):
        out[i, S - n:] = rng.integers(3, VOCAB, n)
    return out


def _eos_hit(tcfg, tp, prompts, **kw):
    """A token that row 0 generates third: as EOS it ends row 0 early."""
    res = Engine(tcfg, max_new_tokens=NEW, eos_token=-1, device="cpu",
                 **kw).generate(tp, prompts, seed=0)
    return int(res.tokens[0, prompts.shape[1] + 2])


def _assert_same(want, got):
    np.testing.assert_array_equal(np.asarray(want.tokens), got.tokens.numpy())
    np.testing.assert_allclose(np.asarray(want.logprobs), got.logprobs.numpy(),
                               atol=LP_ATOL)
    np.testing.assert_array_equal(np.asarray(want.lengths),
                                  got.lengths.numpy())
    np.testing.assert_array_equal(np.asarray(want.done), got.done.numpy())


@pytest.mark.parametrize("arch", jax_list_archs())
def test_static_generate_matches_jax_at_temp0(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    prompts = _prompts()
    eos = _eos_hit(tcfg, tp, prompts, temperature=0.0)
    want = JaxEngine(jcfg, max_new_tokens=NEW, temperature=0.0,
                     eos_token=eos).generate(jp, jnp.asarray(prompts))
    eng = Engine(tcfg, max_new_tokens=NEW, temperature=0.0, eos_token=eos,
                 device="cpu")
    got = eng.generate(tp, prompts, prompt_lens=np.array([6, 4, 2]))
    assert all(t.device.type == "cpu" for t in got[:4])
    assert got.tokens.dtype == torch.int32 and got.weight_versions is None
    assert bool(got.done[0]), "row 0 must hit EOS"
    _assert_same(want, got)


def _jax_static_draws(key, rounds, B, V):
    """The JAX engine's Gumbel draws, round by round: one split of the key
    a round, ``gumbel(sub, (B, V))`` (what ``jax.random.categorical``
    adds to the filtered logits)."""
    out = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, (B, V), jnp.float32)))
    return out


@pytest.mark.parametrize("arch", ["yi-9b", "granite-moe-3b-a800m",
                                  "whisper-large-v3"])
def test_static_generate_matches_jax_under_jax_draws(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    prompts = _prompts(seed=2)
    S = prompts.shape[1]
    kw = dict(temperature=1.0, top_k=8, top_p=0.9)
    key = jax.random.PRNGKey(7)
    want = JaxEngine(jcfg, max_new_tokens=NEW, eos_token=-1, **kw).generate(
        jp, jnp.asarray(prompts), key=key)
    eng = Engine(tcfg, max_new_tokens=NEW, eos_token=-1, device="cpu", **kw)
    draws = _jax_static_draws(key, NEW, 3, tcfg.padded_vocab)
    seen = []

    def noise_fn(seeds, positions, V):
        assert V == tcfg.padded_vocab
        assert torch.equal(positions, torch.full_like(positions,
                                                      positions[0]))
        seen.append(int(positions[0]))
        return torch.from_numpy(draws[int(positions[0]) - S].copy())

    eng.noise_fn = noise_fn
    _assert_same(want, eng.generate(tp, prompts, seed=5))
    assert seen == list(range(S, S + NEW))
    # the port's own noise: seeded per row, so a row's draw does not
    # depend on the batch it is in
    eng = Engine(tcfg, max_new_tokens=NEW, eos_token=-1, device="cpu", **kw)
    full = eng.generate(tp, prompts, seed=5)
    row = eng.generate(tp, prompts[1:2], seed=6)
    np.testing.assert_array_equal(full.tokens[1].numpy(), row.tokens[0].numpy())


@pytest.mark.parametrize("arch", [a for a in jax_list_archs()
                                  if covers(get_config(a))])
def test_paged_matches_static_per_arch_at_temp0(arch):
    """The port's two engines give the same tokens (the JAX test of the
    same name, on the port alone)."""
    _, tcfg, _, tp = _model(arch)
    prompts = _prompts(seed=3, lengths=(6, 6, 6))
    want = Engine(tcfg, max_new_tokens=NEW, temperature=0.0,
                  device="cpu").generate(tp, prompts)
    # fewer slots than requests exercises queueing/backfill per layout
    paged = PagedEngine(tcfg, max_batch=2, max_new_tokens=NEW,
                        temperature=0.0, max_seq_len=64, device="cpu")
    got = paged.generate(tp, prompts)
    np.testing.assert_array_equal(want.tokens.numpy(), got.tokens.numpy())
    np.testing.assert_allclose(want.logprobs.numpy(), got.logprobs.numpy(),
                               atol=LP_ATOL)


def test_windowed_ring_wraps_past_its_window():
    """yi with a window of 4: the decode ring holds 4 slots, the prompt
    and the new tokens wrap it three times, and the tokens are JAX's (the
    paged engine refuses a window, as JAX's does)."""
    jcfg, tcfg, jp, tp = _model("yi-9b", window=4)
    assert not covers(tcfg)
    prompts = _prompts(seed=4, lengths=(6, 5))
    state = tmodel.init_decode_state(tcfg, 2, 6 + NEW, device="cpu")
    assert state.kv.k.shape[2] == 4
    _, state = tmodel.prefill(tp, tcfg, torch.from_numpy(prompts).long(),
                              state)
    np.testing.assert_array_equal(state.kv.positions[0, 0].numpy(),
                                  [4, 5, 2, 3])
    kw = dict(max_new_tokens=NEW, temperature=0.0, eos_token=-1)
    want = JaxEngine(jcfg, **kw).generate(jp, jnp.asarray(prompts))
    _assert_same(want, Engine(tcfg, device="cpu", **kw).generate(tp, prompts))
    # the window changes the tokens: a ring as long as the sequence
    # would attend to everything
    _, tfull, _, _ = _model("yi-9b")
    full = Engine(tfull, device="cpu", **kw).generate(tp, prompts)
    assert not torch.equal(full.tokens, Engine(tcfg, device="cpu", **kw)
                           .generate(tp, prompts).tokens)


@pytest.mark.parametrize("arch,window", [("whisper-large-v3", 0),
                                         ("llama-3.2-vision-90b", 0),
                                         ("yi-9b", 4)])
def test_rollout_worker_auto_falls_back_to_static_with_jax_tokens(arch,
                                                                   window):
    jcfg, tcfg, jp, tp = _model(arch, window)
    kw = dict(max_new_tokens=NEW, temperature=0.0, engine="auto")
    with pytest.warns(UserWarning, match="falling back to the static engine"):
        jw = jworkers.RolloutWorker("rollout/0", cfg=jcfg, **kw)
    with pytest.warns(UserWarning, match="falling back to the static engine"):
        tw = RolloutWorker("rollout/0", cfg=tcfg, device="cpu", **kw)
    assert tw.engine_kind == "static" and isinstance(tw.engine, Engine)
    assert tw.engine.max_new_tokens == NEW and tw.engine.temperature == 0.0
    jw.update_weights(jp)
    tw.update_weights(tp)
    chunk = {"prompt_tokens": _prompts(seed=5)}
    want, got = jw.generate(dict(chunk)), tw.generate(dict(chunk))
    for k in ("tokens", "lengths"):
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
        assert isinstance(got[k], np.ndarray)
    np.testing.assert_allclose(want["logprobs"], got["logprobs"],
                               atol=LP_ATOL)
    assert tw.request_records() == []
    jw.shutdown()
    tw.shutdown()


def test_static_worker_generates_with_its_settings_and_next_seed():
    _, tcfg, _, tp = _model("yi-9b")
    kw = dict(max_new_tokens=5, temperature=1.0, top_k=8, top_p=0.9)
    tw = RolloutWorker("rollout/0", cfg=tcfg, engine="static", seed=3,
                       device="cpu", **kw)
    tw.update_weights(tp)
    seeds = iter([11, 12])
    tw.seeds = seeds
    chunk = {"prompt_tokens": _prompts(seed=6)}
    got = [tw.generate(dict(chunk)) for _ in range(2)]
    eng = Engine(tcfg, eos_token=2, device="cpu", **kw)
    for out, seed in zip(got, (11, 12)):
        want = eng.generate(tp, chunk["prompt_tokens"], seed=seed)
        np.testing.assert_array_equal(out["tokens"], want.tokens.numpy())
    assert not np.array_equal(got[0]["tokens"], got[1]["tokens"])
    tw.shutdown()


def test_paged_worker_acts_as_a_static_worker():
    """JAX builds a hidden static engine for a paged worker's act; the
    port does too, and both workers draw the same actions."""
    _, tcfg, _, tp = _model("yi-9b")
    rng = np.random.default_rng(7)
    chunk = {"prompt_tokens": rng.integers(3, VOCAB, (6, 5)),
             "cycle_step": 2, "env_ids": np.arange(6)}
    out = {}
    for kind in ("paged", "static"):
        w = RolloutWorker(f"policy/{kind}", cfg=tcfg, engine=kind, seed=4,
                          action_range=(10, 20), device="cpu")
        w.update_weights(tp)
        out[kind] = w.act(dict(chunk))
        assert isinstance(w.engine, PagedEngine if kind == "paged"
                          else Engine)
        if kind == "paged":
            assert w._act_engine().max_new_tokens == 1
            assert w._act_engine() is w._act_engine()
        w.shutdown()
    for k in ("action_tokens", "action_logprobs", "actions"):
        np.testing.assert_array_equal(out["paged"][k], out["static"][k],
                                      err_msg=k)
    assert ((out["paged"]["action_tokens"] >= 10)
            & (out["paged"]["action_tokens"] < 20)).all()
