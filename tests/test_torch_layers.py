"""Port layers, attention and init against the JAX package on the same
inputs (made from a seed with numpy) and the same bridged weights."""
import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.models import attention as jattn
from repro.models import init_model as jax_init_model
from repro.models import layers as jlayers
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import init_model
from repro_torch.models import layers as tlayers

# one intra-op thread: the test workers share the host's cores, and more
# threads in each oversubscribe them (the port's files take ~78 s under
# -n 6 with torch's default threads, ~50 s with one)
torch.set_num_threads(1)


DENSE = ["yi-9b", "qwen2.5-7b", "stablelm-12b", "codeqwen1.5-7b"]
ATOL = 2e-5  # f32, same math in another order


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0)


def test_config_registry_matches_jax():
    ported = jax_list_archs()  # the whole zoo
    assert tconfigs.list_archs() == ported
    for name in ported:  # asdict: the MoE block is a dataclass of its own
        assert dataclasses.asdict(tconfigs.get_config(name)) == \
            dataclasses.asdict(jax_get_config(name))
        assert dataclasses.asdict(tconfigs.get_config(name).reduced()) == \
            dataclasses.asdict(jax_get_config(name).reduced())


def test_rmsnorm_matches_jax(rng):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = tlayers.rmsnorm({"scale": _t(scale)}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # bf16 in, bf16 out, computed in f32
    got16 = tlayers.rmsnorm({"scale": _t(scale)}, _t(x).bfloat16())
    assert got16.dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_jax(rng, theta):
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 4000, size=(2, 7)).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.apply_rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-4)  # angles up to 4000 rad in f32


def test_mlp_matches_jax(rng):
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.1
         for k, s in (("gate", (32, 48)), ("up", (32, 48)),
                      ("down", (48, 32)))}
    x = rng.standard_normal((3, 4, 32)).astype(np.float32)
    want = jlayers.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = tlayers.mlp({k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("tied", [False, True])
def test_embed_unembed_match_jax(rng, tied):
    p = {"tokens": rng.standard_normal((96, 16)).astype(np.float32)}
    if not tied:
        p["unembed"] = rng.standard_normal((16, 96)).astype(np.float32)
    toks = rng.integers(0, 96, size=(2, 5)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: _t(v) for k, v in p.items()}
    h = jlayers.embed(jp, jnp.asarray(toks))
    np.testing.assert_array_equal(tlayers.embed(tp, _t(toks).long()).numpy(),
                                  np.asarray(h))
    want = jlayers.unembed(jp, h)
    got = tlayers.unembed(tp, _t(np.asarray(h)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("vocab_size", [0, 40])
def test_token_logprobs_matches_jax(rng, vocab_size):
    logits = (3 * rng.standard_normal((2, 6, 64))).astype(np.float32)
    toks = rng.integers(0, 40, size=(2, 6)).astype(np.int32)
    want = jlayers.token_logprobs(jnp.asarray(logits), jnp.asarray(toks),
                                  vocab_size)
    got = tlayers.token_logprobs(_t(logits), _t(toks).long(), vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("arch", DENSE)
def test_qkv_project_and_sdpa_match_jax(arch):
    """qkv_bias (qwen2.5, codeqwen), qk_norm (stablelm), MHA (codeqwen)."""
    jcfg = jax_get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    jp = jattn.init_attention(jax.random.PRNGKey(1), jcfg, jnp.float32)
    # non-trivial biases and norm scales, so the extra terms are exercised
    jp = jax.tree.map(lambda a: a + 0.1 * jnp.sin(jnp.arange(a.size)
                                                  .reshape(a.shape)), jp)
    tp = params_from_numpy(_np(jp), device="cpu")
    x = np.random.default_rng(2).standard_normal(
        (2, 9, jcfg.d_model)).astype(np.float32)
    jq, jk, jv = jattn.qkv_project(jp, jcfg, jnp.asarray(x))
    tq, tk, tv = tattn.qkv_project(tp, tcfg, _t(x))
    for a, b in ((tq, jq), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    mask = jattn.causal_mask(9, 9)
    want = jattn.sdpa(jq, jk, jv, mask)
    got = tattn.sdpa(_t(np.asarray(jq)), _t(np.asarray(jk)),
                     _t(np.asarray(jv)), _t(np.asarray(mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert ("bq" in tp) == tcfg.qkv_bias and ("q_norm" in tp) == tcfg.qk_norm


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), tuple(v.shape)


@pytest.mark.parametrize("arch", DENSE)
def test_init_model_key_paths_shapes_and_scale_match_jax(arch):
    jcfg = jax_get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    jp = _np(jax_init_model(jax.random.PRNGKey(0), jcfg))
    tp = init_model(torch.Generator().manual_seed(0), tcfg, torch.float32,
                    "cpu")
    assert dict(_paths(tp)) == dict(_paths(jp))
    flat_t, flat_j = dict(_leaf_items(tp)), dict(_leaf_items(jp))
    for path, a in flat_t.items():
        b = flat_j[path]
        assert a.dtype == torch.float32
        # same init law: truncated normal (±2σ) fan-in, normal(0.02), ones
        # and zeros; compare the spread, draws differ by generator
        np.testing.assert_allclose(a.float().std().item() if a.numel() > 1
                                   else 0.0,
                                   b.std() if b.size > 1 else 0.0,
                                   rtol=0.1, atol=1e-6)
        if b.std() == 0:
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            assert a.abs().max().item() <= np.abs(b).max() * 1.25 + 1e-6


def _leaf_items(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("arch", DENSE)
def test_bridge_round_trip_is_bit_exact(arch):
    jp = _np(jax_init_model(jax.random.PRNGKey(3),
                            jax_get_config(arch).reduced()))
    back = params_to_numpy(params_from_numpy(jp, device="cpu"))
    assert dict(_paths(back)) == dict(_paths(jp))
    for path, a in _leaf_items(back):
        b = dict(_leaf_items(jp))[path]
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_bridge_carries_bf16_bits():
    jp = {"w": np.asarray(jnp.asarray([[1.5, -2.25], [3e-3, 7.0]],
                                      jnp.bfloat16))}
    tp = params_from_numpy(jp, device="cpu")
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["w"].float().numpy(),
                                  jp["w"].astype(np.float32))
    assert params_to_numpy(tp)["w"].dtype == np.float32
