"""The slice as a whole: the port's ``PagedEngine`` on the CPU against the
JAX package's ``PagedEngine``, both in f32, on the same prompts (made from
a seed with numpy) and the same bridged weights."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_model as jax_init_model
from repro.serve import PagedEngine as JaxPagedEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.serve import PagedEngine

# one intra-op thread: the test workers share the host's cores, and more
# threads in each oversubscribe them (the port's files take ~78 s under
# -n 6 with torch's default threads, ~50 s with one)
torch.set_num_threads(1)


SHRINK = dict(vocab_size=32, d_model=64, num_heads=4, num_kv_heads=2,
              head_dim=16, d_ff=128)
LP_ATOL = 1e-4


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(jax cfg, port cfg, jax params, port params) for a reduced dense
    arch, with every weight nudged off its init constant so biases and
    qk-norm scales are exercised."""
    jcfg = jax_get_config(arch).reduced().replace(**SHRINK)
    tcfg = get_config(arch).reduced().replace(**SHRINK)
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    jp = jax.tree.map(
        lambda a: a + 0.05 * jnp.sin(jnp.arange(a.size).reshape(a.shape)), jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _scale(jp, tp, s):
    return (jax.tree.map(lambda x: x * s, jp),
            {k: _scale_t(v, s) for k, v in tp.items()})


def _scale_t(v, s):
    if isinstance(v, dict):
        return {k: _scale_t(x, s) for k, x in v.items()}
    return v * s


def _prompts(seed, n, length):
    rng = np.random.default_rng(seed)
    return rng.integers(3, SHRINK["vocab_size"], size=(n, length)).astype(
        np.int32)


def _engines(arch, **kw):
    jcfg, tcfg, jp, tp = _model(arch)
    return (JaxPagedEngine(jcfg, **kw), PagedEngine(tcfg, device="cpu", **kw),
            jp, tp)


def _jax_noise(seeds, positions, V):
    """The JAX engine's own per-request Gumbel draws, as numpy."""
    keys = jax.vmap(lambda s, p: jax.random.fold_in(jax.random.PRNGKey(s),
                                                    p))(
        jnp.asarray(seeds.cpu().numpy(), jnp.int32),
        jnp.asarray(positions.cpu().numpy(), jnp.int32))
    return np.array(jax.vmap(
        lambda k: jax.random.gumbel(k, (V,), jnp.float32))(keys))


def _assert_same_requests(jreqs, treqs):
    for a, b in zip(jreqs, treqs):
        assert a.generated == b.generated, (a.rid, a.generated, b.generated)
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=LP_ATOL)
        assert (a.weight_version, a.last_weight_version) == \
            (b.weight_version, b.last_weight_version)


# ---------------------------------------------------------------------------
# temperature 0: tokens, lengths and logprobs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,page_size", [
    ("yi-9b", 2), ("yi-9b", 4), ("yi-9b", 16),
    ("qwen2.5-7b", 4),    # qkv bias
    ("stablelm-12b", 4),  # qk norm
])
def test_paged_engine_matches_jax_at_temp0(arch, page_size):
    prompts = _prompts(0, 6, 7)
    # fewer slots than requests: queueing and backfill
    je, te, jp, tp = _engines(arch, max_batch=4, page_size=page_size,
                              max_new_tokens=8, temperature=0.0)
    want = je.generate(jp, prompts, key=jax.random.PRNGKey(1))
    got = te.generate(tp, prompts)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_allclose(got.logprobs.numpy(),
                               np.asarray(want.logprobs), atol=LP_ATOL)
    assert te.allocator.pages_allocated_total == \
        je.allocator.pages_allocated_total
    assert te.allocator.num_allocated == te.prefix_cache.num_pages
    te.release_prefix_cache()
    assert te.allocator.num_allocated == 0


# ---------------------------------------------------------------------------
# prefix sharing, copy-on-write, chunked prefill, preemption, weight swap
# ---------------------------------------------------------------------------
def test_prefix_sharing_and_cow_match_jax():
    prompt = _prompts(1, 1, 16)[0]
    group = np.stack([prompt] * 8)
    je, te, jp, tp = _engines("yi-9b", max_batch=8, page_size=8,
                              max_new_tokens=4, temperature=0.0)
    want = je.generate(jp, group)
    got = te.generate(tp, group)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    # 2 prompt pages allocated once + 1 decode page per request
    assert te.allocator.pages_allocated_total == 10 == \
        je.allocator.pages_allocated_total
    assert te.scheduler.stats.prefix_shared_pages == 14
    assert te.scheduler.stats.prefix_hit_tokens == \
        je.scheduler.stats.prefix_hit_tokens > 0

    # two prompts sharing a partial page: the second copies the shared
    # rows into its own page
    base = [int(t) for t in _prompts(8, 1, 6)[0]]
    p2 = base[:5] + [(base[5] + 1) % SHRINK["vocab_size"]]
    je, te, jp, tp = _engines("yi-9b", max_batch=1, page_size=4,
                              max_new_tokens=4, temperature=0.0)
    second = []
    for eng, params in ((je, jp), (te, tp)):
        eng.set_params(params)
        eng.submit(base, seed=0)
        eng.run()
        second.append(eng.submit(p2, seed=1))
        eng.run()
        assert eng.scheduler.stats.cow_pages >= 1
    _assert_same_requests([second[0]], [second[1]])


def test_chunked_prefill_matches_jax_and_counts_deferral():
    prompts = _prompts(5, 3, 24)
    out = {}
    for chunk in (8, 256):
        je, te, jp, tp = _engines("yi-9b", max_batch=3, page_size=4,
                                  max_new_tokens=5, temperature=0.0,
                                  prefill_chunk=chunk)
        want = je.generate(jp, prompts)
        got = te.generate(tp, prompts)
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))
        np.testing.assert_allclose(got.logprobs.numpy(),
                                   np.asarray(want.logprobs), atol=LP_ATOL)
        assert te.scheduler.stats.chunk_deferred_tokens == \
            je.scheduler.stats.chunk_deferred_tokens
        out[chunk] = (te, got)
    assert out[8][0].scheduler.stats.chunk_deferred_tokens > 0
    assert out[256][0].scheduler.stats.chunk_deferred_tokens == 0
    np.testing.assert_array_equal(out[8][1].tokens.numpy(),
                                  out[256][1].tokens.numpy())


def test_preemption_on_a_tight_pool_matches_jax():
    prompts = _prompts(0, 4, 6)
    kw = dict(max_batch=4, page_size=4, max_seq_len=32, max_new_tokens=24,
              temperature=0.0, num_pages=10, eos_token=-1)
    je, te, jp, tp = _engines("yi-9b", **kw)
    runs = []
    for eng, params in ((je, jp), (te, tp)):
        eng.set_params(params)
        reqs = [eng.submit(prompts[i], seed=i) for i in range(4)]
        eng.run()
        eng.release_prefix_cache()
        assert eng.allocator.num_allocated == 0
        runs.append(reqs)
    assert te.scheduler.stats.preempted == je.scheduler.stats.preempted > 0
    _assert_same_requests(*runs)
    assert all(len(r.generated) == 24 for r in runs[1])


def test_inflight_weight_swap_matches_jax():
    prompts = _prompts(0, 4, 5)
    je, te, jp, tp = _engines("yi-9b", max_batch=2, page_size=4,
                              max_new_tokens=6, temperature=0.0,
                              eos_token=-1)
    jp1, tp1 = _scale(jp, tp, 1.05)
    runs = []
    for eng, p0, p1 in ((je, jp, jp1), (te, tp, tp1)):
        eng.set_params(p0, version=0)
        reqs = [eng.submit(prompts[i], seed=i) for i in range(4)]
        for _ in range(3):
            eng.step()
        eng.update_weights(p1, version=1)
        eng.run()
        assert eng.weight_version == 1 and eng.weight_swaps == 1
        runs.append(reqs)
    tags = [r.weight_version for r in runs[1]]
    assert 0 in tags and 1 in tags  # the requests straddle the swap
    _assert_same_requests(*runs)


# ---------------------------------------------------------------------------
# sampling above temperature 0
# ---------------------------------------------------------------------------
def test_injected_jax_noise_gives_jax_tokens_above_temp0():
    prompts = _prompts(3, 5, 9)
    je, te, jp, tp = _engines("yi-9b", max_batch=3, page_size=4,
                              max_new_tokens=10, temperature=1.0, top_k=8,
                              top_p=0.9, prefill_chunk=8, eos_token=-1)
    te.layout.noise_fn = _jax_noise
    runs = []
    for eng, params in ((je, jp), (te, tp)):
        eng.set_params(params)
        runs.append([eng.submit(p, seed=100 + i)
                     for i, p in enumerate(prompts)])
        eng.run()
    _assert_same_requests(*runs)
    assert len({tuple(r.generated) for r in runs[1]}) > 1


def test_own_noise_is_invariant_to_order_and_batching():
    prompts = _prompts(4, 5, 5)
    _, tcfg, _, tp = _model("yi-9b")
    outs = []
    for max_batch, order in ((2, range(5)), (5, reversed(range(5)))):
        eng = PagedEngine(tcfg, max_batch=max_batch, page_size=4,
                          max_new_tokens=6, temperature=1.0, top_k=8,
                          top_p=0.95, device="cpu")
        eng.set_params(tp)
        reqs = {i: eng.submit(prompts[i], seed=7 + i) for i in order}
        eng.run()
        outs.append({i: (r.generated, r.logprobs) for i, r in reqs.items()})
    for i in range(5):
        assert outs[0][i][0] == outs[1][i][0]
        np.testing.assert_allclose(outs[0][i][1], outs[1][i][1], atol=1e-6)
    assert len({tuple(g) for g, _ in outs[0].values()}) > 1
