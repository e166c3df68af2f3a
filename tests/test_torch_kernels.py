"""Port kernels (plain versions, on the CPU) against the JAX package: the
Pallas kernels in interpret mode and the JAX oracles, on the same inputs
made from a seed with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro.kernels import ref as jref
from repro.kernels import sampling as jsamp
from repro.serve import sampling as jserve_sampling
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa
from repro_torch.serve import sampling as serve_sampling
# the adversarial K2 rows, shared with the card tests (that file imports
# no JAX, so the card's machine can run it)
from test_torch_cuda import SAMPLING_CASES, adversarial_sampling_rows

# one intra-op thread: the test workers share the host's cores, and more
# threads in each oversubscribe them (the port's files take ~78 s under
# -n 6 with torch's default threads, ~50 s with one)
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# K1: paged attention
# ---------------------------------------------------------------------------
def _paged_inputs(seed, B, H, KV, D, page, nb, P=None):
    rng = np.random.default_rng(seed)
    P = P or nb * B + 1
    q = rng.standard_normal((B, H, D), np.float32)
    kp = rng.standard_normal((P, page, KV, D), np.float32)
    vp = rng.standard_normal((P, page, KV, D), np.float32)
    # distinct non-trash pages per request (page 0 is the trash page)
    tables = np.stack([rng.permutation(np.arange(1, P))[:nb]
                       for _ in range(B)]).astype(np.int32)
    return q, kp, vp, tables


def _both(q, kp, vp, tables, lens):
    """(port plain via ops, port oracle, JAX kernel in interpret mode,
    JAX oracle) as numpy."""
    tq, tk, tv, tt, tl = map(_t, (q, kp, vp, tables, lens))
    jq, jk, jv, jt, jl = map(jnp.asarray, (q, kp, vp, tables, lens))
    return (ops.paged_attention(tq, tk, tv, tt, tl).numpy(),
            ref.paged_attention_ref(tq, tk, tv, tt, tl).numpy(),
            np.asarray(jpa.paged_attention_bhd(jq, jk, jv, jt, jl,
                                               interpret=True)),
            np.asarray(jref.paged_attention_ref(jq, jk, jv, jt, jl)))


@pytest.mark.parametrize("B,H,KV,D,page,nb", [
    (1, 2, 1, 32, 8, 2),
    (3, 4, 2, 16, 8, 4),    # GQA groups of 2
    (2, 8, 8, 64, 16, 3),   # MHA
    (4, 6, 2, 32, 4, 5),    # 3-way GQA groups
    (3, 16, 2, 16, 2, 6),   # 2-token pages, G = 8
])
def test_paged_attention_plain_matches_jax(B, H, KV, D, page, nb):
    q, kp, vp, tables = _paged_inputs(B * 31 + page, B, H, KV, D, page, nb)
    kp[0] = 1e3  # a trash page full of large values must never leak
    vp[0] = 1e3
    # ragged context lengths: an empty one, partial pages, a full table
    lens = np.array([(i * 7) % (nb * page + 1) for i in range(B)], np.int32)
    lens[-1] = nb * page
    got, got_ref, want, want_ref = _both(q, kp, vp, tables, lens)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, want_ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_ref, want_ref, atol=1e-5, rtol=1e-5)
    assert (got[lens == 0] == 0).all()


@pytest.mark.parametrize("lens", [[0, 5], [0, 0], [3, 9]])
def test_paged_attention_empty_context_and_trash_page(lens):
    """An empty context gives zeros, not an average over trash pages; the
    contents of page 0 and of rows past the context never matter."""
    B, H, KV, D, page, nb = 2, 4, 2, 16, 4, 4
    q, kp, vp, tables = _paged_inputs(4, B, H, KV, D, page, nb, P=16)
    lens = np.asarray(lens, np.int32)
    base = ops.paged_attention(*map(_t, (q, kp, vp, tables, lens))).numpy()
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[0] = 1e3
    vp2[0] = 7.0
    poisoned = ops.paged_attention(
        *map(_t, (q, kp2, vp2, tables, lens))).numpy()
    np.testing.assert_allclose(base, poisoned, atol=1e-6)
    _, _, want, want_ref = _both(q, kp2, vp2, tables, lens)
    np.testing.assert_allclose(poisoned, want, atol=1e-5)
    np.testing.assert_allclose(poisoned, want_ref, atol=1e-5)
    assert (poisoned[lens == 0] == 0).all()


@pytest.mark.parametrize("page,nb,lens", [
    (16, 64, [0, 1, 37, 64, 65, 200, 224, 1024]),  # one row in the last split
    (16, 64, [0, 0, 0, 0]),                        # every context empty
    (4, 20, [0, 5, 16, 33, 64, 80]),               # 32-token tiles of 8 pages
    (2, 40, [0, 3, 32, 33, 79, 80]),               # 2-token pages
    (8, 4, [0, 9, 32]),                            # one split
    (64, 3, [0, 70, 192]),                         # pages larger than a tile
])
def test_split_partials_merge_to_plain_and_jax(page, nb, lens):
    """The kernel's split-K in plain torch: per-split softmax partials,
    merged in split order, give paged_attention_plain's output and JAX's
    paged_attention_bhd (interpret mode).  Splits whose tiles all lie past
    a context are empty (their rows fully masked, weight 0) and an empty
    context gives zeros; the poisoned trash page never leaks."""
    B, H, KV, D = len(lens), 8, 2, 32
    q, kp, vp, tables = _paged_inputs(page + nb, B, H, KV, D, page, nb)
    kp[0] = 1e3
    vp[0] = 1e3
    lens = np.asarray(lens, np.int32)
    # pages past each context point at the trash page, as the engine's do
    for i, n in enumerate(lens):
        tables[i, -(-n // page):] = 0
    tq, tk, tv, tt, tl = map(_t, (q, kp, vp, tables, lens))
    tile, n_split = pa.split_plan(nb, page)
    assert n_split == min(8, -(-nb * page // tile))
    m, l, acc = pa.split_partials_plain(tq, tk, tv, tt, tl)
    assert m.shape == (B, KV, n_split, H // KV)
    past = np.arange(n_split)[None, :] * tile >= lens[:, None]  # empty splits
    assert (m.numpy().transpose(0, 2, 1, 3)[past] == -1e30).all()
    assert (l.numpy().transpose(0, 2, 1, 3)[past] == 0).all()
    got = pa.combine_splits_plain(m, l, acc).numpy()
    plain = pa.paged_attention_plain(tq, tk, tv, tt, tl).numpy()
    want = np.asarray(jpa.paged_attention_bhd(
        *map(jnp.asarray, (q, kp, vp, tables, lens)), interpret=True))
    np.testing.assert_allclose(got, plain, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert (got[lens == 0] == 0).all()
    assert np.abs(got).max() < 10  # nothing of the 1e3 pages


def test_paged_attention_plain_keeps_bf16():
    q, kp, vp, tables = _paged_inputs(2, 2, 4, 2, 16, 4, 3)
    lens = np.array([5, 12], np.int32)
    args = [_t(x) for x in (q, kp, vp)]
    out = pa.paged_attention_plain(*(a.bfloat16() for a in args),
                                   _t(tables), _t(lens))
    f32 = pa.paged_attention_plain(*(a.bfloat16().float() for a in args),
                                   _t(tables), _t(lens))
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), f32.bfloat16().float())


def test_paged_attention_cuda_wrapper_refuses_cpu_tensors():
    q, kp, vp, tables = _paged_inputs(0, 1, 2, 1, 16, 4, 2)
    with pytest.raises(ValueError):
        pa.paged_attention_bhd(*map(_t, (q, kp, vp, tables)),
                               torch.tensor([3], dtype=torch.int32))


# ---------------------------------------------------------------------------
# K2: fused sampling
# ---------------------------------------------------------------------------
def _sampling_inputs(seed, B, V):
    rng = np.random.default_rng(seed)
    logits = (4.0 * rng.standard_normal((B, V))).astype(np.float32)
    gumbel = rng.gumbel(size=(B, V)).astype(np.float32)
    return logits, gumbel


def _check_sample(logits, gumbel, **kw):
    tl, tg = _t(logits), _t(gumbel)
    jl, jg = jnp.asarray(logits), jnp.asarray(gumbel)
    got_tok, got_lp = ops.fused_sample(tl, tg, **kw)
    ref_tok, ref_lp = ref.fused_sample_ref(tl, tg, **kw)
    want_tok, want_lp = jsamp.fused_sample_bv(jl, jg, interpret=True, **kw)
    oracle_tok, oracle_lp = jref.fused_sample_ref(jl, jg, **kw)
    for tok in (ref_tok.numpy(), np.asarray(want_tok),
                np.asarray(oracle_tok)):
        np.testing.assert_array_equal(got_tok.numpy(), tok)
    for lp in (ref_lp.numpy(), np.asarray(want_lp), np.asarray(oracle_lp)):
        np.testing.assert_allclose(got_lp.numpy(), lp, atol=2e-5, rtol=2e-5)
    assert got_tok.dtype == torch.int32 and got_lp.dtype == torch.float32
    return got_tok.numpy()


@pytest.mark.parametrize("B,V", [(1, 64), (4, 128), (3, 250)])
@pytest.mark.parametrize("temperature,top_k,top_p,vocab_size", [
    (0.0, 0, 1.0, 0),     # greedy
    (1.0, 0, 1.0, 0),     # plain categorical
    (0.7, 5, 1.0, 0),     # top-k only
    (1.0, 0, 0.9, 0),     # nucleus only
    (0.8, 12, 0.7, 40),   # all filters + padded vocab mask
    (1.3, 0, 0.95, 40),
])
def test_fused_sample_plain_matches_jax(B, V, temperature, top_k, top_p,
                                        vocab_size):
    logits, gumbel = _sampling_inputs(B * 7 + V, B, V)
    tok = _check_sample(logits, gumbel, temperature=temperature,
                        top_k=top_k, top_p=top_p, vocab_size=vocab_size)
    if vocab_size:
        assert (tok < vocab_size).all()


@pytest.mark.parametrize("case", SAMPLING_CASES)
def test_fused_sample_ties_and_duplicates_match_jax(case):
    """Adversarial rows: the plain version (the kernel's radix
    formulation) draws JAX's token (Pallas kernel in interpret mode and
    the sort-based oracle) in every case, and the expected one where the
    case fixes it."""
    logits, gumbel, runs = adversarial_sampling_rows(case)
    for kw, want in runs:
        tok = _check_sample(logits, gumbel, **kw)
        if "vocab_size" in kw:
            assert (tok < kw["vocab_size"]).all()
        for r, t in (want or {}).items():
            assert tok[r] == t, (case, kw, r, tok[r], t)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.0, 0, 1.0), (1.0, 0, 1.0), (0.7, 8, 1.0), (1.0, 0, 0.85),
    (0.9, 6, 0.8),
])
def test_sample_token_matches_jax_under_the_same_noise(temperature, top_k,
                                                       top_p):
    """The unfused path draws what JAX's ``sample_token`` draws when both
    see the noise of the same key (jax.random.categorical is Gumbel-max),
    and the fused path agrees with it."""
    B, V = 5, 96
    logits, _ = _sampling_inputs(11, B, V)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(3), i))(
        jnp.arange(B))
    gumbel = np.asarray(jax.vmap(
        lambda k: jax.random.gumbel(k, (V,), jnp.float32))(keys))
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p,
              vocab_size=77)
    want_tok, want_lp = jax.vmap(
        lambda k, lg: jserve_sampling.sample_token(k, lg, **kw))(
            keys, jnp.asarray(logits))
    tok, lp = serve_sampling.sample_token(_t(gumbel), _t(logits), **kw)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), atol=2e-5)
    ftok, flp = serve_sampling.sample_tokens_fused(_t(gumbel), _t(logits),
                                                   **kw)
    np.testing.assert_array_equal(ftok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(flp.numpy(), np.asarray(want_lp), atol=2e-5)


@pytest.mark.parametrize("k,p", [(0, 1.0), (1, 1.0), (3, 1.0), (64, 1.0),
                                 (0, 0.7), (0, 1e-6), (4, 0.5)])
def test_top_k_top_p_filters_match_jax(k, p):
    logits, _ = _sampling_inputs(5, 3, 64)
    want = jserve_sampling.top_p_logits(
        jserve_sampling.top_k_logits(jnp.asarray(logits), k), p)
    got = serve_sampling.top_p_logits(
        serve_sampling.top_k_logits(_t(logits), k), p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_request_noise_is_gumbel_and_batch_independent():
    seeds = torch.tensor([0, 1, 2 ** 31 - 1, 12345])
    pos = torch.tensor([0, 7, 100, 4095])
    V = 50000
    g = serve_sampling.request_noise(seeds, pos, V)
    assert g.shape == (4, V) and g.dtype == torch.float32
    assert torch.isfinite(g).all()
    # Gumbel(0, 1): mean = Euler's gamma, std = pi / sqrt(6)
    assert abs(g.mean().item() - 0.5772) < 0.01
    assert abs(g.std().item() - 1.2825) < 0.01
    # a row depends only on its own (seed, position)
    for i in range(4):
        alone = serve_sampling.request_noise(seeds[i:i + 1], pos[i:i + 1], V)
        assert torch.equal(alone[0], g[i])
    assert not torch.equal(g[0], g[1])
    again = serve_sampling.request_noise(seeds.flip(0), pos.flip(0), V)
    assert torch.equal(again.flip(0), g)
