"""K3 flash attention: the port's plain version (on the CPU) against the
JAX package's Pallas kernel in interpret mode, its oracle and ``jax.grad``
of the oracle, on the same inputs made from a seed with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

# one intra-op thread: the test workers share the host's cores, and more
# threads in each oversubscribe them (the port's files take ~78 s under
# -n 6 with torch's default threads, ~50 s with one)
torch.set_num_threads(1)


# f32: the same math in another summation order.  bf16: both sides round
# one f32 result to bf16, a couple of bf16 ulps at |out| <= ~2.
TOL = {np.float32: 2e-5, jnp.bfloat16: 2e-2}


def _inputs(seed, B, H, KV, S, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, KV, S, D)).astype(np.float32),
            rng.standard_normal((B, KV, S, D)).astype(np.float32))


def _torch(x, dtype):
    t = torch.from_numpy(x)
    return t.bfloat16() if dtype == jnp.bfloat16 else t


def _jax(x, dtype):
    return jnp.asarray(x, dtype)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,D", [
    (1, 2, 1, 128, 32),
    (2, 4, 2, 256, 64),
    (1, 8, 8, 128, 128),  # MHA
    (2, 6, 2, 384, 64),   # 3-way GQA groups
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100),
                                           (False, 0)])
def test_flash_plain_matches_pallas_and_oracle(B, H, KV, S, D, dtype,
                                               causal, window):
    q, k, v = _inputs(B * 7 + S + D, B, H, KV, S, D)
    got, lse = fa.flash_attention_plain(
        *(_torch(x, dtype) for x in (q, k, v)), causal=causal, window=window)
    jq, jk, jv = (_jax(x, dtype) for x in (q, k, v))
    want = jfa.flash_attention_bhsd(jq, jk, jv, causal=causal, window=window,
                                    block_q=128, block_k=128, interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                      window=window)
    assert got.dtype == _torch(q, dtype).dtype
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    for w in (want, oracle):
        np.testing.assert_allclose(_np(got), _np(w), atol=TOL[dtype],
                                   rtol=TOL[dtype])


@pytest.mark.parametrize("S,causal,window", [
    (1, True, 0), (7, True, 0), (65, True, 0), (100, True, 16),
    (130, True, 64),   # S > window, tile-straddling S
    (97, False, 30),   # bidirectional window
    (50, False, 0),
])
def test_flash_plain_any_length_matches_oracle(S, causal, window):
    """The kernel takes any S (the Pallas kernel needs S % block == 0):
    the plain version against the oracle at ragged lengths."""
    q, k, v = _inputs(S, 2, 6, 2, S, 32)
    got, lse = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                        causal=causal, window=window)
    want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                    causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    # lse: the log-sum-exp of the scaled, masked scores, row by row
    s = np.einsum("bkgqd,bksd->bkgqs", q.reshape(2, 2, 3, S, 32), k)
    s = s.reshape(2, 6, S, S) / np.sqrt(32.0)
    ok = np.asarray(fa._mask(S, causal, window, "cpu"))
    s = np.where(ok, s, -1e30)
    m = s.max(-1, keepdims=True)
    want_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=2e-5, rtol=1e-5)


def test_torch_oracle_matches_jax_oracle():
    q, k, v = _inputs(5, 2, 4, 2, 40, 16)
    for causal, window in ((True, 0), (True, 9), (False, 0)):
        got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                      causal=causal, window=window)
        want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                        causal=causal, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("B,H,KV,S,D,causal,window", [
    (1, 2, 1, 16, 8, True, 0),
    (2, 4, 2, 33, 16, True, 0),    # GQA: dk/dv sum over the group
    (1, 6, 2, 40, 16, True, 12),   # window
    (2, 4, 4, 24, 8, False, 0),    # bidirectional
    (1, 8, 2, 30, 16, False, 7),   # bidirectional window
])
def test_flash_plain_grads_match_jax_grad(B, H, KV, S, D, causal, window):
    """Autograd through the plain version (the backward kernel's reference
    on the card) against jax.grad of the JAX oracle: dq, dk and dv each."""
    q, k, v = _inputs(S + H, B, H, KV, S, D)
    dout = np.random.default_rng(S).standard_normal(q.shape).astype(
        np.float32)

    def jloss(q, k, v):
        o = jref.flash_attention_ref(q, k, v, causal=causal, window=window)
        return jnp.sum(o * dout)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, _ = fa.flash_attention_plain(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("B,H,KV,S,D", [
    (2, 4, 4, 40, 16),   # MHA: dv is dout itself
    (1, 6, 2, 33, 8),    # GQA: dv sums the group's douts
    (3, 2, 1, 1, 32),    # one token: every row sees one key at any window
])
def test_flash_plain_grads_are_exact_on_one_key_rows(B, H, KV, S, D):
    """Window 1, so every row sees only its own key: P is exactly 1 there,
    dS = P (dP - rowsum(P dP)) is exactly 0, so dq and dk are exact zeros
    and dv the group's sum of dout, in autograd through the plain version
    (the backward kernel's reference on the card) as in jax.grad of the
    JAX oracle."""
    q, k, v = _inputs(S * 5 + H, B, H, KV, S, D)
    dout = np.random.default_rng(S + D).standard_normal(q.shape).astype(
        np.float32)

    def jloss(q, k, v):
        o = jref.flash_attention_ref(q, k, v, causal=True, window=1)
        return jnp.sum(o * dout)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, _ = fa.flash_attention_plain(*leaves, causal=True, window=1)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    group_sum = dout.reshape(B, KV, H // KV, S, D).sum(axis=2)
    for g in (got, [torch.from_numpy(np.array(w)) for w in want]):
        assert (g[0] == 0).all() and (g[1] == 0).all()
        np.testing.assert_allclose(g[2].numpy(), group_sum, atol=1e-6,
                                   rtol=1e-6)
    if H == KV:
        assert np.array_equal(got[2].numpy(), dout)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 50),
                                           (False, 0)])
def test_flash_ops_model_layout_matches_jax_ops(causal, window):
    """ops.flash_attention in the model layout (B, S, H, D) on the CPU
    against the JAX dispatch (Pallas interpret)."""
    rng = np.random.default_rng(1)
    B, S, H, KV, D = 2, 128, 4, 2, 32
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, window=window)
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                window=window)
    assert got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_flash_cuda_wrappers_refuse_cpu_tensors():
    q, k, v = map(torch.from_numpy, _inputs(0, 1, 2, 1, 16, 8))
    f0, b0 = fa.flash_attention_bhsd.launches, fa.flash_attention_bwd.launches
    with pytest.raises(ValueError):
        fa.flash_attention_bhsd(q, k, v)
    out, lse = fa.flash_attention_plain(q, k, v)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, out, lse, torch.ones_like(out))
    assert fa.flash_attention_bhsd.launches == f0
    assert fa.flash_attention_bwd.launches == b0


def test_bf16_views_are_staged_with_aligned_rows():
    """The forward kernel's bf16 path reads rows by 16-byte TMA copies: the
    wrapper keeps views whose rows are aligned, copies those that are not
    (into rows padded to a multiple of 8 elements where D % 8 != 0), and
    leaves f32 (the CUDA-core kernel) as it is."""
    bf = torch.bfloat16
    dense = torch.zeros((2, 4, 33, 64), dtype=bf)
    assert dense.data_ptr() % 16 == 0
    model = torch.zeros((2, 33, 4, 64), dtype=bf).transpose(1, 2)
    # b and h have one index each: their (odd) strides are never taken
    single = torch.zeros(512, dtype=bf).as_strided((1, 1, 4, 64),
                                                   (3, 5, 64, 1))
    offset = torch.zeros(2 * 4 * 33 * 64 + 1, dtype=bf)[1:].view(2, 4, 33,
                                                                   64)
    wide = torch.zeros((2, 4, 33, 68), dtype=bf)[..., :64]
    for t in (dense, model, single):
        assert fa.rows_aligned(t)
        assert fa._staged(t) is t
    for t in (offset, wide):
        assert not fa.rows_aligned(t)
        c = fa._staged(t)
        assert c.data_ptr() != t.data_ptr() and fa.rows_aligned(c)
        assert torch.equal(c, t)
    odd = torch.randn((2, 4, 33, 100)).to(bf)  # rows 200 bytes apart
    assert not fa.rows_aligned(odd)
    c = fa._staged(odd)
    assert fa.rows_aligned(c) and c.stride(2) == 104 and torch.equal(c, odd)
    f32 = torch.zeros(2 * 4 * 33 * 64 + 1)[1:].view(2, 4, 33, 64)
    assert fa._staged(f32) is f32
