"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs on a machine
without them:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gmm as gmm
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.kernels import sampling as ks
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels import ssm_update as ssu
from repro_torch.models import forward, init_model
from repro_torch.serve import Engine, PagedEngine, covers
from repro_torch.serve.sampling import request_noise
from repro_torch.train import TrainHParams, policy_loss
from repro_torch.utils.treeutil import tree_leaves, tree_map, tree_unflatten

# one intra-op thread: the test workers share the host's cores, and more
# threads in each oversubscribe them (the port's files take ~78 s under
# -n 6 with torch's default threads, ~50 s with one)
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# f32: summation order only.  bf16: kernel and plain version round the
# same f32 result once, so they differ by at most a couple of bf16 ulps
# at |out| <= ~2.
PA_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _paged_inputs(seed, B, H, KV, D, page, nb, dtype, dev):
    rng = np.random.default_rng(seed)
    P = B * nb + 1
    q = torch.from_numpy(rng.standard_normal((B, H, D), np.float32))
    kp = torch.from_numpy(rng.standard_normal((P, page, KV, D), np.float32))
    vp = torch.from_numpy(rng.standard_normal((P, page, KV, D), np.float32))
    kp[0] = 1e3  # poisoned trash page
    vp[0] = 1e3
    tables = np.stack([rng.permutation(np.arange(1, P))[:nb]
                       for _ in range(B)]).astype(np.int32)
    lens = np.array([(i * 7) % (nb * page + 1) for i in range(B)], np.int32)
    lens[-1] = nb * page  # one full table
    return (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype),
            torch.from_numpy(tables).to(dev), torch.from_numpy(lens).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,D,page,nb", [
    (1, 2, 1, 32, 8, 2),
    (3, 4, 2, 16, 8, 4),     # GQA groups of 2
    (2, 8, 8, 64, 16, 3),    # MHA
    (4, 6, 2, 32, 4, 5),     # 3-way GQA groups
    (3, 16, 2, 64, 2, 40),   # 2-token pages, 80-token tables
    (8, 32, 4, 128, 16, 9),  # yi-9b heads
    (8, 24, 8, 64, 16, 36),  # granite-moe-3b-a800m heads (3-way GQA)
    (1, 32, 4, 128, 16, 256),  # one 4096-token context: 16 tiles a split
    (3, 8, 2, 64, 64, 5),      # pages larger than the kernel's 32-key tile
    # stablelm-12b heads at the RLHF engine's 64-page tables: D > 128
    # takes a lane's second accumulator column, which lanes 0-7 carry
    (8, 32, 8, 160, 16, 64),
    (2, 8, 2, 256, 16, 5),     # K1's largest head_dim: both columns full
])
def test_paged_attention_kernel_matches_plain(dev, B, H, KV, D, page, nb,
                                              dtype):
    q, kp, vp, tables, lens = _paged_inputs(
        B * 100 + page, B, H, KV, D, page, nb, dtype, dev)
    got = pa.paged_attention_bhd(q, kp, vp, tables, lens)
    want = pa.paged_attention_plain(q, kp, vp, tables, lens)
    oracle = ref.paged_attention_ref(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    empty = lens == 0
    assert bool((got[empty] == 0).all())  # empty context: zeros
    tol = PA_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(got.float(), oracle.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,D", [(32, 4, 128), (24, 8, 64),
                                    (32, 8, 160)])
def test_paged_attention_kernel_split_edges(dev, H, KV, D, dtype):
    """yi-9b's, granite-moe's and stablelm-12b's heads at nb 64 (32-token tiles dealt to
    8 splits): contexts that end mid-page, exactly on a tile boundary and
    one past it, and a batch in which only one row reaches the last
    split's tiles."""
    page, nb = 16, 64
    tile, n_split = pa.split_plan(nb, page)
    assert (tile, n_split) == (32, 8)
    q, kp, vp, tables, _ = _paged_inputs(H + D, 8, H, KV, D, page, nb,
                                         dtype, dev)
    lens = torch.tensor([0, 1, 37, 2 * tile, 2 * tile + 1, 200,
                         (n_split - 1) * tile, nb * page],
                        dtype=torch.int32, device=dev)
    got = pa.paged_attention_bhd(q, kp, vp, tables, lens)
    want = pa.paged_attention_plain(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    assert bool((got[0] == 0).all())
    tol = PA_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_is_repeatable_bitwise(dev, dtype):
    q, kp, vp, tables, lens = _paged_inputs(11, 8, 32, 4, 128, 16, 64,
                                            dtype, dev)
    a = pa.paged_attention_bhd(q, kp, vp, tables, lens)
    b = pa.paged_attention_bhd(q, kp, vp, tables, lens)
    assert torch.equal(a, b)


def test_paged_attention_kernel_mixed_types(dev):
    q, kp, vp, tables, lens = _paged_inputs(
        5, 4, 8, 2, 64, 16, 3, torch.float32, dev)
    got = pa.paged_attention_bhd(q, kp.bfloat16(), vp.bfloat16(), tables,
                                 lens)
    want = pa.paged_attention_plain(q, kp.bfloat16(), vp.bfloat16(), tables,
                                    lens)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _sampling_inputs(seed, B, V, dev):
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(4.0 * rng.standard_normal((B, V), np.float32))
    noise = request_noise(torch.arange(B) + seed, torch.arange(B) * 3, V)
    return logits.to(dev), noise.to(dev)


@pytest.mark.parametrize("B,V", [(1, 64), (4, 128), (3, 250), (8, 65536),
                                 (8, 51200), (8, 32768)])
@pytest.mark.parametrize("temperature,top_k,top_p,vocab_size", [
    (0.0, 0, 1.0, 0),     # greedy
    (1.0, 0, 1.0, 0),     # plain categorical
    (0.7, 5, 1.0, 0),     # top-k only
    (1.0, 0, 0.9, 0),     # nucleus only
    (0.8, 12, 0.7, 40),   # all filters + padded vocab mask
    (1.0, 50, 0.9, 60),
])
def test_fused_sample_kernel_matches_plain(dev, B, V, temperature, top_k,
                                           top_p, vocab_size):
    logits, noise = _sampling_inputs(B * 7 + V, B, V, dev)
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p,
              vocab_size=vocab_size)
    tok, lp = ks.fused_sample_bv(logits, noise, **kw)
    want_tok, want_lp = ks.fused_sample_plain(logits, noise, **kw)
    oracle_tok, _ = ref.fused_sample_ref(logits, noise, **kw)
    torch.cuda.synchronize()
    assert torch.equal(tok, want_tok)
    assert torch.equal(tok, oracle_tok)
    # |logprob| grows with V: f32 sums over V entries in another order
    tol = 2e-5 if V <= 256 else 1e-4
    torch.testing.assert_close(lp, want_lp, atol=tol, rtol=tol)


SAMPLING_CASES = ["first_index_ties", "ties_straddle_kth", "max_duplicates",
                  "dyadic_mass_hits_p", "all_equal", "top_k_at_least_V_or_1",
                  "fewer_valid_than_k", "top_p_without_top_k"]


def adversarial_sampling_rows(case):
    """(logits, gumbel, [(filter kwargs, {row: token} or None)]) of one
    adversarial case of the fused sampler (K2), numpy f32 (B 4, V 64)."""
    rng = np.random.default_rng(len(case))
    V = 64
    logits = np.zeros((4, V), np.float32)
    gumbel = rng.gumbel(size=(4, V)).astype(np.float32)
    if case == "first_index_ties":
        # ties go to the first index in every reduction; duplicates at the
        # top-k edge count once per occurrence; the top-p cutoff is kept
        logits[0, [7, 20]] = 3.0                 # greedy / Gumbel-max tie
        logits[1, [3, 9, 30, 31]] = 2.0          # four duplicates at the k edge
        logits[1, 50] = 5.0
        logits[2] = np.linspace(-1, 1, V)
        logits[2, 60:64] = 4.0                   # duplicates in the nucleus
        logits[3, 1] = 6.0                       # one token holds the mass
        gumbel[:] = 0.0
        want = {0: 7, 3: 1}
        return logits, gumbel, [
            (dict(temperature=0.0), want),
            (dict(temperature=1.0, top_k=3), want),
            (dict(temperature=1.0, top_k=5, top_p=0.5), want),
            (dict(temperature=0.5, top_p=0.3), want),
            (dict(temperature=1.0, top_p=1e-6, vocab_size=40), want)]
    if case == "ties_straddle_kth":
        # the k-th value has duplicates on both sides of k: all are kept
        logits[:] = rng.standard_normal((4, V)) - 10.0
        logits[:, [2, 11, 40, 41, 63]] = 1.0
        logits[:, 5] = 4.0
        gumbel[:, [41, 63]] += 30.0
        gumbel[:, 11] += 60.0  # a kept duplicate past k wins
        return logits, gumbel, [
            (dict(temperature=1.0, top_k=k, top_p=p), {r: 11 for r in range(4)})
            for k in (2, 3, 4, 6) for p in (1.0, 0.99)]
    if case == "max_duplicates":
        logits[:] = rng.standard_normal((4, V))
        logits[:, [9, 17, 33]] = 8.0
        gumbel[:, 33] += 30.0
        return logits, gumbel, [
            (dict(temperature=0.0), {r: 9 for r in range(4)}),
            (dict(temperature=1.0, top_k=1), {r: 33 for r in range(4)}),
            (dict(temperature=0.7, top_p=0.05), {r: 33 for r in range(4)})]
    if case == "dyadic_mass_hits_p":
        # masses exp(x - max) are exactly 1 (x = 0, -1e-30, -2e-30), so the
        # prefix masses 2/8, 4/8, 8/8 hit p exactly: a prefix reaching p
        # keeps its last token and nothing after it
        logits[:, 0:2] = 0.0
        logits[:, 2:4] = -1e-30
        logits[:, 4:8] = -2e-30
        gumbel[:] = 0.0
        gumbel[:, 3] = 5.0
        gumbel[:, 5] = 10.0
        kw = dict(temperature=1.0, vocab_size=8)
        return logits, gumbel, [
            (dict(kw, top_p=0.25), {r: 0 for r in range(4)}),
            (dict(kw, top_p=0.5), {r: 3 for r in range(4)}),
            (dict(kw, top_p=0.75), {r: 5 for r in range(4)}),
            (dict(kw, top_p=0.5, top_k=6, temperature=0.5),
             {r: 3 for r in range(4)})]
    if case == "all_equal":
        want = {r: int(np.argmax(gumbel[r])) for r in range(4)}
        return logits, gumbel, [
            (dict(temperature=0.0), {r: 0 for r in range(4)}),
            (dict(temperature=1.0, top_k=5), want),
            (dict(temperature=1.0, top_p=0.5), want),
            (dict(temperature=1.0, top_k=1, top_p=0.1), want)]
    if case == "top_k_at_least_V_or_1":
        logits[:] = 4.0 * rng.standard_normal((4, V))
        top = {r: int(np.argmax(logits[r])) for r in range(4)}
        return logits, gumbel, [
            (dict(temperature=1.0, top_k=V), None),
            (dict(temperature=1.0, top_k=V + 5, top_p=0.9), None),
            (dict(temperature=1.0, top_k=1), top),
            (dict(temperature=0.6, top_k=1, top_p=0.5), top)]
    if case == "fewer_valid_than_k":
        logits[:] = rng.standard_normal((4, V))
        return logits, gumbel, [
            (dict(temperature=t, top_k=20, top_p=p, vocab_size=5), None)
            for t in (0.8, 1.3) for p in (1.0, 0.9)]
    assert case == "top_p_without_top_k"
    logits[:] = 4.0 * rng.standard_normal((4, V))
    return logits, gumbel, [(dict(temperature=t, top_p=p), None)
                            for t, p in ((1.0, 0.3), (0.7, 0.9),
                                         (1.0, 1e-6))]


@pytest.mark.parametrize("case", SAMPLING_CASES)
def test_fused_sample_kernel_ties_and_duplicates(dev, case):
    """The adversarial rows (ties at the k-th value, duplicated maxima,
    prefix masses that hit p exactly, ...): the kernel's tokens are the
    plain version's and the expected ones; logprobs agree."""
    logits, noise, runs = adversarial_sampling_rows(case)
    logits, noise = torch.from_numpy(logits).to(dev), torch.from_numpy(
        noise).to(dev)
    for kw, want in runs:
        tok, lp = ks.fused_sample_bv(logits, noise, **kw)
        want_tok, want_lp = ks.fused_sample_plain(logits, noise, **kw)
        assert torch.equal(tok, want_tok), (case, kw)
        torch.testing.assert_close(lp, want_lp, atol=2e-5, rtol=2e-5)
        for r, t in (want or {}).items():
            assert tok[r].item() == t, (case, kw, r)


def test_request_noise_same_bits_on_card_and_cpu(dev):
    seeds = torch.tensor([0, 1, 2 ** 31 - 1, 12345])
    pos = torch.tensor([0, 7, 100, 4095])
    cpu = request_noise(seeds, pos, 4096)
    card = request_noise(seeds.to(dev), pos.to(dev), 4096).cpu()
    assert torch.equal(cpu, card)


def test_launch_counters_count_kernel_launches_only(dev):
    q, kp, vp, tables, lens = _paged_inputs(
        1, 2, 8, 2, 32, 8, 2, torch.float32, dev)
    n0 = pa.paged_attention_bhd.launches
    pa.paged_attention_plain(q, kp, vp, tables, lens)
    pa.paged_attention_bhd(q, kp, vp, tables, lens)
    assert pa.paged_attention_bhd.launches == n0 + 1
    logits, noise = _sampling_inputs(0, 2, 64, dev)
    m0 = ks.fused_sample_bv.launches
    ks.fused_sample_plain(logits, noise)
    ks.fused_sample_bv(logits, noise)
    assert ks.fused_sample_bv.launches == m0 + 1
    q, k, v, dout = _flash_inputs(0, 1, 2, 1, 64, 32, torch.float32, dev)
    f0, b0 = fa.flash_attention_bhsd.launches, fa.flash_attention_bwd.launches
    fa.flash_attention_plain(q, k, v)
    out, lse = fa.flash_attention_bhsd(q, k, v)
    fa.flash_attention_bwd(q, k, v, out, lse, dout)
    assert fa.flash_attention_bhsd.launches == f0 + 1
    assert fa.flash_attention_bwd.launches == b0 + 1


# ---------------------------------------------------------------------------
# K3: flash attention forward and backward
# ---------------------------------------------------------------------------
# f32: summation order only.  bf16: both round the same f32 result once.
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# grads, relative to the largest |grad|: f32 summation order; bf16 inputs
# and outputs rounded, and delta = rowsum(dO * O) taken from the bf16 O
GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _flash_inputs(seed, B, H, KV, S, D, dtype, dev):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(dev, dtype) for shape in
               ((B, H, S, D), (B, KV, S, D), (B, KV, S, D)))
    dout = torch.from_numpy(rng.standard_normal((B, H, S, D), np.float32))
    return q, k, v, dout.to(dev, dtype)


FLASH_CASES = [
    (1, 2, 1, 128, 32, True, 0),
    (2, 4, 2, 256, 64, True, 100),
    (1, 8, 8, 128, 128, False, 0),   # MHA, bidirectional
    (2, 6, 2, 384, 64, True, 0),     # 3-way GQA groups
    (2, 4, 2, 1, 16, True, 0),       # one token
    (1, 4, 1, 100, 64, True, 0),     # tail: S not a multiple of 64
    (2, 4, 2, 200, 48, True, 70),    # window straddles tiles, D % 16 != 0
    (1, 4, 2, 130, 128, False, 40),  # bidirectional window
    (2, 32, 4, 1000, 128, True, 256),  # yi-9b heads, tail + window
    (16, 32, 4, 512, 128, True, 0),    # yi-9b logprob recompute
    (2, 32, 4, 1024, 128, True, 0),    # yi-9b train microbatch
    (16, 24, 8, 512, 64, True, 0),     # granite logprob recompute
    (2, 24, 8, 1024, 64, True, 0),     # granite train microbatch
    (2, 32, 32, 300, 80, True, 64),    # zamba2 heads (MHA, D 80), window
    (2, 32, 32, 1024, 80, True, 4096),  # zamba2 train microbatch
    # whisper-large-v3's encoder (MHA, D 64, bidirectional): the train
    # microbatch, S 1500 a 28-row tail on 64-row tiles
    (2, 20, 20, 1500, 64, False, 0),
    (2, 20, 20, 448, 64, True, 0),     # whisper decoder train microbatch
]
# the kernels also at the bf16 kernel's edges
FLASH_EDGE_CASES = [
    (2, 4, 2, 300, 40, True, 0),     # D 40: zero-padded to 48 in the kernel
    (1, 4, 2, 257, 100, True, 33),   # D 100: rows not 16-byte aligned
    (1, 8, 2, 2048, 128, True, 0),   # a long sequence
    (3, 8, 2, 1, 128, True, 0),      # one token at yi-9b's head width
    (2, 32, 8, 300, 160, True, 64),  # stablelm-12b heads (D 160), tail, window
    (1, 32, 8, 1024, 160, True, 0),  # stablelm-12b train microbatch
    (2, 4, 2, 130, 150, False, 40),  # D 150: half of the third box is fill
    (1, 4, 2, 200, 192, True, 70),   # the backward's widest head_dim
]
# the forward past the backward's limit, up to its own (wgmma's N of 256)
FLASH_FWD_CASES = FLASH_CASES + FLASH_EDGE_CASES + [
    (1, 4, 2, 200, 256, True, 50),
    (2, 4, 1, 130, 250, False, 0),   # D % 16 != 0 at the top
    (8, 20, 20, 448, 64, True, 0),   # whisper decoder recompute
    (8, 64, 8, 512, 128, True, 0),   # llama-3.2-vision self layers, recompute
]
# and the backward at window 1, where every row sees one key
FLASH_BWD_CASES = FLASH_CASES + FLASH_EDGE_CASES + [
    (2, 4, 4, 200, 128, True, 1), (2, 4, 4, 100, 160, True, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels_refuse_head_dim_past_their_limit(dev, dtype):
    """The forward takes head_dim <= 256, the backward <= 192; past its
    limit a wrapper raises, naming it, and launches nothing."""
    f0, b0 = fa.flash_attention_bhsd.launches, fa.flash_attention_bwd.launches
    q, k, v, dout = _flash_inputs(1, 1, 2, 1, 64, fa.MAX_HEAD_DIM + 8, dtype,
                                  dev)
    with pytest.raises(ValueError, match=f"1..{fa.MAX_HEAD_DIM}"):
        fa.flash_attention_bhsd(q, k, v)
    q, k, v, dout = _flash_inputs(1, 1, 2, 1, 64, fa.MAX_HEAD_DIM_BWD + 8,
                                  dtype, dev)
    out, lse = fa.flash_attention_bhsd(q, k, v)
    with pytest.raises(ValueError, match=f"1..{fa.MAX_HEAD_DIM_BWD}"):
        fa.flash_attention_bwd(q, k, v, out, lse, dout)
    assert fa.flash_attention_bhsd.launches == f0 + 1
    assert fa.flash_attention_bwd.launches == b0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,D,causal,window", FLASH_FWD_CASES)
def test_flash_attention_kernel_matches_plain(dev, B, H, KV, S, D, causal,
                                              window, dtype):
    q, k, v, _ = _flash_inputs(S + D, B, H, KV, S, D, dtype, dev)
    out, lse = fa.flash_attention_bhsd(q, k, v, causal=causal, window=window)
    want, want_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                              window=window)
    oracle = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    tol = FA_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(out.float(), oracle.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,D,causal,window", FLASH_BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain_autograd(
        dev, B, H, KV, S, D, causal, window, dtype):
    q, k, v, dout = _flash_inputs(S * 3 + D, B, H, KV, S, D, dtype, dev)
    out, lse = fa.flash_attention_bhsd(q, k, v, causal=causal, window=window)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                 window=window)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    plain, _ = fa.flash_attention_plain(*leaves, causal=causal,
                                        window=window)
    want = torch.autograd.grad(plain, leaves, dout)
    torch.cuda.synchronize()
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        scale = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= GRAD_RTOL[dtype] * scale + 1e-6, (name, err, scale)
    if S == 1 or window == 1:  # one key a row: dS is exactly zero
        assert bool((got[0] == 0).all()) and bool((got[1] == 0).all())
    if window == 1 and H == KV:  # and P exactly 1: dv is dout itself
        assert torch.equal(got[2], dout)


def test_flash_attention_bwd_kernel_is_repeatable_bitwise(dev):
    """yi-9b's train microbatch: no atomics, sums in a fixed order."""
    q, k, v, dout = _flash_inputs(9, 2, 32, 4, 1024, 128, torch.float32,
                                  dev)
    out, lse = fa.flash_attention_bhsd(q, k, v, causal=True)
    a = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    b = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_attention_bwd_kernel_is_repeatable_bitwise_bidirectional(dev):
    """whisper-large-v3's encoder (bidirectional, one key tile a block):
    the same bits on a second call, and the stored dS scratch as the C
    entry sizes it."""
    q, k, v, dout = _flash_inputs(10, 2, 20, 20, 1500, 64, torch.float32,
                                  dev)
    out, lse = fa.flash_attention_bhsd(q, k, v, causal=False)
    a = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=False)
    b = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    floats = _build.library().flash_attention_bwd_workspace(2, 20, 20, 1500,
                                                            64, 0, 0)
    assert floats == 2 * 20 * 24 * 24 * 64 * 64 + 2 * 20 * 1500


@pytest.mark.parametrize("how", ["offset", "stride"])
def test_flash_attention_kernel_copies_unaligned_views(dev, how):
    """bf16 views whose rows do not start 16-byte aligned (a base one
    element off, or rows 68 elements apart) go through the wrapper's copy
    into the tensor-core kernel and give the plain version's output."""
    B, H, KV, S, D = 2, 4, 2, 130, 64
    g = torch.Generator(device=dev).manual_seed(7)

    def view(heads):
        if how == "offset":
            base = torch.randn(B * heads * S * D + 1, generator=g, device=dev)
            return base.to(torch.bfloat16)[1:].view(B, heads, S, D)
        return torch.randn((B, heads, S, D + 4), generator=g, device=dev
                           ).to(torch.bfloat16)[..., :D]

    q, k, v = view(H), view(KV), view(KV)
    assert not any(map(fa.rows_aligned, (q, k, v)))
    out, lse = fa.flash_attention_bhsd(q, k, v, causal=True, window=0)
    want, want_lse = fa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    tol = FA_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


def test_flash_attention_autograd_in_model_layout(dev):
    """ops.flash_attention on (B, S, H, D) views: the kernels read and
    write through strides, and autograd reaches q, k and v."""
    B, S, H, KV, D = 2, 77, 8, 2, 64
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, np.float32)).to(dev)
               for sh in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    dout = torch.from_numpy(rng.standard_normal((B, S, H, D), np.float32))
    dout = dout.to(dev)
    grads = []
    for fn in (ops.flash_attention, _plain_model_layout):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, causal=True, window=0)
        grads.append((out, *torch.autograd.grad(out, leaves, dout)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _plain_model_layout(q, k, v, *, causal, window):
    out, _ = fa.flash_attention_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window)
    return out.transpose(1, 2)


@pytest.mark.parametrize("remat", [False, True])
def test_forward_and_policy_grads_card_vs_cpu(dev, remat):
    """Reduced yi-9b in f32 from the same weights: logits and every
    gradient of the policy loss on the card (K3 forward and backward,
    re-run inside the backward under remat) against the CPU (the plain
    version).  f32 on both sides: cuBLAS and the CPU sum in other
    orders."""
    cfg = get_config("yi-9b").reduced()
    cpu = init_model(torch.Generator().manual_seed(7), cfg, torch.float32,
                     "cpu")
    rng = np.random.default_rng(7)
    B, S = 2, 90
    mask = np.zeros((B, S), np.float32)
    mask[:, 30:] = 1.0
    batch = {"tokens": torch.from_numpy(rng.integers(3, cfg.vocab_size,
                                                     (B, S))),
             "old_logprobs": torch.full((B, S), -6.0),
             "advantages": torch.from_numpy(
                 rng.standard_normal((B, S)).astype(np.float32) * mask),
             "loss_mask": torch.from_numpy(mask)}
    hp = TrainHParams(remat=remat, entropy_coef=0.01)
    out = []
    for device in ("cpu", dev):
        params = tree_map(lambda t: t.to(device).requires_grad_(), cpu)
        mb = {k: v.to(device) for k, v in batch.items()}
        logits, _ = forward(params, cfg, mb["tokens"], remat=remat)
        loss, _ = policy_loss(cfg, hp, params, mb)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        out.append((logits.detach().cpu(), float(loss.detach()),
                    [g.cpu() for g in grads]))
    (lc, loss_c, gc), (lg, loss_g, gg) = out
    torch.testing.assert_close(lg, lc, atol=1e-4, rtol=1e-4)
    assert abs(loss_g - loss_c) <= 1e-4 * abs(loss_c) + 1e-6
    for a, b in zip(gg, gc):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max() + 1e-7


def _open_gates(params):
    """A VLM's cross gates at 0.5 (``init_model`` zeros them, and tanh(0)
    would skip the cross layers)."""
    if "cross_layers" in params:
        params["cross_layers"]["gate"].fill_(0.5)
    return params


def _embeddings(cfg, B, rng):
    """The stub frontend's image tokens or audio frames, as a batch's
    entries."""
    if cfg.kind == "vlm":
        key, n = "image_embeds", cfg.num_image_tokens
    elif cfg.kind == "encdec":
        key, n = "frame_embeds", cfg.encoder_seq_len
    else:
        return {}
    return {key: torch.from_numpy(
        rng.standard_normal((B, n, cfg.d_model)).astype(np.float32))}


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-large-v3"])
def test_cross_kinds_forward_and_policy_grads_card_vs_cpu(dev, arch):
    """Reduced VLM and encoder-decoder in f32 from the same weights, with
    their embeddings: logits and every gradient of the policy loss on the
    card (K3 causal in the decoder, bidirectional in the encoder, and its
    backward) against the CPU."""
    cfg = get_config(arch).reduced()
    cpu = _open_gates(init_model(torch.Generator().manual_seed(8), cfg,
                                 torch.float32, "cpu"))
    rng = np.random.default_rng(8)
    B, S = 2, 70
    mask = np.zeros((B, S), np.float32)
    mask[:, 20:] = 1.0
    batch = {"tokens": torch.from_numpy(rng.integers(3, cfg.vocab_size,
                                                     (B, S))),
             "old_logprobs": torch.full((B, S), -6.0),
             "advantages": torch.from_numpy(
                 rng.standard_normal((B, S)).astype(np.float32) * mask),
             "loss_mask": torch.from_numpy(mask),
             **_embeddings(cfg, B, rng)}
    hp = TrainHParams(entropy_coef=0.01)
    out = []
    for device in ("cpu", dev):
        params = tree_map(lambda t: t.to(device).requires_grad_(), cpu)
        mb = {k: v.to(device) for k, v in batch.items()}
        fa.flash_attention_bhsd.launches = 0
        loss, _ = policy_loss(cfg, hp, params, mb)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        out.append((float(loss.detach()), [g.cpu() for g in grads]))
    # one K3 a self-attention layer, the encoder's among them
    cross = cfg.num_layers // cfg.cross_attn_every if cfg.kind == "vlm" else 0
    assert fa.flash_attention_bhsd.launches == (
        cfg.num_layers - cross + cfg.num_encoder_layers)
    (loss_c, gc), (loss_g, gg) = out
    assert abs(loss_g - loss_c) <= 1e-4 * abs(loss_c) + 1e-6
    for a, b in zip(gg, gc):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max() + 1e-7


@pytest.mark.parametrize("arch,window", [
    ("yi-9b", 0), ("yi-9b", 8), ("granite-moe-3b-a800m", 0),
    ("mamba2-370m", 0), ("zamba2-2.7b", 0), ("llama-3.2-vision-90b", 0),
    ("whisper-large-v3", 0)])
def test_static_engine_card_vs_cpu(dev, arch, window):
    """The static engine on reduced models in f32 from the same weights,
    on the card and on the CPU: the same tokens, logprobs within 1e-3,
    the sampling kernel launched once a round; at temperature 0 the
    card's static tokens are its paged engine's where a layout covers
    the arch."""
    cfg = get_config(arch).reduced().replace(sliding_window=window)
    cpu = _open_gates(init_model(torch.Generator().manual_seed(9), cfg,
                                 torch.float32, "cpu"))
    gpu = tree_map(lambda t: t.to(dev), cpu)
    prompts = np.random.default_rng(9).integers(3, cfg.vocab_size, (4, 19))
    prompts[1, :5] = 0  # a left-padded row
    for temp, k, p in ((0.0, 0, 1.0), (1.0, 8, 0.9)):
        kw = dict(max_new_tokens=10, temperature=temp, top_k=k, top_p=p,
                  eos_token=-1)
        ks.fused_sample_bv.launches = 0
        got = Engine(cfg, device=dev, **kw).generate(gpu, prompts, seed=3)
        assert ks.fused_sample_bv.launches == 10
        want = Engine(cfg, device="cpu", **kw).generate(cpu, prompts, seed=3)
        assert torch.equal(got.tokens, want.tokens), (temp, got.tokens,
                                                      want.tokens)
        assert (got.logprobs - want.logprobs).abs().max() <= 1e-3
        if temp == 0.0 and covers(cfg):
            paged = PagedEngine(cfg, max_batch=4, page_size=4,
                                max_new_tokens=10, temperature=0.0,
                                eos_token=-1, device=dev).generate(
                gpu, prompts, seed=3)
            assert torch.equal(paged.tokens, got.tokens)


def test_moe_forward_and_policy_grads_card_vs_cpu(dev):
    """Reduced granite-moe in f32 from the same weights: logits, aux and
    every gradient of the policy loss (router and experts among them) on
    the card against the CPU.  The capacity dispatch of ``moe_block`` runs
    on both; f32 on both sides, so only the summation order differs."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    cpu = init_model(torch.Generator().manual_seed(8), cfg, torch.float32,
                     "cpu")
    rng = np.random.default_rng(8)
    B, S = 2, 70
    mask = np.zeros((B, S), np.float32)
    mask[:, 20:] = 1.0
    batch = {"tokens": torch.from_numpy(rng.integers(3, cfg.vocab_size,
                                                     (B, S))),
             "old_logprobs": torch.full((B, S), -6.0),
             "advantages": torch.from_numpy(
                 rng.standard_normal((B, S)).astype(np.float32) * mask),
             "loss_mask": torch.from_numpy(mask)}
    hp = TrainHParams(entropy_coef=0.01)
    out = []
    for device in ("cpu", dev):
        params = tree_map(lambda t: t.to(device).requires_grad_(), cpu)
        mb = {k: v.to(device) for k, v in batch.items()}
        loss, m = policy_loss(cfg, hp, params, mb)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        out.append((float(loss.detach()), float(m["aux_loss"].detach()),
                    [g.cpu() for g in grads]))
    (loss_c, aux_c, gc), (loss_g, aux_g, gg) = out
    assert abs(loss_g - loss_c) <= 1e-4 * abs(loss_c) + 1e-6
    assert abs(aux_g - aux_c) <= 1e-5 * abs(aux_c) and aux_c > 0
    for a, b in zip(gg, gc):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max() + 1e-7


# ---------------------------------------------------------------------------
# K4 and K5: grouped matmul and the drop-free MoE decode
# ---------------------------------------------------------------------------
# relative to the largest |out|.  f32: summation order only.  bf16: both
# round f32 sums that differ only in order to bf16 (2**-8 relative), and
# K5's rounded intermediates (g, u, silu(g) * u) carry such an ulp into
# the down product.
GMM_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,D,F,ragged", [
    (40, 8, 1536, 512, False),    # granite decode: gate / up
    (40, 8, 512, 1536, False),    # granite decode: down
    (40, 256, 1536, 512, True),   # granite prefill chunk, with row counts
    (40, 256, 512, 1536, True),
    (3, 13, 100, 70, True),       # nothing divides a tile or a vector
    (2, 1, 7, 5, False),
    # capacities that end mid n-tile (9, 17, 100), fill one or several
    # exactly (16, 64) or span two row blocks (100), at gate/up widths
    *[(6, C, 1536, 512, ragged) for C in (9, 16, 17, 64, 100)
      for ragged in (False, True)],
])
def test_grouped_matmul_kernel_matches_plain(dev, E, C, D, F, ragged, dtype):
    rng = np.random.default_rng(E * C + D)
    buf = torch.from_numpy(rng.standard_normal((E, C, D), np.float32))
    w = torch.from_numpy(rng.standard_normal((E, D, F), np.float32)
                         / np.sqrt(D))
    buf, w = buf.to(dev, dtype), w.to(dev, dtype)
    rows = None
    if ragged:  # some experts empty, some full, the rest in between
        r = rng.integers(0, C + 1, size=E)
        r[0], r[-1] = 0, C
        rows = torch.from_numpy(r.astype(np.int32)).to(dev)
    got = gmm.grouped_matmul(buf, w, rows)
    want = gmm.grouped_matmul_plain(buf, w, rows)
    oracle = ref.grouped_matmul_ref(buf, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (E, C, F)
    live = (torch.ones((E, C), dtype=torch.bool, device=dev) if rows is None
            else torch.arange(C, device=dev)[None] < rows.long()[:, None])
    assert torch.isfinite(got[live]).all()
    assert _rel_err(got[live], want[live]) <= GMM_RTOL[dtype]
    assert _rel_err(got[live], oracle[live]) <= GMM_RTOL[dtype]


def test_grouped_matmul_rows_are_neither_read_nor_written(dev):
    """Rows past the count are never read: NaNs there never reach a live
    row, and an expert with no rows is skipped."""
    E, C, D, F = 4, 16, 64, 32
    buf = torch.randn((E, C, D), device=dev)
    w = torch.randn((E, D, F), device=dev) / 8
    rows = torch.tensor([3, 0, 16, 9], dtype=torch.int32, device=dev)
    for e, r in enumerate(rows.tolist()):
        buf[e, r:] = float("nan")
    got = gmm.grouped_matmul(buf, w, rows)
    want = gmm.grouped_matmul_plain(buf.nan_to_num(), w, rows)
    for e, r in enumerate(rows.tolist()):
        if r:
            assert _rel_err(got[e, :r], want[e, :r]) <= 1e-5


def _moe_inputs(seed, T, E, k, d, f, dtype, dev, same=False):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((T, d), np.float32))
    ws = [torch.from_numpy(rng.standard_normal(s, np.float32)
                           / np.sqrt(s[1]))
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    if same:
        idx = np.tile(np.arange(k), (T, 1))
    else:
        idx = np.stack([rng.permutation(E)[:k] for _ in range(T)])
    gate = rng.dirichlet(np.ones(k), size=T).astype(np.float32)
    return (x.to(dev, dtype), torch.from_numpy(idx).to(dev),
            torch.from_numpy(gate).to(dev), *(w.to(dev, dtype) for w in ws))


MOE_CASES = [
    (8, 40, 8, 1536, 512, False),    # granite decode step
    (256, 40, 8, 1536, 512, False),  # granite prefill chunk
    (8, 40, 8, 1536, 512, True),     # every token on experts 0-7
    (1, 4, 2, 64, 32, False),
    (160, 6, 3, 60, 44, False),      # capacity 256, no vector loads
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,E,k,d,f,same", MOE_CASES)
def test_moe_decode_kernel_matches_plain(dev, T, E, k, d, f, same, dtype):
    args = _moe_inputs(T + E, T, E, k, d, f, dtype, dev, same)
    got = gmm.moe_decode_gmm(*args)
    want = gmm.moe_decode_gmm_plain(*args)
    oracle = ref.moe_decode_ref(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (T, d)
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) <= GMM_RTOL[dtype]
    assert _rel_err(got, oracle) <= GMM_RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [8, 256, 1, 9, 64])
def test_moe_decode_kernel_is_batch_invariant_bitwise(dev, T, dtype):
    """Every token's output is the same bits alone as inside a batch of T
    (a decode batch of 8, a prefill chunk of 256, and capacities that move
    a token's row between n-tiles and row blocks of K4): no row's sum
    depends on the capacity, the tile or its neighbours."""
    x, idx, gate, *ws = _moe_inputs(T, T, 40, 8, 1536, 512, dtype, dev)
    full = gmm.moe_decode_gmm(x, idx, gate, *ws)
    for i in range(T):
        alone = gmm.moe_decode_gmm(x[i:i + 1], idx[i:i + 1], gate[i:i + 1],
                                   *ws)
        assert torch.equal(alone[0], full[i]), i


def test_moe_launch_counters(dev):
    x, idx, gate, *ws = _moe_inputs(0, 4, 6, 2, 64, 32, torch.float32, dev)
    g0, m0 = gmm.grouped_matmul.launches, gmm.moe_decode_gmm.launches
    gmm.moe_decode_gmm_plain(x, idx, gate, *ws)
    gmm.grouped_matmul_plain(ws[0], ws[2])
    assert (gmm.grouped_matmul.launches, gmm.moe_decode_gmm.launches) == \
        (g0, m0)
    gmm.moe_decode_gmm(x, idx, gate, *ws)  # gate/up and down: two K4 launches
    assert gmm.moe_decode_gmm.launches == m0 + 1
    assert gmm.grouped_matmul.launches == g0 + 2
    ops.grouped_matmul(ws[0], ws[2])
    assert gmm.grouped_matmul.launches == g0 + 3


# ---------------------------------------------------------------------------
# K6 and K7: the SSD chunked scan (forward and backward) and the one-token
# state update
# ---------------------------------------------------------------------------
# relative to the largest |value|.  K6 f32: the kernel and the plain
# version take the same prefix sums (f64, rounded per position) and the
# same exps, and sum the products in other orders; bf16: y rounded once
# from those f32 sums.  Grads: f32 summation order; bf16 dx, dBm, dCm
# rounded once.  K7: f32 arithmetic on both sides, one FMA apart.
SSD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SSD_GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SSU_RTOL = 1e-5


def _ssd_inputs(seed, B, L, H, P, N, dtype, dev):
    """Model-layout inputs: dt a softplus of a standard normal, A as
    ``init_mamba2`` makes it (-1 .. -16 across the heads)."""
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    x = t(rng.standard_normal((B, L, H, P)), dtype)
    dt = t(np.log1p(np.exp(rng.standard_normal((B, L, H)))))
    A = t(-np.linspace(1.0, 16.0, H))
    Bm = t(0.5 * rng.standard_normal((B, L, N)), dtype)
    Cm = t(0.5 * rng.standard_normal((B, L, N)), dtype)
    D = t(1.0 + 0.1 * rng.standard_normal(H))
    return x, dt, A, Bm, Cm, D


def _ssd_plain_model_layout(x, dt, A, Bm, Cm, D, chunk):
    """ops.ssd_scan's layout change and padding around the plain
    version."""
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-L) % chunk
    x, dt, Bm, Cm = (torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2)
                                             + (0, pad))
                     for t in (x, dt, Bm, Cm))
    nc = (L + pad) // chunk
    y = ssd.ssd_scan_plain(
        x.reshape(B, nc, chunk, H, P).permute(0, 3, 1, 2, 4),
        dt.reshape(B, nc, chunk, H).permute(0, 3, 1, 2), A.expand(B, H),
        Bm.reshape(B, nc, chunk, N), Cm.reshape(B, nc, chunk, N),
        D.expand(B, H))
    return y.permute(0, 2, 3, 1, 4).reshape(B, L + pad, H, P)[:, :L]


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


SSD_CASES = [  # B, L, H, P, N, chunk
    (1, 64, 2, 16, 8, 16),
    (2, 128, 4, 32, 16, 32),
    (1, 256, 1, 64, 64, 64),
    (2, 100, 3, 64, 128, 100),    # L < chunk_size: one chunk of 100
    (2, 300, 4, 64, 128, 128),    # padded to 384
    (2, 1024, 32, 64, 128, 128),  # mamba2-370m train microbatch
    (2, 1024, 80, 64, 64, 128),   # zamba2-2.7b train microbatch
    (16, 512, 32, 64, 128, 128),  # mamba2-370m recompute
    (16, 512, 80, 64, 64, 128),   # zamba2-2.7b recompute
    (2, 2048, 4, 64, 128, 128),   # 16 chunks: two windows of a cluster
    (2, 1280, 4, 64, 128, 128),   # 10 chunks: the last window ragged
    (1, 1152, 6, 64, 64, 128),    # 9 chunks: a last window of one chunk
]
# the cases whose chunks take more than one window of a cluster
SSD_WINDOW_CASES = [c for c in SSD_CASES if c[1] // c[5] > 8]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,P,N,chunk", SSD_CASES)
def test_ssd_scan_kernel_matches_plain(dev, B, L, H, P, N, chunk, dtype):
    args = _ssd_inputs(L + N, B, L, H, P, N, dtype, dev)
    got = ops.ssd_scan(*args, chunk)
    want = _ssd_plain_model_layout(*args, chunk)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, L, H, P)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= SSD_RTOL[dtype]
    if L <= 300:  # the sequential oracle, step by step
        nc = -(-L // chunk)
        if L % chunk == 0:
            x, dt, A, Bm, Cm, D = args
            oracle = ref.ssd_scan_ref(
                x.reshape(B, nc, chunk, H, P).permute(0, 3, 1, 2, 4),
                dt.reshape(B, nc, chunk, H).permute(0, 3, 1, 2),
                A.expand(B, H), Bm.reshape(B, nc, chunk, N),
                Cm.reshape(B, nc, chunk, N), D.expand(B, H))
            oracle = oracle.permute(0, 2, 3, 1, 4).reshape(B, L, H, P)
            # the oracle multiplies decays step by step: f32 rounding
            # compounds over the chunk
            assert _rel(got, oracle) <= (1e-3 if dtype == torch.float32
                                         else 3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,P,N,chunk", SSD_CASES)
def test_ssd_scan_bwd_kernel_matches_plain_autograd(dev, B, L, H, P, N,
                                                    chunk, dtype):
    """Every gradient (x, dt, A, Bm, Cm, D) through ops.ssd_scan on the
    card (the backward kernels) against autograd of the plain version."""
    args = _ssd_inputs(L * 3 + N, B, L, H, P, N, dtype, dev)
    dy = torch.from_numpy(np.random.default_rng(L).standard_normal(
        (B, L, H, P)).astype(np.float32)).to(dev, dtype)
    grads = []
    for fn in (ops.ssd_scan, _ssd_plain_model_layout):
        leaves = [t.clone().requires_grad_() for t in args]
        y = fn(*leaves, chunk)
        grads.append(torch.autograd.grad(y, leaves, dy))
    torch.cuda.synchronize()
    for name, g, w in zip(("x", "dt", "A", "Bm", "Cm", "D"), *grads):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.isfinite(g).all(), name
        assert _rel(g, w) <= SSD_GRAD_RTOL[dtype], (name, _rel(g, w))


@pytest.mark.parametrize("B,L,H,P,N,chunk,dtype", [
    (2, 512, 8, 64, 128, 128, torch.float32)] + [
    (*case, dtype) for case in SSD_WINDOW_CASES
    for dtype in (torch.float32, torch.bfloat16)])
def test_ssd_scan_bwd_kernel_is_repeatable_bitwise(dev, B, L, H, P, N, chunk,
                                                   dtype):
    """The same bits on every run; the window cases take the backward's
    reverse chain over several windows of a cluster, the last one ragged
    or of one chunk."""
    args = _ssd_inputs(5, B, L, H, P, N, dtype, dev)
    dy = torch.ones((B, L, H, P), device=dev, dtype=dtype)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in args]
        runs.append(torch.autograd.grad(ops.ssd_scan(*leaves, chunk), leaves,
                                        dy))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_ssd_scan_kernel_in_the_tpu_layout(dev):
    """ssd_scan_bhcsp on contiguous (B, H, nc, s, P) tensors, as the TPU
    kernel takes them, against the plain version and the oracle."""
    B, H, nc, s, P, N = 2, 4, 3, 32, 32, 16
    rng = np.random.default_rng(11)

    def t(shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).to(dev)

    x, Bm, Cm = t((B, H, nc, s, P)), t((B, nc, s, N), 0.5), t((B, nc, s, N),
                                                             0.5)
    dt = torch.nn.functional.softplus(t((B, H, nc, s)))
    A, D = -torch.exp(0.3 * t((B, H))), t((B, H))
    got = ssd.ssd_scan_bhcsp(x, dt, A, Bm, Cm, D)
    assert _rel(got, ssd.ssd_scan_plain(x, dt, A, Bm, Cm, D)) <= 1e-4
    assert _rel(got, ref.ssd_scan_ref(x, dt, A, Bm, Cm, D)) <= 1e-3


def _plain_chunk_states(x, dt, A, Bm, Cm, chunk):
    """The state at the start of every chunk, (B, H, nc, P, N) f32, by the
    plain recurrence state <- exp(a_sum) state + sum_j exp(a_sum - a_cum_j)
    dt_j x_j (x) B_j from zeros, in the model layout."""
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    nc = L // chunk
    xf = x.float().reshape(B, nc, chunk, H, P).permute(0, 3, 1, 2, 4)
    dtf = dt.reshape(B, nc, chunk, H).permute(0, 3, 1, 2)
    Bf = Bm.float().reshape(B, nc, chunk, N)
    a_cum = torch.cumsum((dtf * A[None, :, None, None]).double(), -1).float()
    w = torch.exp(a_cum[..., -1:] - a_cum) * dtf
    contrib = (xf * w[..., None]).transpose(-1, -2) @ Bf[:, None]
    decay = torch.exp(a_cum[..., -1])
    state = torch.zeros((B, H, P, N), device=x.device)
    out = []
    for c in range(nc):
        out.append(state)
        state = state * decay[:, :, c, None, None] + contrib[:, :, c]
    return torch.stack(out, dim=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,P,N,chunk", [
    (2, 1024, 32, 64, 128, 128), (2, 1024, 80, 64, 64, 128),
    (2, 2048, 4, 64, 128, 128), (1, 256, 3, 32, 16, 32)])
def test_ssd_scan_saved_states_match_plain_recurrence(dev, B, L, H, P, N,
                                                      chunk, dtype):
    """The forward's chunk-start states (what the backward consumes) are
    the plain recurrence's, relative to the largest |state|: f32 sums in
    another order, and in bf16 products whose f32 operand goes in as a
    bf16 hi/lo pair (~2^-16 of each term)."""
    x, dt, A, Bm, Cm, D = _ssd_inputs(L + H, B, L, H, P, N, dtype, dev)
    nc = L // chunk
    _, states = ssd.ssd_scan_bhcsp(
        x.reshape(B, nc, chunk, H, P).permute(0, 3, 1, 2, 4),
        dt.reshape(B, nc, chunk, H).permute(0, 3, 1, 2), A.expand(B, H),
        Bm.reshape(B, nc, chunk, N), Cm.reshape(B, nc, chunk, N),
        D.expand(B, H), save_states=True)
    want = _plain_chunk_states(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    assert states.shape == (B, H, nc, P, N) and states.dtype == torch.float32
    assert torch.equal(states[:, :, 0], torch.zeros_like(states[:, :, 0]))
    assert _rel(states, want) <= SSD_RTOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_is_repeatable_bitwise(dev, dtype):
    """No atomics: two forwards (two windows of the chunk cluster) give the
    same bits."""
    args = _ssd_inputs(9, 2, 2048, 8, 64, 128, dtype, dev)
    first = ops.ssd_scan(*args, 128)
    for _ in range(2):
        assert torch.equal(ops.ssd_scan(*args, 128), first)


SSU_CASES = [  # B, H, P, N
    (1, 2, 16, 8),
    (3, 4, 32, 16),
    (2, 24, 64, 128),
    (8, 32, 64, 128),  # mamba2-370m decode
    (8, 80, 64, 64),   # zamba2-2.7b decode
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,P,N", SSU_CASES)
def test_ssm_state_update_kernel_matches_plain(dev, B, H, P, N, dtype):
    """K7 on a state that is a strided view of a larger cache (as the
    state layout's per-layer slice is), against the plain version and the
    oracle."""
    rng = np.random.default_rng(B * H + N)

    def t(shape, scale=1.0, dt=torch.float32):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).to(dev, dt)

    cache = t((B, 2, H, P, N))
    state = cache[:, 1]
    x, Bm, Cm = t((B, H, P), dt=dtype), t((B, N), 0.5, dtype), t((B, N), 0.5,
                                                                 dtype)
    dt = torch.nn.functional.softplus(t((B, H)))
    A, D = -torch.exp(0.3 * t((H,))), torch.ones(H, device=dev)
    y, new = ops.ssm_state_update(state, x, dt, A, Bm, Cm, D)
    want_y, want_s = ssu.ssm_state_update_plain(
        state, x, dt, A.expand(B, H), Bm, Cm, D.expand(B, H))
    oracle_y, oracle_s = ref.ssm_state_update_ref(state, x, dt, A, Bm, Cm, D)
    torch.cuda.synchronize()
    assert y.dtype == new.dtype == torch.float32
    for got, want in ((y, want_y), (new, want_s), (y, oracle_y),
                      (new, oracle_s)):
        assert _rel(got, want) <= SSU_RTOL
    assert torch.equal(state, cache[:, 1])  # the input is not written


def test_ssm_launch_counters(dev):
    args = _ssd_inputs(0, 1, 64, 2, 16, 8, torch.float32, dev)
    f0, b0 = ssd.ssd_scan_bhcsp.launches, ssd.ssd_scan_bwd.launches
    leaves = [t.clone().requires_grad_() for t in args]
    y = ops.ssd_scan(*leaves, 32)
    y.sum().backward()
    with torch.no_grad():
        ops.ssd_scan(*args, 32)
    _ssd_plain_model_layout(*args, 32)
    assert ssd.ssd_scan_bhcsp.launches == f0 + 2
    assert ssd.ssd_scan_bwd.launches == b0 + 1
    u0 = ssu.ssm_state_update_bh.launches
    state = torch.zeros((1, 2, 16, 8), device=dev)
    x, dt = torch.ones((1, 2, 16), device=dev), torch.ones((1, 2),
                                                          device=dev)
    A, D, Bm = -torch.ones(2, device=dev), torch.ones(2, device=dev), \
        torch.ones((1, 8), device=dev)
    ssu.ssm_state_update_plain(state, x, dt, A, Bm, Bm, D)
    ops.ssm_state_update(state, x, dt, A, Bm, Bm, D)
    assert ssu.ssm_state_update_bh.launches == u0 + 1


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_ssm_forward_and_policy_grads_card_vs_cpu(dev, arch):
    """Reduced mamba2 and zamba2 in f32 from the same weights: logits and
    every gradient of the policy loss (A_log, dt_bias and D among them) on
    the card (K6 forward and backward, K3 in the hybrid) against the CPU
    (the plain versions).  f32 on both sides: cuBLAS and the CPU sum in
    other orders."""
    cfg = get_config(arch).reduced()
    cpu = init_model(torch.Generator().manual_seed(9), cfg, torch.float32,
                     "cpu")
    rng = np.random.default_rng(9)
    B, S = 2, 75
    mask = np.zeros((B, S), np.float32)
    mask[:, 25:] = 1.0
    batch = {"tokens": torch.from_numpy(rng.integers(3, cfg.vocab_size,
                                                     (B, S))),
             "old_logprobs": torch.full((B, S), -6.0),
             "advantages": torch.from_numpy(
                 rng.standard_normal((B, S)).astype(np.float32) * mask),
             "loss_mask": torch.from_numpy(mask)}
    hp = TrainHParams(entropy_coef=0.01)
    out = []
    for device in ("cpu", dev):
        params = tree_map(lambda t: t.to(device).requires_grad_(), cpu)
        mb = {k: v.to(device) for k, v in batch.items()}
        logits, _ = forward(params, cfg, mb["tokens"])
        loss, _ = policy_loss(cfg, hp, params, mb)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        out.append((logits.detach().cpu(), float(loss.detach()),
                    [g.cpu() for g in grads]))
    (lc, loss_c, gc), (lg, loss_g, gg) = out
    torch.testing.assert_close(lg, lc, atol=1e-4, rtol=1e-4)
    assert abs(loss_g - loss_c) <= 1e-4 * abs(loss_c) + 1e-6
    for a, b in zip(gg, gc):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max() + 1e-7


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_ssm_engine_card_vs_cpu(dev, arch):
    """Reduced mamba2 and zamba2 served through the state cache layout on
    the card (K7, K2) and on the CPU from the same f32 weights: the same
    tokens, at temperature 0 and above it, and the same logprobs within
    1e-3 (cuBLAS and the CPU sum in other orders)."""
    cfg = get_config(arch).reduced()
    cpu = init_model(torch.Generator().manual_seed(10), cfg, torch.float32,
                     "cpu")
    gpu = tree_map(lambda t: t.to(dev), cpu)
    prompts = np.random.default_rng(10).integers(3, cfg.vocab_size, (5, 13))
    for temp, k, p in ((0.0, 0, 1.0), (1.0, 8, 0.9)):
        res = []
        for device, params in (("cpu", cpu), (dev, gpu)):
            eng = PagedEngine(cfg, max_batch=3, max_new_tokens=10,
                              max_seq_len=64, temperature=temp, top_k=k,
                              top_p=p, device=device)
            assert eng.layout.name == "state"
            res.append(eng.generate(params, prompts, seed=3))
        assert torch.equal(res[0].tokens, res[1].tokens)
        assert (res[0].logprobs - res[1].logprobs).abs().max() <= 1e-3


# ---------------------------------------------------------------------------
# the GRPO runner: two iterations on the card against the CPU
# ---------------------------------------------------------------------------
def _grpo_run(device, params, lr, arch="yi-9b", async_depth=0):
    """A reduced GRPORunner (yi-9b unless ``arch``) from ``params``,
    collocated (or the async horizon at ``async_depth``), two
    iterations on ``device``, with an entropy bonus so that the actor
    learns while every reward is equal (random weights rarely answer
    right); returns (runner, per-call outputs of rollout and reward, and
    per-call (params before, chunk) of the actor, on the CPU)."""
    from repro_torch.comm.primitives import reset_router
    from repro_torch.rl import GRPOConfig, GRPORunner
    from repro_torch.train import AdamWConfig

    reset_router()
    cfg = get_config(arch).reduced()
    rl = GRPOConfig(batch_size=8, group_size=4, iterations=2,
                    max_new_tokens=8, mode="collocated", seed=0,
                    profile_batches=(4, 8), async_depth=async_depth)
    runner = GRPORunner(cfg, rl, TrainHParams(
        optimizer=AdamWConfig(lr=lr), entropy_coef=0.01), device=device,
        params=tree_map(lambda t: t.to(device, copy=True), params))
    log = {"rollout": [], "reward": [], "actor": []}

    def wrap(name, fn):
        def run(w, c):
            if name == "actor":
                log[name].append((
                    [t.cpu().clone() for t in tree_leaves(w.params())],
                    {k: np.array(v) for k, v in c.items()}))
            out = fn(w, c)
            if name in ("rollout", "reward"):
                log[name].append({k: np.array(v) for k, v in out.items()
                                  if k != "metrics"})
            return out
        return run

    runner.task_fns = {n: wrap(n, f) for n, f in runner.task_fns.items()}
    runner.run(verbose=False)
    return runner, log


def test_grpo_runner_card_vs_cpu(dev):
    """Profile, plan and two collocated iterations on the card: every
    worker on the card, the rollouts' tokens and the rewards the CPU's;
    the actor's first update p1 - p0 within 1 % of the CPU's wherever the
    gradient is clear of rounding (above 1e-3 of its tensor's largest:
    there Adam's first step is lr * g / (|g| + eps), so a step of the
    wrong sign or size fails), and the actor's final params scoring the
    last rollout as the CPU's do, within the card-vs-CPU logprob
    tolerance."""
    lr = 1e-4
    cfg = get_config("yi-9b").reduced()
    params = init_model(None, cfg, torch.float32, "cpu")
    cpu, cpu_log = _grpo_run("cpu", params, lr)
    card, card_log = _grpo_run(dev, params, lr)
    assert all(w.device.type == "cuda" for w in card.workers.values())
    assert card.rollout.engine.cache.k.is_cuda
    assert len(card_log["rollout"]) == len(cpu_log["rollout"])
    for a, b in zip(card_log["rollout"], cpu_log["rollout"]):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_allclose(a["logprobs"], b["logprobs"], atol=1e-3)
    for a, b in zip(card_log["reward"], cpu_log["reward"]):
        for k in ("rewards", "loss_mask", "advantages"):
            np.testing.assert_array_equal(a[k], b[k])
    # the first update, from the same p0 on the same chunk
    assert len(card_log["actor"]) == len(cpu_log["actor"]) >= 2
    p0, chunk = cpu_log["actor"][0]
    p1_card, p1_cpu = card_log["actor"][1][0], cpu_log["actor"][1][0]
    live = tree_map(lambda t: t.clone().requires_grad_(), params)
    batch = {"tokens": torch.tensor(chunk["tokens"], dtype=torch.long)}
    for k in ("old_logprobs", "advantages", "loss_mask"):
        batch[k] = torch.tensor(chunk[k], dtype=torch.float32)
    loss, _ = policy_loss(cfg, card.hp, live, batch)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    clear = total = 0
    for a, b, p, g in zip(p1_card, p1_cpu, p0, grads):
        sure = g.abs() > 1e-3 * g.abs().max()
        torch.testing.assert_close((a - p)[sure], (b - p)[sure],
                                   rtol=1e-2, atol=1e-2 * lr)
        clear, total = clear + int(sure.sum()), total + int((g != 0).sum())
    assert clear > 0.5 * total, (clear, total)
    moved = max(float((a.cpu() - b).abs().max()) for a, b in
                zip(tree_leaves(card.actor.params()), tree_leaves(params)))
    assert moved > 0.5 * lr, moved
    # the final params, past the last step, on the last rollout
    last = {"tokens": cpu_log["rollout"][-1]["tokens"]}
    lp = [r.inference.compute_logprobs(last, key="lp",
                                       params=r.actor.params())["lp"]
          for r in (card, cpu)]
    np.testing.assert_allclose(lp[0], lp[1], atol=1e-3)
    assert [s.mean_reward for s in card.stats] == \
        [s.mean_reward for s in cpu.stats]


def _grads(loss, leaves):
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def _first_update_matches(p1_card, p1_cpu, p0, grads, lr, held=0.5):
    """p1 - p0 card vs CPU within 1 % wherever |g| is above 1e-3 of its
    tensor's largest, over ``held`` of the elements with a gradient so
    held (test_grpo_runner_card_vs_cpu's bar)."""
    clear = total = 0
    for a, b, p, g in zip(p1_card, p1_cpu, p0, grads):
        sure = g.abs() > 1e-3 * g.abs().max()
        torch.testing.assert_close((a - p)[sure], (b - p)[sure],
                                   rtol=1e-2, atol=1e-2 * lr)
        clear, total = clear + int(sure.sum()), total + int((g != 0).sum())
    assert clear > held * total, (clear, total)
    moved = max(float((a - p).abs().max()) for a, p in zip(p1_card, p0))
    assert moved > 0.5 * lr, moved


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-370m"])
def test_grpo_runner_moe_and_ssm_rollout_card_vs_cpu(dev, arch):
    """The MoE and SSM rollout workers (``MoEPagedKVLayout``,
    ``StateCacheLayout``) inside the runner on the card: every worker
    there, the rollouts before the first update the CPU's token for
    token, the rewards the CPU's, and the first update within 1 % where
    the gradient is clear of rounding."""
    lr = 1e-4
    cfg = get_config(arch).reduced()
    params = init_model(torch.Generator().manual_seed(3), cfg,
                        torch.float32, "cpu")
    cpu, cpu_log = _grpo_run("cpu", params, lr, arch)
    card, card_log = _grpo_run(dev, params, lr, arch)
    assert all(w.device.type == "cuda" for w in card.workers.values())
    # the profile's calls (a warm-up and a timed call at 4 and at 8 rows,
    # then its full chunk) come before any update
    before = 5
    for a, b in zip(card_log["rollout"][:before], cpu_log["rollout"][:before]):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_allclose(a["logprobs"], b["logprobs"], atol=1e-3)
    for a, b in zip(card_log["reward"][:before], cpu_log["reward"][:before]):
        np.testing.assert_array_equal(a["rewards"], b["rewards"])
    p0, chunk = cpu_log["actor"][0]
    live = tree_map(lambda t: t.clone().requires_grad_(), params)
    batch = {"tokens": torch.tensor(chunk["tokens"], dtype=torch.long)}
    for k in ("old_logprobs", "advantages", "loss_mask"):
        batch[k] = torch.tensor(chunk[k], dtype=torch.float32)
    loss, _ = policy_loss(cfg, card.hp, live, batch)
    # an expert's weights see only the tokens routed to it: most of their
    # elements' gradients sit below 1e-3 of the tensor's largest
    _first_update_matches(card_log["actor"][1][0], cpu_log["actor"][1][0],
                          p0, _grads(loss, tree_leaves(live)), lr,
                          held=0.25 if cfg.kind == "moe" else 0.5)
    assert all(np.isfinite(v) for v in card.stats[-1].metrics.values())


def test_grpo_async_horizon_card_vs_cpu(dev):
    """async_depth=1 on the card: the horizon's first rollout (version 0
    on both) the CPU's token for token, tags monotone and at most one
    version stale, every metric finite, and the published snapshot the
    actor's params in storage of its own."""
    lr = 1e-4
    cfg = get_config("yi-9b").reduced()
    params = init_model(torch.Generator().manual_seed(5), cfg,
                        torch.float32, "cpu")
    cpu, cpu_log = _grpo_run("cpu", params, lr, async_depth=1)
    card, card_log = _grpo_run(dev, params, lr, async_depth=1)
    assert all(w.device.type == "cuda" for w in card.workers.values())
    # the profile's five calls come before any update
    assert len(card_log["rollout"]) == len(cpu_log["rollout"]) == 7
    for a, b in zip(card_log["rollout"][:5], cpu_log["rollout"][:5]):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    tags = [int(c["weight_versions"].max()) for c in card_log["rollout"][5:]]
    assert tags == sorted(tags) and tags[0] == 0, tags
    assert card._driver.version == 2
    assert card._driver.queue.max_observed_staleness <= 1
    assert all(np.isfinite(v) for s in card.stats for v in s.metrics.values())
    version, snap = card._published
    for a, b in zip(tree_leaves(card.actor.params()), tree_leaves(snap)):
        assert a.is_cuda and torch.equal(a, b)
        assert a.data_ptr() != b.data_ptr()


def _rlhf_run(device, params, critic_params, lr):
    """A reduced-stablelm RLHFRunner from the given actor and critic
    params, collocated, profile + plan + one iteration on ``device``;
    returns (runner, per-call outputs of each stage, and per-call (params
    before, chunk) of the actor and of the critic's value step, on the
    CPU)."""
    from repro_torch.comm.primitives import reset_router
    from repro_torch.rl import PPOConfig, RLHFRunner
    from repro_torch.train import AdamWConfig

    reset_router()
    cfg = get_config("stablelm-12b").reduced()
    runner = RLHFRunner(
        cfg, PPOConfig(batch_size=8, iterations=1, max_new_tokens=6,
                       mode="collocated", profile_batches=(4, 8)),
        TrainHParams(optimizer=AdamWConfig(lr=lr, clip_norm=1.0),
                     kl_coef=0.05, entropy_coef=0.02),
        device=device,
        params=tree_map(lambda t: t.to(device, copy=True), params),
        critic_params=tree_map(lambda t: t.to(device, copy=True),
                               critic_params))
    log = {n: [] for n in runner.task_fns}
    log["critic"] = []

    def before(w, c):
        return ([t.cpu().clone() for t in tree_leaves(w.get_state("params"))],
                {k: np.array(v) for k, v in c.items() if k != "metrics"})

    def wrap(name, fn):
        def run(w, c):
            if name == "actor":
                log[name].append(before(w, c))
            out = fn(w, c)
            if name != "actor":
                log[name].append({k: np.array(v) for k, v in out.items()
                                  if k != "metrics"})
            return out
        return run

    runner.task_fns = {n: wrap(n, f) for n, f in runner.task_fns.items()}
    train_value = runner.critic.train_value

    def critic_step(c):
        log["critic"].append(before(runner.critic, c))
        return train_value(c)

    runner.critic.train_value = critic_step
    runner.run(verbose=False)
    return runner, log


def test_rlhf_runner_card_vs_cpu(dev):
    """Reduced stablelm-12b through the RLHF diamond on the card: every
    worker there; rollout tokens, rewards and masks the CPU's; values,
    reference and recomputed logprobs and the advantages within 1e-3;
    the actor's first update (KL term on) and the critic's value step
    within 1 % of the CPU's where the gradient is clear of rounding; the
    reference bit for bit the initial actor."""
    from repro_torch.rl.rlhf_workflow import critic_values, init_critic

    lr = 1e-4
    cfg = get_config("stablelm-12b").reduced()
    params = init_model(torch.Generator().manual_seed(11), cfg,
                        torch.float32, "cpu")
    critic = init_critic(torch.Generator().manual_seed(12), cfg,
                         torch.float32, "cpu")
    cpu, cpu_log = _rlhf_run("cpu", params, critic, lr)
    card, card_log = _rlhf_run(dev, params, critic, lr)
    assert all(w.device.type == "cuda" for w in card.workers.values())
    for a, b in zip(card_log["rollout"], cpu_log["rollout"]):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    for stage, key in (("inference", "old_logprobs"),
                       ("reference", "ref_logprobs"), ("critic_v", "values"),
                       ("reward", "advantages"), ("reward", "returns")):
        for a, b in zip(card_log[stage], cpu_log[stage]):
            np.testing.assert_allclose(a[key], b[key], atol=1e-3,
                                       err_msg=key)
    for a, b in zip(card_log["reward"], cpu_log["reward"]):
        for k in ("rewards", "loss_mask"):
            np.testing.assert_array_equal(a[k], b[k])
    p0, chunk = cpu_log["actor"][0]
    live = tree_map(lambda t: t.clone().requires_grad_(), params)
    batch = {"tokens": torch.tensor(chunk["tokens"], dtype=torch.long)}
    for k in ("old_logprobs", "advantages", "loss_mask", "ref_logprobs"):
        batch[k] = torch.tensor(chunk[k], dtype=torch.float32)
    loss, metrics = policy_loss(cfg, card.hp, live, batch)
    assert "kl_ref" in metrics
    _first_update_matches(card_log["actor"][1][0], cpu_log["actor"][1][0],
                          p0, _grads(loss, tree_leaves(live)), lr)
    # the critic's one value step (lr 1e-3), from the same params
    c0, cchunk = cpu_log["critic"][0]
    live = tree_map(lambda t: t.clone().requires_grad_(), critic)
    mask = torch.tensor(cchunk["loss_mask"])
    v = critic_values(live, cfg, torch.tensor(cchunk["tokens"]).long())
    vloss = (torch.square(v - torch.tensor(cchunk["returns"])) * mask
             ).sum() / mask.sum().clamp(min=1.0)
    _first_update_matches(
        [t.cpu() for t in tree_leaves(card.critic.get_state("params"))],
        tree_leaves(cpu.critic.get_state("params")), c0,
        _grads(vloss, tree_leaves(live)), 1e-3)
    np.testing.assert_allclose(card.stats[0].value_loss,
                               cpu.stats[0].value_loss, rtol=1e-3)
    for r, p in zip(tree_leaves(card.reference.get_state("params")),
                    tree_leaves(params)):
        assert r.is_cuda and torch.equal(r.cpu(), p)


def test_embodied_runner_card_vs_cpu(dev):
    """The reduced embodied policy (stablelm's family at d_model 128)
    through the simulator-policy cycle on the card, hybrid: every worker
    there; under the port's own act noise the actions, rewards and the
    terminated/truncated split the CPU's, logprobs within 1e-4; the
    update within 1 % where the gradient is clear of rounding."""
    from repro_torch.comm.primitives import reset_router
    from repro_torch.rl import EmbodiedPPOConfig, EmbodiedPPORunner
    from repro_torch.rl.embodied_workflow import default_policy_config

    cfg = default_policy_config()
    params = init_model(torch.Generator().manual_seed(13), cfg,
                        torch.float32, "cpu")
    runs = []
    for device in ("cpu", dev):
        reset_router()
        r = EmbodiedPPORunner(
            EmbodiedPPOConfig(num_envs=16, horizon=6, iterations=1,
                              mode="hybrid", max_steps=4,
                              profile_batches=(8, 16)),
            device=device,
            params=tree_map(lambda t: t.to(device, copy=True), params))
        r.profile()
        r.plan_execution()
        p0 = [t.cpu().clone() for t in tree_leaves(r.actor.params())]
        r._sync_weights()
        out = r.controller.execute(r.plan, r.workers, r.task_fns,
                                   r.make_batch(),
                                   cycle_specs=r.cycle_specs())
        runs.append((r, p0, out))
    (cpu, p0_cpu, o_cpu), (card, p0_card, o_card) = runs
    assert all(w.device.type == "cuda" for w in card.workers.values())
    assert card.controller.last_cycle_log[0][1] == "hybrid"
    for k in ("action_tokens", "rewards", "terminated", "truncated",
              "tokens", "advantages"):
        np.testing.assert_array_equal(np.asarray(o_card[k]),
                                      np.asarray(o_cpu[k]), err_msg=k)
    np.testing.assert_allclose(o_card["action_logprobs"],
                               o_cpu["action_logprobs"], atol=1e-4)
    assert len(np.unique(o_card["action_tokens"])) > 1
    # the profile trained both actors alike from the same init: the
    # iteration's update from there
    for a, b in zip(p0_card, p0_cpu):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)
    live = tree_map(lambda t: t.clone().requires_grad_(),
                    tree_unflatten(params, p0_cpu))
    batch = {"tokens": torch.tensor(np.asarray(o_cpu["tokens"])).long()}
    for k in ("old_logprobs", "advantages", "loss_mask"):
        batch[k] = torch.tensor(np.asarray(o_cpu[k]), dtype=torch.float32)
    loss, _ = policy_loss(cfg, cpu.hp, live, batch)
    _first_update_matches(
        [t.cpu() for t in tree_leaves(card.actor.params())],
        tree_leaves(cpu.actor.params()), p0_cpu,
        _grads(loss, tree_leaves(live)), cpu.rl.lr)
