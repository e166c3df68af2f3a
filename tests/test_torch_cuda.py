"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs on a machine
without them:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.kernels import sampling as ks
from repro_torch.serve.sampling import request_noise

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


@pytest.mark.parametrize("B,V", [(1, 64), (4, 128), (3, 250), (8, 65536)])
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


def test_fused_sample_kernel_ties_and_duplicates(dev):
    V = 96
    logits = torch.zeros((3, V))
    logits[0, 7] = logits[0, 20] = 3.0           # greedy tie: first wins
    logits[1, [3, 9, 30, 31]] = 2.0              # duplicates at the k edge
    logits[1, 50] = 5.0
    logits[2, :] = torch.linspace(-1, 1, V)
    logits[2, 60:64] = 4.0
    noise = torch.zeros_like(logits)
    logits, noise = logits.to(dev), noise.to(dev)
    for kw in (dict(temperature=0.0), dict(temperature=1.0, top_k=3),
               dict(temperature=1.0, top_k=5, top_p=0.5),
               dict(temperature=0.5, top_p=0.3)):
        tok, lp = ks.fused_sample_bv(logits, noise, **kw)
        want_tok, want_lp = ks.fused_sample_plain(logits, noise, **kw)
        assert torch.equal(tok, want_tok), kw
        torch.testing.assert_close(lp, want_lp, atol=2e-5, rtol=2e-5)
    tok, _ = ks.fused_sample_bv(logits, noise, temperature=0.0)
    assert tok.tolist()[0] == 7


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
