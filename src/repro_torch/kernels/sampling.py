"""Fused sampling: the Hopper kernel's wrapper and its plain version.

Temperature, top-k, top-p and Gumbel-max categorical in one pass over
each logits row, plus the behaviour logprob under the unfiltered
temperature-1 row.  The kernel is ``csrc/sampling.cu`` (CUDA C++), built
by :mod:`repro_torch.kernels._build`; it replaces ``fused_sample_bv`` of
the JAX package's ``kernels/sampling.py``.

Layouts:
  logits  (B, V)  float32
  gumbel  (B, V)  float32 Gumbel(0, 1) noise (read only when temperature > 0)
  token   (B,)    int32
  lp      (B,)    float32
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30


def _sort_keys(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving map float32 -> uint32 (held in int64):
    a < b  <=>  key(a) < key(b).  Non-negative floats order like their
    bit patterns (set the sign bit to lift them above the negatives);
    negative floats order in reverse of their bit patterns (flip all
    bits)."""
    bits = x.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    neg = (bits >> 31) == 1
    return torch.where(neg, (~bits) & 0xFFFFFFFF, bits | 0x80000000)


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first occurrence of each row's maximum, (B, V) -> (B,)."""
    V = x.shape[-1]
    m = x.amax(dim=-1, keepdim=True)
    idx = torch.arange(V, device=x.device).expand_as(x)
    return torch.where(x >= m, idx, V).amin(dim=-1)


def fused_sample_plain(logits, gumbel, *, temperature: float = 1.0,
                       top_k: int = 0, top_p: float = 1.0,
                       vocab_size: int = 0) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """What the kernel computes, in plain torch, row-batched: the same
    passes (k max-peels, 33 bisection steps on the sort keys)."""
    row = logits.float()
    B, V = row.shape
    idx = torch.arange(V, device=row.device).expand(B, V)
    if 0 < vocab_size < V:
        row = torch.where(idx < vocab_size, row, NEG_INF)
    # behaviour logprob normalizer on the UNFILTERED temp-1 row
    m0 = row.amax(dim=-1, keepdim=True)
    lse = m0[:, 0] + torch.log(torch.exp(row - m0).sum(dim=-1))
    if temperature <= 0.0:
        tok = _first_argmax(row)
    else:
        # a tensor divisor keeps the division exact (a scalar one may
        # become a multiply by its reciprocal)
        x = row / torch.full_like(row, temperature)
        if 0 < top_k < V:
            # exact k-th largest: peel in (value desc, index asc) order,
            # duplicates once per occurrence, like lax.top_k
            prev_v = torch.full((B, 1), float("inf"), device=row.device)
            prev_i = torch.full((B, 1), -1, device=row.device)
            for _ in range(top_k):
                cand = (x < prev_v) | ((x == prev_v) & (idx > prev_i))
                w = torch.where(cand, x, float("-inf"))
                prev_i = _first_argmax(w)[:, None]
                prev_v = w.gather(1, prev_i)
            x = torch.where(x < prev_v, NEG_INF, x)
        if top_p < 1.0:
            # nucleus cutoff: bisect the sort-key space for the smallest
            # value whose strictly-greater mass is < p
            mx = x.amax(dim=-1, keepdim=True)
            ex = torch.exp(x - mx)  # masked entries underflow to 0
            z = ex.sum(dim=-1, keepdim=True)
            keys = _sort_keys(x)
            lo = keys.amin(dim=-1, keepdim=True) - 1  # H(lo) = 1 >= p
            hi = keys.amax(dim=-1, keepdim=True)      # H(hi) = 0 <  p
            p = torch.tensor(top_p, dtype=torch.float32)
            for _ in range(33):
                mid = lo + (hi - lo) // 2
                above = torch.where(keys > mid, ex, 0.0).sum(
                    dim=-1, keepdim=True) / z
                keep = above >= p
                lo = torch.where(keep, mid, lo)
                hi = torch.where(keep, hi, mid)
            x = torch.where(keys < hi, NEG_INF, x)
        tok = _first_argmax(x + gumbel.float())
    lp = row.gather(1, tok[:, None])[:, 0] - lse
    return tok.to(torch.int32), lp.float()


def fused_sample_bv(logits, gumbel, *, temperature: float = 1.0,
                    top_k: int = 0, top_p: float = 1.0,
                    vocab_size: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the tensors' card; returns
    (token (B,) int32, behaviour logprob (B,) float32)."""
    B, V = logits.shape
    dev = logits.device
    if dev.type != "cuda":
        raise ValueError(f"fused_sample_bv runs on CUDA tensors, got {dev}")
    if gumbel.device != dev or tuple(gumbel.shape) != (B, V):
        raise ValueError(f"gumbel {tuple(gumbel.shape)} on {gumbel.device} "
                         f"does not match logits {(B, V)} on {dev}")
    logits = logits.float().contiguous()
    gumbel = gumbel.float().contiguous()
    tok = torch.empty((B,), dtype=torch.int32, device=dev)
    lp = torch.empty((B,), dtype=torch.float32, device=dev)
    lib = _build.library()
    err = lib.fused_sample_bv_launch(
        logits.data_ptr(), gumbel.data_ptr(), tok.data_ptr(), lp.data_ptr(),
        B, V, float(temperature), int(top_k), float(top_p), int(vocab_size),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_sample_bv")
    fused_sample_bv.launches += 1
    return tok, lp


fused_sample_bv.launches = 0
