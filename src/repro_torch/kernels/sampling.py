"""Fused sampling: the Hopper kernel's wrapper and its plain version.

Temperature, top-k, top-p and Gumbel-max categorical over each logits
row, plus the behaviour logprob under the unfiltered temperature-1 row.
The kernel is ``csrc/sampling.cu`` (CUDA C++), built by
:mod:`repro_torch.kernels._build`; it replaces ``fused_sample_bv`` of the
JAX package's ``kernels/sampling.py``.

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
MASS_SCALE = 2.0 ** 40  # top-p masses as integers of 2^-40


def _sort_keys(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving map float32 -> uint32 (held in int64):
    a < b  <=>  key(a) < key(b).  Non-negative floats order like their
    bit patterns (set the sign bit to lift them above the negatives);
    negative floats order in reverse of their bit patterns (flip all
    bits)."""
    bits = x.float().contiguous().view(torch.int32).long() & 0xFFFFFFFF
    neg = (bits >> 31) == 1
    return torch.where(neg, (~bits) & 0xFFFFFFFF, bits | 0x80000000)


def _key_values(keys: torch.Tensor) -> torch.Tensor:
    """The float32 values of sort keys (int64 in [0, 2^32)): the inverse of
    :func:`_sort_keys`."""
    bits = torch.where(keys >= 2 ** 31, keys & 0x7FFFFFFF,
                       (~keys) & 0xFFFFFFFF)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first occurrence of each row's maximum, (B, V) -> (B,)."""
    V = x.shape[-1]
    m = x.amax(dim=-1, keepdim=True)
    idx = torch.arange(V, device=x.device).expand_as(x)
    return torch.where(x >= m, idx, V).amin(dim=-1)


def _radix_rounds(keys: torch.Tensor, weight: torch.Tensor, pick):
    """Four rounds of an 8-bit radix descent over each row's sort keys:
    in each, the 256-bin histogram of ``weight`` (int64) over the keys
    whose higher digits match the digits chosen so far, and ``pick(incl,
    excl)`` -> the chosen digit, (B, 1), from the sums over the bins >= d
    and > d.  Returns the chosen key, (B, 1)."""
    B = keys.shape[0]
    pfx = torch.zeros((B, 1), dtype=torch.int64, device=keys.device)
    for shift in (24, 16, 8, 0):
        match = (keys >> (shift + 8)) == pfx
        hist = torch.zeros((B, 256), dtype=torch.int64, device=keys.device)
        hist.scatter_add_(1, (keys >> shift) & 255,
                          torch.where(match, weight, 0))
        incl = hist.flip(1).cumsum(1).flip(1)
        pfx = (pfx << 8) | pick(incl, incl - hist)
    return pfx


def _kth_largest_key(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest sort key of each row, duplicates counted (lax.top_k's
    k-th value), by radix select on counts: (B, 1)."""
    krem = torch.full((keys.shape[0], 1), k, dtype=torch.int64,
                      device=keys.device)

    def pick(incl, excl):
        nonlocal krem
        d = (incl >= krem).sum(1, keepdim=True) - 1  # bins >= d hold krem
        krem = krem - excl.gather(1, d)
        return d

    return _radix_rounds(keys, torch.ones_like(keys), pick)


def _top_p_key(keys: torch.Tensor, mass: torch.Tensor,
               thr: torch.Tensor) -> torch.Tensor:
    """The smallest key t of each row with mass(keys > t) < thr, by radix
    descent on integer masses (exact sums): (B, 1)."""
    above = torch.zeros_like(thr, dtype=torch.int64)

    def pick(incl, excl):
        nonlocal above
        d = 256 - ((above + excl).double() < thr).sum(1, keepdim=True)
        above = above + excl.gather(1, d)
        return d

    return _radix_rounds(keys, mass, pick)


def fused_sample_plain(logits, gumbel, *, temperature: float = 1.0,
                       top_k: int = 0, top_p: float = 1.0,
                       vocab_size: int = 0) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """What the kernel computes, in plain torch, row-batched, in the
    kernel's formulation: the top-k cutoff by radix select on the sort
    keys, the top-p cutoff by radix descent on masses exp(x - max) held as
    integers of 2^-40 (exact sums, compared with p z in float64)."""
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
            cutoff = _key_values(_kth_largest_key(_sort_keys(x), top_k))
            x = torch.where(x < cutoff, NEG_INF, x)
        if top_p < 1.0:
            keys = _sort_keys(x)
            mx = x.amax(dim=-1, keepdim=True)  # the max is always kept
            p = torch.tensor(top_p, dtype=torch.float32).double()
            if p > 0:
                mass = (torch.exp(x - mx) * MASS_SCALE).long()
                thr = p * mass.sum(dim=-1, keepdim=True).double()
                hi = _top_p_key(keys, mass, thr)
            else:  # nothing has mass below 0: keep the max
                hi = _sort_keys(mx)
            x = torch.where(keys < hi, NEG_INF, x)
        tok = _first_argmax(x + gumbel.float())
    lp = row.gather(1, tok[:, None])[:, 0] - lse
    return tok.to(torch.int32), lp.float()


def fused_sample_bv(logits, gumbel, *, temperature: float = 1.0,
                    top_k: int = 0, top_p: float = 1.0,
                    vocab_size: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the tensors' card (a cluster of 8 blocks
    a row, each holding an eighth of the row's logits and noise in shared
    memory: V up to ~210k); returns (token (B,) int32, behaviour logprob
    (B,) float32)."""
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
    with torch.cuda.device(dev):
        err = lib.fused_sample_bv_launch(
            logits.data_ptr(), gumbel.data_ptr(), tok.data_ptr(),
            lp.data_ptr(), B, V, float(temperature), int(top_k),
            float(top_p), int(vocab_size),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_sample_bv")
    fused_sample_bv.launches += 1
    return tok, lp


fused_sample_bv.launches = 0
