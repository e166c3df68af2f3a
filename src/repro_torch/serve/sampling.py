"""Sampling utilities shared by the serving engines.

Filters (top-k, nucleus/top-p) reshape only the *sampling* distribution;
the behaviour logprob returned to the RL stack is always evaluated under
the unfiltered temperature-1 policy, so importance ratios stay
well-defined whatever decoding strategy produced the trajectory.

Randomness enters only as Gumbel(0, 1) noise passed in: categorical
sampling is Gumbel-max, ``argmax(filtered + gumbel)``.  The engine draws
its noise from :func:`request_noise`, a counter-based integer hash of
(seed, position, vocab index) — the JAX package draws from
``fold_in(PRNGKey(seed), position)`` instead, so the two give different
samples from the same seed unless a caller hands both the same noise.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.layers import NEG_INF, token_logprobs

_M32 = 0xFFFFFFFF


def mask_padded_vocab(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Embedding tables are padded for sharding; never sample the pad."""
    if vocab_size <= 0:
        return logits
    idx = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(idx < vocab_size, logits, NEG_INF)


def top_k_logits(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k highest logits, mask the rest to -1e30.  k<=0 disables."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    cutoff = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < cutoff, NEG_INF, logits)


def top_p_logits(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest prefix of the sorted distribution
    whose mass reaches p (the cutoff token itself is always kept, so the
    argmax survives even for tiny p)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cut_idx = (cum < p).sum(dim=-1, keepdim=True)
    cutoff = sorted_logits.gather(-1, cut_idx)
    return torch.where(logits < cutoff, NEG_INF, logits)


def sample_token(
    gumbel: torch.Tensor,  # (..., V) Gumbel(0, 1) noise
    logits: torch.Tensor,  # (..., V)
    *,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    vocab_size: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw a token and return ``(token int32, behaviour logprob f32)``.

    temperature <= 0 is greedy (argmax, noise unused); otherwise
    temperature scales the logits FIRST and the filters apply to the
    tempered distribution (temperature -> top-k -> top-p).
    """
    logits = mask_padded_vocab(logits.float(), vocab_size)
    if temperature <= 0.0:
        tok = torch.argmax(logits, dim=-1)
    else:
        filtered = top_p_logits(top_k_logits(logits / temperature, top_k),
                                top_p)
        tok = torch.argmax(filtered + gumbel.float(), dim=-1)
    # behaviour logprob under the unfiltered temp-1 policy (see module doc)
    lp = token_logprobs(logits, tok)
    return tok.to(torch.int32), lp


def sample_tokens_fused(
    gumbel: torch.Tensor,  # (B, V) noise, ignored (may be None) at temp <= 0
    logits: torch.Tensor,  # (B, V)
    *,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    vocab_size: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched :func:`sample_token` through the fused sampling kernel (its
    plain version on the CPU)."""
    from repro_torch.kernels import ops as kops

    logits = logits.float()
    if temperature <= 0.0 or gumbel is None:
        gumbel = torch.zeros_like(logits)
    return kops.fused_sample(
        logits, gumbel, temperature=temperature, top_k=top_k, top_p=top_p,
        vocab_size=vocab_size)


# ---------------------------------------------------------------------------
# per-request noise: a counter-based integer hash
# ---------------------------------------------------------------------------
def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for 0 <= x < 2**32, exact in int64: the constant
    is split in 16-bit halves so no product passes 2**48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (bijective): xor-shift 16, multiply by
    0x7FEB352D, xor-shift 15, multiply by 0x846CA68B, xor-shift 16."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def request_noise(seeds: torch.Tensor, positions: torch.Tensor,
                  V: int) -> torch.Tensor:
    """(B, V) Gumbel(0, 1) noise for the token at ``positions[b]`` of the
    request seeded ``seeds[b]``, on the tensors' device.

    Formula, all integer arithmetic mod 2**32::

        key   = mix32(mix32(seed) ^ position)
        h     = mix32(mix32(key ^ v) + key)          v = vocab index
        u     = (h + 0.5) / 2**32                    in (0, 1), float64
        noise = float32(-log(-log(u)))

    The bits of ``h`` are the same on the CPU and on CUDA, and a row
    depends only on its own (seed, position), never on the batch.
    """
    seeds = seeds.long()
    positions = positions.long()
    key = _mix32(_mix32(seeds) ^ (positions & _M32))[:, None]  # (B, 1)
    v = torch.arange(V, dtype=torch.int64, device=seeds.device)[None, :]
    h = _mix32(_mix32(key ^ v) + key)
    u = (h.double() + 0.5) / 2.0 ** 32
    return (-torch.log(-torch.log(u))).float()


def act_noise(seed: int, rollout_round: int, cycle_step: int,
              env_ids, V: int, device=None) -> torch.Tensor:
    """(B, V) Gumbel(0, 1) noise for the closed-loop action draw of each
    env in ``env_ids`` at (``rollout_round``, ``cycle_step``) under the
    act path's base ``seed``: :func:`request_noise` with the row seed
    ``mix32(mix32(mix32(seed) ^ round) ^ step)`` and the env id as the
    position.  A row depends on its own env id alone, so any chunking of
    the env batch draws the same noise, with the same bits on the CPU
    and on CUDA.  (The JAX worker folds a threefry key by round, step
    and env id instead: the two draw different actions.)"""
    ids = torch.as_tensor(env_ids, dtype=torch.int64, device=device)
    row = torch.tensor([seed], dtype=torch.int64, device=ids.device)
    for v in (rollout_round, cycle_step):
        row = _mix32(_mix32(row) ^ (int(v) & _M32))
    return request_noise(row.expand(ids.shape[0]), ids, V)
