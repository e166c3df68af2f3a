"""Attention: GQA/MHA projections, scaled dot product, the full-sequence
attention block (causal, windowed or bidirectional), cross-attention
(decoder to encoder, text to image tokens) and decode over a KV ring
buffer.

Counterpart of the JAX package's ``models/attention.py``.  Its
``chunked_sdpa`` (query-block chunking for S >= 2048) has no counterpart:
the full-sequence block goes through the flash-attention kernel, which
never materialises the (S, S) scores on the card.  Layouts:
  hidden      (B, S, d_model)
  q           (B, S, H, hd)
  k/v         (B, S, KV, hd)
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (
    NEG_INF,
    Params,
    apply_rope,
    dense_init,
    init_rmsnorm,
    rmsnorm,
)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def init_attention(gen, cfg: ModelConfig, dtype, device, *,
                   lead: Sequence[int] = ()) -> Params:
    hd = cfg.resolved_head_dim
    H, KV, d = cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    p: Params = {
        "wq": dense_init(gen, (d, H, hd), dtype, device, lead=lead),
        "wk": dense_init(gen, (d, KV, hd), dtype, device, lead=lead),
        "wv": dense_init(gen, (d, KV, hd), dtype, device, lead=lead),
        "wo": dense_init(gen, (H, hd, d), dtype, device, lead=lead),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", H), ("bk", KV), ("bv", KV)):
            p[name] = torch.zeros(tuple(lead) + (heads, hd), dtype=dtype,
                                  device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dtype, device, lead=lead)
        p["k_norm"] = init_rmsnorm(hd, dtype, device, lead=lead)
    return p


def qkv_project(
    p: Params, cfg: ModelConfig, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


# ---------------------------------------------------------------------------
# Core scaled-dot-product with GQA
# ---------------------------------------------------------------------------
def sdpa(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, KV, hd)
    v: torch.Tensor,  # (B, Sk, KV, hd)
    mask: Optional[torch.Tensor] = None,  # (B, 1|H, Sq, Sk) or (Sq, Sk), additive
) -> torch.Tensor:
    """Explicit products and a softmax, as the JAX path computes it: f32
    scores, additive -1e30 mask, probabilities cast to v's type before
    the PV product, GQA by reshape to (B, Sq, KV, G, hd)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    groups = H // KV
    if k.dtype != q.dtype:
        k = k.to(q.dtype)
        v = v.to(q.dtype)
    qg = q.reshape(B, Sq, KV, groups, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float()
    scores = scores / math.sqrt(hd)
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None, None, None]
        elif mask.dim() == 4:  # (B, 1|H, Sq, Sk) -> (B, KV, groups, Sq, Sk)
            mask = mask.reshape(B, -1, 1, Sq, mask.shape[-1])
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, H, hd)


def additive_mask(ok: torch.Tensor) -> torch.Tensor:
    """0 where ``ok``, -1e30 elsewhere, as float32."""
    return torch.where(ok, 0.0, NEG_INF).float()


def causal_mask(Sq: int, Sk: int, window: int = 0, device=None) -> torch.Tensor:
    """Additive (Sq, Sk) mask. Assumes queries are the last Sq of Sk keys."""
    qpos = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=device)[None, :]
    ok = kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    return additive_mask(ok)


# ---------------------------------------------------------------------------
# Full attention block (logprob recompute / training)
# ---------------------------------------------------------------------------
def attention(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,
    use_rope: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Projections, rope on q and k, flash attention (the kernel on the
    card, its plain version on the CPU), output projection.

    A dict a layout split over its model axis (``train.parallel``)
    carries a ``"tp"`` marker and this rank's heads: the query heads'
    columns of ``wq`` and rows of ``wo``, the KV heads they read.  The
    input enters through the marker's "f", the kernel runs on the local
    heads, and the row-parallel output's partial sums leave through its
    "g"."""
    tp = p.get("tp")
    if tp is not None:
        x = tp.enter(x)
    B, S, _ = x.shape
    q, k, v = qkv_project(p, cfg, x)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = kops.flash_attention(q, k, v, causal=causal, window=window)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y if tp is None else tp.exit(y)


def cross_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    kv_src: torch.Tensor) -> torch.Tensor:
    """x attends to kv_src (decoder to encoder, text to image tokens):
    no rope, no mask, plain products (the JAX package computes it in XLA,
    outside any Pallas kernel).  Split over a layout's model axis (a
    ``"tp"`` marker, as :func:`attention`'s): this rank's heads, ``x``
    and ``kv_src`` entering through "f", the output through "g"."""
    tp = p.get("tp")
    if tp is not None:
        x, kv_src = tp.enter(x), tp.enter(kv_src)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", kv_src, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", kv_src, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    out = sdpa(q, k, v, None)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y if tp is None else tp.exit(y)


def cross_attention_cached(p: Params, x: torch.Tensor, ck: torch.Tensor,
                           cv: torch.Tensor) -> torch.Tensor:
    """One query token a row, x (B, 1, d), against precomputed cross K/V
    (B, S_src, KV, hd)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    out = sdpa(q, ck, cv, None)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def precompute_cross_kv(p: Params, kv_src: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross K/V of ``kv_src`` in the promoted type of the source and the
    weights (f32 embeddings against bf16 weights give f32, as in JAX)."""
    dt = torch.promote_types(kv_src.dtype, p["wk"].dtype)
    k = torch.einsum("bsd,dhk->bshk", kv_src.to(dt), p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", kv_src.to(dt), p["wv"].to(dt))
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


# ---------------------------------------------------------------------------
# Decode with KV cache (ring buffer when windowed)
# ---------------------------------------------------------------------------
class KVCache(NamedTuple):
    k: torch.Tensor  # (B, W, KV, hd)
    v: torch.Tensor  # (B, W, KV, hd)
    positions: torch.Tensor  # (B, W) absolute position per slot, -1 = empty


def init_kv_cache(B: int, W: int, KV: int, hd: int, dtype,
                  device) -> KVCache:
    return KVCache(
        k=torch.zeros((B, W, KV, hd), dtype=dtype, device=device),
        v=torch.zeros((B, W, KV, hd), dtype=dtype, device=device),
        positions=torch.full((B, W), -1, dtype=torch.int32, device=device),
    )


def decode_attention(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, 1, d)
    cache: KVCache,
    pos: torch.Tensor,  # (B,) int: each row's current absolute position
    *,
    window: int = 0,
    use_rope: bool = True,
) -> Tuple[torch.Tensor, KVCache]:
    """One token per row against the row's KV ring.  Where the JAX
    function takes one scalar position for the batch, this takes one per
    row: row b writes its K/V at ring slot ``pos[b] % W`` and sees the
    slots holding positions in ``(pos[b] - window, pos[b]]``.  Returns
    new cache tensors; the input cache is not written."""
    B = x.shape[0]
    pos = pos.to(device=x.device, dtype=torch.long)
    q, k, v = qkv_project(p, cfg, x)  # (B, 1, H|KV, hd)
    posb = pos[:, None]
    if use_rope:
        q = apply_rope(q, posb, cfg.rope_theta)
        k = apply_rope(k, posb, cfg.rope_theta)
    W = cache.k.shape[1]
    # ring-buffer slot; when un-windowed W == max_seq so pos % W == pos
    rows = torch.arange(B, device=x.device)
    slot = pos % W
    newk, newv = cache.k.clone(), cache.v.clone()
    newpos = cache.positions.clone()
    newk[rows, slot] = k[:, 0].to(newk.dtype)
    newv[rows, slot] = v[:, 0].to(newv.dtype)
    newpos[rows, slot] = pos.to(newpos.dtype)
    valid = (newpos >= 0) & (newpos <= posb)
    if window > 0:
        valid &= newpos > posb - window
    mask = additive_mask(valid)[:, None, None, :]  # (B, 1, 1, W)
    out = sdpa(q, newk, newv, mask)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, KVCache(newk, newv, newpos)
