"""Paged-attention decode: the Hopper kernel's wrapper and its plain version.

One query token per sequence attends over a KV cache scattered across
fixed-size pages of a (P, page, KV, D) pool, addressed through per-request
block tables (page 0 is the trash page).  The kernel is
``csrc/paged_attention.cu``, built by :mod:`repro_torch.kernels._build`;
it replaces ``paged_attention_bhd`` of the JAX package's
``kernels/paged_attention.py``.  It deals each context's 32-token tiles
over up to 8 blocks of a cluster and merges their softmax partials;
:func:`split_partials_plain` and :func:`combine_splits_plain` are that
split and merge in plain torch, for the tests.

Layouts:
  q             (B, H, D)         bf16 or f32
  k/v pages     (P, page, KV, D)  bf16 or f32, contiguous
  block_tables  (B, nb)           int32
  context_lens  (B,)              int32
  out           (B, H, D)         q's type
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention_plain(q, k_pages, v_pages, block_tables, context_lens):
    """What the kernel computes, in plain torch: gather only the pages
    below ceil(max ctx / page), f32 scores, -1e30 mask past each context,
    softmax with a fully masked row forced to zero (an empty context
    gives zeros), output in q's type."""
    B, H, D = q.shape
    _, page, KV, _ = k_pages.shape
    G = H // KV
    lens = context_lens.long()
    max_ctx = int(lens.max()) if B else 0
    n_used = min(block_tables.shape[1], -(-max_ctx // page))
    if n_used <= 0:
        return torch.zeros_like(q)
    tables = block_tables[:, :n_used].long()
    S = n_used * page
    k = k_pages[tables].reshape(B, S, KV, D).float()
    v = v_pages[tables].reshape(B, S, KV, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(B, KV, G, D), k)
    s = s / math.sqrt(D)
    ok = torch.arange(S, device=q.device)[None, :] < lens[:, None]  # (B, S)
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m <= NEG_INF * 0.5, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bkgs,bskd->bkgd", p, v) / l
    return out.reshape(B, H, D).to(q.dtype)


def split_plan(nb: int, page: int):
    """(tile tokens, number of splits) of a table of ``nb`` pages, as the
    kernel's launcher in ``csrc/paged_attention.cu`` cuts it: tiles of
    32 tokens (one page if pages are larger), dealt round-robin to at most
    8 splits (split r takes tiles r, r + n_split, ...), from the table
    width alone."""
    pages_per_tile = 1 if page >= 32 else 32 // page
    n_tiles = -(-nb // pages_per_tile)
    return pages_per_tile * page, max(1, min(8, n_tiles))


def split_partials_plain(q, k_pages, v_pages, block_tables, context_lens):
    """Each split's softmax partial, in plain torch: (m, l, acc) per split
    as the kernel keeps them before its merge: the running max m
    (B, KV, n_split, G) of the scaled scores (-1e30 where every position
    is past the context), l = sum exp(s - m) and acc = sum exp(s - m) v
    (B, KV, n_split, G, D), all f32.  For the tests of
    :func:`combine_splits_plain`."""
    B, H, D = q.shape
    _, page, KV, _ = k_pages.shape
    G = H // KV
    nb = block_tables.shape[1]
    tile, n_split = split_plan(nb, page)
    S = nb * page
    k = k_pages[block_tables.long()].reshape(B, S, KV, D).float()
    v = v_pages[block_tables.long()].reshape(B, S, KV, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(B, KV, G, D), k)
    s = s / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    s = torch.where((pos[None, :] < context_lens.long()[:, None])
                    [:, None, None, :], s, NEG_INF)
    ms, ls, accs = [], [], []
    for r in range(n_split):
        mine = (pos // tile) % n_split == r  # this split's tiles
        sr = torch.where(mine, s, NEG_INF)
        m = sr.amax(dim=-1)
        p = torch.where(m[..., None] <= NEG_INF * 0.5, 0.0,
                        torch.exp(sr - m[..., None]))
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgs,bskd->bkgd", p, v))
    return (torch.stack(ms, 2), torch.stack(ls, 2), torch.stack(accs, 2))


def combine_splits_plain(m, l, acc, dtype=torch.float32):
    """Merge per-split partials in split order, as the kernel's cluster
    does: weights exp(m_r - max m) (0 for a split with no live position),
    out = sum w acc / sum w l, zeros where no split saw a live position.
    Returns (B, H, D) in ``dtype``."""
    B, KV, _, G, D = acc.shape
    mx = m.amax(dim=2, keepdim=True)
    w = torch.where(m <= NEG_INF * 0.5, 0.0, torch.exp(m - mx))
    den = (w * l).sum(dim=2)
    den = torch.where(den == 0.0, 1.0, den)
    out = (w[..., None] * acc).sum(dim=2) / den[..., None]
    return out.reshape(B, KV * G, D).to(dtype)


def paged_attention_bhd(q, k_pages, v_pages, block_tables, context_lens):
    """Launch the CUDA kernel on the tensors' card; returns (B, H, D)."""
    B, H, D = q.shape
    P, page, KV, Dk = k_pages.shape
    nb = block_tables.shape[1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention_bhd runs on CUDA tensors, got {dev}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables),
                    ("context_lens", context_lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _TYPES or k_pages.dtype not in _TYPES:
        raise TypeError(f"q {q.dtype} / pages {k_pages.dtype}: "
                        "float32 or bfloat16 only")
    if v_pages.dtype != k_pages.dtype or v_pages.shape != k_pages.shape:
        raise ValueError("k_pages and v_pages differ in type or shape")
    if Dk != D or H % KV or block_tables.shape[0] != B \
            or tuple(context_lens.shape) != (B,):
        raise ValueError(f"shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}, tables "
                         f"{tuple(block_tables.shape)}, lens "
                         f"{tuple(context_lens.shape)} do not agree")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("block_tables and context_lens must be int32")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("the page pools must be contiguous")
    # the kernel stages K/V with 16-byte loads
    if D % 8 or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("head_dim must be a multiple of 8 and the page "
                         "pools 16-byte aligned")
    # a warp carries at most 16 query rows and a lane 8 output columns
    if H // KV > 64 or D > 256:
        raise ValueError(f"{H // KV} query heads a KV head (at most 64) or "
                         f"head_dim {D} (at most 256)")
    q = q.contiguous()
    tables = block_tables.contiguous()
    lens = context_lens.contiguous()
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.paged_attention_bhd_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
            B, H, KV, D, page, nb, _TYPES[q.dtype], _TYPES[k_pages.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "paged_attention_bhd")
    paged_attention_bhd.launches += 1
    return out


paged_attention_bhd.launches = 0
