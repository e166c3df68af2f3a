"""Paged-attention decode: the Hopper kernel's wrapper and its plain version.

One query token per sequence attends over a KV cache scattered across
fixed-size pages of a (P, page, KV, D) pool, addressed through per-request
block tables (page 0 is the trash page).  The kernel is
``csrc/paged_attention.cu``, built by :mod:`repro_torch.kernels._build`;
it replaces ``paged_attention_bhd`` of the JAX package's
``kernels/paged_attention.py``.

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
    q = q.contiguous()
    tables = block_tables.contiguous()
    lens = context_lens.contiguous()
    out = torch.empty_like(q)
    lib = _build.library()
    err = lib.paged_attention_bhd_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
        B, H, KV, D, page, nb, _TYPES[q.dtype], _TYPES[k_pages.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "paged_attention_bhd")
    paged_attention_bhd.launches += 1
    return out


paged_attention_bhd.launches = 0
