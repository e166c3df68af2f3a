"""Flash attention: the Hopper kernels' wrappers and their plain version.

Full-sequence attention with GQA and causal / sliding-window masks, as the
logprob recompute and the train step run it in every layer.  The forward
kernels are ``csrc/flash_attention.cu`` and replace ``flash_attention_bhsd``
of the JAX package's ``kernels/flash_attention.py``: bf16 (the recompute)
runs on the tensor cores (wgmma, fed by TMA), f32 (the train step, TF32
off) on the CUDA cores.  The backward kernel is
``csrc/flash_attention_bwd.cu`` (the JAX package has none: it trains
through XLA), f32 products on the tensor cores as 3xTF32 for both types,
with exact zeros in dq and dk on rows that see one key.
:class:`FlashAttention` ties the two into autograd.

head_dim limits: the forward kernels take D <= 256 (:data:`MAX_HEAD_DIM`,
wgmma's widest product), the backward D <= 192 (:data:`MAX_HEAD_DIM_BWD`:
its dK/dV block holds K, V, Q and dO as 64-row f32 tiles and a score
buffer, 213 KB of the SM's 227 KB at 192).  The zoo's widest is stablelm-12b's 160.  Past its
limit a wrapper raises; it never falls back to the plain version.

Layouts:
  q, out  (B, H, S, D)   bf16 or f32; any (b, h, s) strides, unit D stride
  k, v    (B, KV, S, D)  q's type
  lse     (B, H, S)      f32 log-sum-exp of the scaled, masked scores
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
MAX_HEAD_DIM_BWD = 192
_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def _mask(S: int, causal: bool, window: int, device) -> torch.Tensor:
    """(S, S) bool, True where query row i may see key j."""
    pos = torch.arange(S, device=device)
    ok = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        ok &= pos[None, :] <= pos[:, None]
    if window > 0:
        ok &= pos[None, :] > pos[:, None] - window
    return ok


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """What the kernel computes, in plain torch: f32 scores scaled by
    1/sqrt(D), -1e30 where the mask hides a key, softmax, output in q's
    type; GQA by grouping the query heads, K/V never replicated.
    Returns (out (B, H, S, D), lse (B, H, S) f32).  Autograd through it is
    the plain backward."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    qg = q.float().reshape(B, KV, H // KV, S, D)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) / math.sqrt(D)
    s = torch.where(_mask(S, causal, window, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    lse = torch.logsumexp(s, dim=-1)
    return out.reshape(B, H, S, D).to(q.dtype), lse.reshape(B, H, S)


def _strides(*ts) -> ctypes.Array:
    """The (b, head, s) element strides of each (B, heads, S, D) view."""
    vals = [st for t in ts for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _check(q, k, v, max_d: int = MAX_HEAD_DIM) -> None:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash attention kernels run on CUDA tensors, "
                         f"got {dev}")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _TYPES:
        raise TypeError(f"q {q.dtype}: float32 or bfloat16 only")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected (B, H, S, D) and "
                         "(B, KV, S, D)")
    B, H, S, D = q.shape
    KV = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, D) or KV < 1 \
            or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         "not agree (H must be a multiple of KV)")
    if not 1 <= D <= max_d:
        raise ValueError(f"head_dim {D}: the flash-attention "
                         f"{'forward' if max_d == MAX_HEAD_DIM else 'backward'}"
                         f" kernel takes head_dim 1..{max_d}")


def _unit_d(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def rows_aligned(t: torch.Tensor) -> bool:
    """Every (b, head, s) row of the (B, heads, S, D) view starts on a
    16-byte boundary, as the bf16 forward kernel's TMA copies need: an
    aligned base and strides in multiples of 16 bytes along every
    dimension with more than one index."""
    step = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or st % step == 0 for n, st in zip(t.shape[:3], t.stride()[:3]))


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` with a unit D stride and, for bf16, rows 16-byte aligned for
    the forward kernel's TMA: a view that is not is copied into fresh rows
    padded to a multiple of 8 elements (the padding is never read)."""
    t = _unit_d(t)
    if t.dtype == torch.bfloat16 and not rows_aligned(t):
        D = t.shape[-1]
        return t.new_empty((*t.shape[:-1], -(-D // 8) * 8))[..., :D].copy_(t)
    return t


def flash_attention_bhsd(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch the forward kernel on the tensors' card; returns
    (out (B, H, S, D) in q's type and layout, lse (B, H, S) f32).  A bf16
    view whose rows are not 16-byte aligned is copied first (see
    :func:`_staged`); the output is then contiguous."""
    _check(q, k, v)
    q, k, v = map(_staged, (q, k, v))
    B, H, S, D = q.shape
    out = torch.empty_like(q)  # q's strides: the model layout stays intact
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = _build.library().flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _strides(q, k, v, out), B, H, k.shape[1], S, D,
        int(causal), int(window), _TYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bhsd")
    flash_attention_bhsd.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0):
    """Launch the backward kernel on the tensors' card: (dq, dk, dv) in the
    inputs' types and layouts, from the forward's ``out`` and ``lse`` and
    the output gradient ``dout``."""
    _check(q, k, v, MAX_HEAD_DIM_BWD)
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError("out and dout must match q in shape and type")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("lse must be the forward's contiguous (B, H, S) f32")
    q, k, v, out, dout = map(_unit_d, (q, k, v, out, dout))
    B, H, S, D = q.shape
    KV = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.library()
    # dS tiles, delta = rowsum(dO * O), the head groups' partial dK and dV
    work = torch.empty(lib.flash_attention_bwd_workspace(
        B, H, KV, S, D, int(causal), int(window)), dtype=torch.float32,
        device=q.device)
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), work.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        _strides(q, k, v, out, dout, dq, dk, dv), B, H, KV, S, D,
        int(causal), int(window), _TYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bhsd.launches = 0
flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = flash_attention_bhsd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None
