"""Dispatch from model layouts onto the kernels.

A tensor on the card goes to the hand-written CUDA kernel; a tensor on
the CPU goes to the kernel's plain PyTorch version.  There is no
fallback: a failed launch raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import sampling as _samp


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel route for device {t.device}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Model layout (B, S, H, D) / (B, S, KV, D) -> (B, S, H, D).  On the
    card the forward and backward are kernels (:class:`FlashAttention`),
    launched on transposed views (no copies)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if _on_card(q):
        out = _fa.FlashAttention.apply(qt, kt, vt, causal, window)
    else:
        out, _ = _fa.flash_attention_plain(qt, kt, vt, causal=causal,
                                           window=window)
    return out.transpose(1, 2)


def paged_attention(q, k_pages, v_pages, block_tables, context_lens):
    """Decode-time paged attention: q (B, H, D) over a (P, page, KV, D)
    page pool addressed through int32 block tables (B, nb) and context
    lengths (B,)."""
    fn = (_pa.paged_attention_bhd if _on_card(q)
          else _pa.paged_attention_plain)
    return fn(q, k_pages, v_pages, block_tables, context_lens)


def fused_sample(logits, gumbel, *, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, vocab_size: int = 0):
    """Fused temperature+top-k+top-p+Gumbel-max sampling over (B, V)
    logits; gumbel is the caller's per-row Gumbel(0,1) noise.  Returns
    (token (B,) int32, behaviour logprob (B,) float32)."""
    fn = _samp.fused_sample_bv if _on_card(logits) else _samp.fused_sample_plain
    return fn(logits, gumbel, temperature=temperature, top_k=top_k,
              top_p=top_p, vocab_size=vocab_size)


def grouped_matmul(buf, w, rows=None):
    """out[e] = buf[e] @ w[e] over (E, C, D) x (E, D, F), summed in f32,
    in buf's type; ``rows`` (E,) int32 limits each expert's rows."""
    fn = _gmm.grouped_matmul if _on_card(buf) else _gmm.grouped_matmul_plain
    return fn(buf, w, rows)


def moe_decode(x, expert_idx, gate_vals, gate_w, up_w, down_w):
    """Drop-free exact top-k decode FFN (token->expert gather + grouped
    per-expert products + combine): x (T, d), expert_idx/gate_vals
    (T, k), gate_w/up_w (E, d, f), down_w (E, f, d) -> (T, d)."""
    fn = _gmm.moe_decode_gmm if _on_card(x) else _gmm.moe_decode_gmm_plain
    return fn(x, expert_idx, gate_vals, gate_w, up_w, down_w)
