"""Dispatch from model layouts onto the kernels.

A tensor on the card goes to the hand-written CUDA kernel; a tensor on
the CPU goes to the kernel's plain PyTorch version.  A tensor on the
meta device, which holds no data, goes to the kernel's footprint
(``kernels.meta``, the dry-run's route): one operator a launch that
allocates what the card's wrapper allocates and saves what its
``autograd.Function`` saves, counted at its plain version's FLOPs; the
kernels no dry-run step reaches (K1, K2, K4) take their plain versions
there.  There is no fallback: a failed launch raises.
Each wrapper launches under its tensors' card (``torch.cuda.device``):
the C launchers set a kernel's shared-memory attribute and launch on
the calling thread's current device, and a worker rebound to another
card than the process's current one keeps its tensors there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import meta as _kmeta
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import sampling as _samp
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import ssm_update as _ssu


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"no kernel route for device {t.device}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Model layout (B, S, H, D) / (B, S, KV, D) -> (B, S, H, D).  On the
    card the forward and backward are kernels (:class:`FlashAttention`),
    launched on transposed views (no copies)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if _on_card(q):
        out = _fa.FlashAttention.apply(qt, kt, vt, causal, window)
    elif q.device.type == "meta":
        out = _kmeta.FlashAttention.apply(qt, kt, vt, causal, window)
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
    if _on_card(x):
        fn = _gmm.moe_decode_gmm
    elif x.device.type == "meta":
        fn = _kmeta.moe_decode
    else:
        fn = _gmm.moe_decode_gmm_plain
    return fn(x, expert_idx, gate_vals, gate_w, up_w, down_w)


def ssd_scan(x, dt, A, Bm, Cm, D, chunk: int):
    """Mamba2 SSD chunked scan in the model layout (see
    ``models.ssm.mamba2_block``): x (B, L, H, P), dt (B, L, H), A (H,),
    Bm/Cm (B, L, N), D (H,) -> y (B, L, H, P) in x's type.  L that is no
    multiple of ``chunk`` is padded with zeros and cut back.  On the card
    the forward and backward are kernels (:class:`SSDScan`), launched on
    transposed views (no copies); dt, A and D go in as f32, Bm and Cm in
    x's type."""
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-L) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = (L + pad) // chunk
    xk = x.reshape(B, nc, chunk, H, P).permute(0, 3, 1, 2, 4)
    dtk = dt.reshape(B, nc, chunk, H).permute(0, 3, 1, 2)
    Bk = Bm.reshape(B, nc, chunk, N)
    Ck = Cm.reshape(B, nc, chunk, N)
    Ab, Db = A.expand(B, H), D.expand(B, H)
    if _on_card(x) or x.device.type == "meta":
        args = (xk, dtk.float(), Ab.float(), Bk.to(x.dtype), Ck.to(x.dtype),
                Db.float())
        save = torch.is_grad_enabled() and any(t.requires_grad for t in args)
        fn = _ssd.SSDScan if _on_card(x) else _kmeta.SSDScan
        y = fn.apply(*args, save)
    else:
        y = _ssd.ssd_scan_plain(xk, dtk, Ab, Bk, Ck, Db)
    return y.permute(0, 2, 3, 1, 4).reshape(B, L + pad, H, P)[:, :L]


def ssm_state_update(state, x, dt, A, Bm, Cm, D):
    """Single-token SSD state update (``models.ssm.mamba2_decode``
    layout): state (B, H, P, N) f32, x (B, H, P), dt (B, H), A (H,),
    Bm/Cm (B, N), D (H,) -> (y (B, H, P) f32, new_state (B, H, P, N) f32)."""
    B, H = dt.shape
    if _on_card(state):
        fn = _ssu.ssm_state_update_bh
    elif state.device.type == "meta":
        fn = _kmeta.ssm_state_update
    else:
        fn = _ssu.ssm_state_update_plain
    return fn(state, x, dt, A.expand(B, H), Bm, Cm, D.expand(B, H))
