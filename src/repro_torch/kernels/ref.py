"""Plain-torch oracles for the ported kernels, line for line with the JAX
package's ``kernels/ref.py`` (the allclose references)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q (B, H, S, D); k/v (B, KV, S, D) -> (B, H, S, D)."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    G = H // KV
    kf = torch.repeat_interleave(k, G, dim=1).float()
    vf = torch.repeat_interleave(v, G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf)
    s = s / math.sqrt(D)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    s = torch.where(ok[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def fused_sample_ref(logits, gumbel, *, temperature=1.0, top_k=0,
                     top_p=1.0, vocab_size=0):
    """Oracle for the fused sampling kernel: the unfused serving path
    (temperature -> top-k -> top-p -> Gumbel-max categorical) with the
    Gumbel noise passed in, plus the behaviour logprob under the
    unfiltered temperature-1 policy.

    logits/gumbel (B, V) -> (token (B,) int32, logprob (B,) float32)
    """
    logits = logits.float()
    V = logits.shape[-1]
    if 0 < vocab_size < V:
        idx = torch.arange(V, device=logits.device)
        logits = torch.where(idx < vocab_size, logits, NEG_INF)
    if temperature <= 0.0:
        tok = torch.argmax(logits, dim=-1)
    else:
        x = logits / temperature
        if 0 < top_k < V:
            vals = torch.topk(x, top_k, dim=-1).values
            x = torch.where(x < vals[..., -1:], NEG_INF, x)
        if top_p < 1.0:
            srt = torch.sort(x, dim=-1, descending=True).values
            cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
            cut = srt.gather(-1, (cum < top_p).sum(-1, keepdim=True))
            x = torch.where(x < cut, NEG_INF, x)
        tok = torch.argmax(x + gumbel.float(), dim=-1)
    lse = torch.logsumexp(logits, dim=-1)
    lp = logits.gather(-1, tok[..., None])[..., 0] - lse
    return tok.to(torch.int32), lp.float()


def paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens):
    """Single-token decode attention over a paged KV cache.

    q            (B, H, D)       one query token per sequence
    k_pages      (P, page, KV, D) page pool (page 0 = trash page)
    v_pages      (P, page, KV, D)
    block_tables (B, nb) int32   per-request page ids (trash-padded)
    context_lens (B,)    int32   valid tokens per request
    -> (B, H, D)
    """
    B, H, D = q.shape
    P, page, KV, _ = k_pages.shape
    nb = block_tables.shape[1]
    G = H // KV
    tables = block_tables.long()
    # gather the logical (B, nb*page, KV, D) K/V views through the tables
    k = k_pages[tables].reshape(B, nb * page, KV, D)
    v = v_pages[tables].reshape(B, nb * page, KV, D)
    kf = torch.repeat_interleave(k.float(), G, dim=2)  # (B, S, H, D)
    vf = torch.repeat_interleave(v.float(), G, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float(), kf)
    s = s / math.sqrt(D)
    pos = torch.arange(nb * page, device=q.device)[None, :]
    ok = pos < context_lens.long()[:, None]
    s = torch.where(ok[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # empty context (context_len == 0): zeros, not a softmax over the mask
    p = torch.where((context_lens > 0)[:, None, None], p, 0.0)
    return torch.einsum("bhs,bshd->bhd", p, vf).to(q.dtype)


def grouped_matmul_ref(buf, w):
    """buf (E, C, D) @ w (E, D, F) per expert, in f32 -> buf's type."""
    return torch.einsum("ecd,edf->ecf", buf.float(), w.float()).to(buf.dtype)


def moe_decode_ref(x, expert_idx, gate_vals, gate_w, up_w, down_w):
    """Oracle for the grouped MoE decode GEMM: dense all-experts compute
    plus the exact top-k combine matrix (no capacity, no drops).

    x (T, d); expert_idx/gate_vals (T, k); gate_w/up_w (E, d, f);
    down_w (E, f, d) -> (T, d)
    """
    T = x.shape[0]
    E = gate_w.shape[0]
    xf = x.float()
    h = torch.nn.functional.silu(
        torch.einsum("td,edf->tef", xf, gate_w.float())
    ) * torch.einsum("td,edf->tef", xf, up_w.float())
    all_out = torch.einsum("tef,efd->ted", h, down_w.float())
    combine = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    combine.scatter_(1, expert_idx.long(), gate_vals.float())
    return torch.einsum("te,ted->td", combine, all_out).to(x.dtype)


def ssd_scan_ref(x, dt, A, Bm, Cm, D):
    """Oracle matching ssd_scan_bhcsp layouts.

    x (B, H, nc, s, P); dt (B, H, nc, s); A/D (B, H); Bm/Cm (B, nc, s, N).
    Sequential state recurrence — obviously correct, O(L) steps.
    """
    B, H, nc, s, P = x.shape
    N = Bm.shape[-1]
    L = nc * s
    xf = x.float().permute(0, 2, 3, 1, 4).reshape(B, L, H, P)
    dtf = dt.float().permute(0, 2, 3, 1).reshape(B, L, H)
    Bf = Bm.float().reshape(B, L, N)
    Cf = Cm.float().reshape(B, L, N)
    A, D = A.float(), D.float()
    state = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(L):
        decay = torch.exp(dtf[:, i] * A)  # (B, H)
        upd = (dtf[:, i, :, None, None] * xf[:, i, :, :, None]
               * Bf[:, i, None, None, :])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, i]))
    y = torch.stack(ys, dim=1)  # (B, L, H, P)
    y = y + xf * D[:, None, :, None]
    y = y.reshape(B, nc, s, H, P).permute(0, 3, 1, 2, 4)
    return y.to(x.dtype)


def ssm_state_update_ref(state, x, dt, A, Bm, Cm, D):
    """Oracle for the single-token SSD state update (ops layout:
    per-head A/D vectors broadcast over batch inside the wrapper).

    state (B, H, P, N); x (B, H, P); dt (B, H); A/D (H,); Bm/Cm (B, N)
    -> (y (B, H, P) f32, new_state (B, H, P, N) f32)
    """
    state = state.float()
    xf = x.float()
    dtf = dt.float()
    decay = torch.exp(dtf * A[None, :])  # (B, H)
    upd = (dtf[:, :, None, None] * xf[:, :, :, None]) * Bm.float()[
        :, None, None, :]
    new_state = state * decay[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm.float())
    y = y + xf * D[None, :, None]
    return y, new_state
