"""Shared building blocks on tensors, with dict params.

Counterpart of the JAX package's ``models/layers.py``: the same keys,
shapes and einsum layouts, so bridged weights drop in unchanged.
Initializers take an explicit ``torch.Generator`` and ``device``, and a
``lead`` shape for stacked layers (the JAX side vmaps one init per layer;
here a stacked tensor is filled layer by layer, so the float32 scratch
stays one layer in size).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

Params = Dict[str, Any]
NEG_INF = -1e30

# Φ(-2) and Φ(2): the truncation bounds of dense_init in probability space
_TRUNC_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_TRUNC_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------
def _fill(shape: Sequence[int], lead: Sequence[int], dtype, device,
          draw) -> torch.Tensor:
    """A ``lead + shape`` tensor whose every ``shape`` slice is ``draw()``
    (a float32 tensor of ``shape``), cast to ``dtype``."""
    out = torch.empty(tuple(lead) + tuple(shape), dtype=dtype, device=device)
    flat = out.view(-1, *shape)
    for i in range(flat.shape[0]):
        flat[i] = draw().to(dtype)
    return out


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype, device, *,
               scale: Optional[float] = None, lead: Sequence[int] = ()):
    """Truncated-normal (±2σ) fan-in init, by inverse CDF."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)

    def draw():
        u = torch.empty(tuple(shape), dtype=torch.float32, device=device)
        u.uniform_(_TRUNC_LO, _TRUNC_HI, generator=gen)
        x = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
        return x.clamp_(-2.0, 2.0) * std

    return _fill(shape, lead, dtype, device, draw)


def embed_init(gen: torch.Generator, shape: Sequence[int], dtype, device, *,
               lead: Sequence[int] = ()):
    def draw():
        x = torch.empty(tuple(shape), dtype=torch.float32, device=device)
        return x.normal_(0.0, 0.02, generator=gen)

    return _fill(shape, lead, dtype, device, draw)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def init_rmsnorm(d: int, dtype, device, *, lead: Sequence[int] = ()) -> Params:
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype,
                                device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm over the last dimension.  Under a ``"tp"`` marker in ``p``
    (``train.parallel``) that dimension is split over the model ranks:
    ``x`` and ``p["scale"]`` hold this rank's part, and the sum of
    squares is the total over the ranks."""
    dtype = x.dtype
    x = x.float()
    tp = p.get("tp")
    if tp is None:
        var = x.square().mean(dim=-1, keepdim=True)
    else:
        var = (tp.total(x.square().sum(dim=-1, keepdim=True))
               / (x.shape[-1] * tp.size))
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"].float()).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).
    Split-half (not interleaved) rotation, computed in float32."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)  # (half,)
    angles = positions[..., None].float() * freqs  # (..., seq, half)
    angles = angles[..., None, :]  # (..., seq, 1, half) broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------
def init_mlp(gen, d_model: int, d_ff: int, dtype, device, *,
             lead: Sequence[int] = ()) -> Params:
    return {
        "gate": dense_init(gen, (d_model, d_ff), dtype, device, lead=lead),
        "up": dense_init(gen, (d_model, d_ff), dtype, device, lead=lead),
        "down": dense_init(gen, (d_ff, d_model), dtype, device, lead=lead),
    }


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU.  Split over a layout's model axis (a ``"tp"`` marker in
    ``p``, ``train.parallel``): this rank's d_ff columns of ``gate`` and
    ``up`` and rows of ``down``, the input entering through "f" and the
    partial sums leaving through "g"."""
    tp = p.get("tp")
    if tp is not None:
        x = tp.enter(x)
    h = F.silu(x @ p["gate"]) * (x @ p["up"])
    y = h @ p["down"]
    return y if tp is None else tp.exit(y)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def init_embedding(gen, cfg: ModelConfig, dtype, device) -> Params:
    p: Params = {"tokens": embed_init(gen, (cfg.padded_vocab, cfg.d_model),
                                      dtype, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                  dtype, device)
    return p


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``tokens``.  Under a ``"tp"`` marker (``train.parallel``:
    this model rank's slice of the padded vocabulary, at ``rank * V /
    m``) a rank looks up the tokens of its slice, writes zeros for the
    others, and the sum over the model ranks leaves through "g"."""
    tp = p.get("tp")
    if tp is None:
        return p["tokens"][tokens]
    n = p["tokens"].shape[0]
    local = tokens - tp.rank * n
    mine = (local >= 0) & (local < n)
    rows = p["tokens"][torch.where(mine, local, 0)]
    return tp.exit(torch.where(mine[..., None], rows, 0.0))


class VocabShard:
    """Logits over one model rank's slice of the padded vocabulary:
    ``local`` (..., V / m), the slice at ``offset``.  :func:`unembed`
    returns it under a layout that splits the vocabulary; only
    :func:`token_logprobs` and :func:`token_entropy` read it, through
    the vocab-parallel log-softmax.  It is not a tensor, so a consumer
    that would take the slice for the whole vocabulary raises.  Indexing
    takes leading dimensions only."""
    __slots__ = ("local", "tp")

    def __init__(self, local: torch.Tensor, tp: Any):
        self.local, self.tp = local, tp

    @property
    def offset(self) -> int:
        return self.tp.rank * self.local.shape[-1]

    def __getitem__(self, idx) -> "VocabShard":
        idx = idx if isinstance(idx, tuple) else (idx,)
        if (any(i is Ellipsis for i in idx)
                or len(idx) >= self.local.dim()):
            raise IndexError("indexing reaches the vocabulary dimension of "
                             "logits split over the model ranks")
        return VocabShard(self.local[idx], self.tp)


def unembed(p: Params, x: torch.Tensor):
    """Logits: ``x`` times ``unembed``, or the tied ``tokens``
    transposed.  Under a ``"tp"`` marker the weight holds this model
    rank's vocabulary slice, ``x`` enters through "f", and the result is
    a :class:`VocabShard`."""
    tp = p.get("tp")
    if tp is not None:
        x = tp.enter(x)
    y = x @ p["unembed"] if "unembed" in p else x @ p["tokens"].T
    return y if tp is None else VocabShard(y, tp)


# ---------------------------------------------------------------------------
# log-softmax helpers used by RL losses
# ---------------------------------------------------------------------------
def _mask_padded(logits: torch.Tensor, vocab_size: int,
                 offset: int = 0) -> torch.Tensor:
    """f32 logits with the padded-vocab region (global index, ``offset``
    plus the local one, at or past ``vocab_size``) at -1e30."""
    logits = logits.float()
    if vocab_size:
        idx = torch.arange(logits.shape[-1], device=logits.device) + offset
        logits = torch.where(idx < vocab_size, logits,
                             torch.full_like(logits, NEG_INF))
    return logits


class _VocabLogSoftmax(torch.autograd.Function):
    """The log-softmax of logits split over the model ranks, read at the
    targets (log-probabilities) and, on request, summed against itself
    (entropies): the rows' max all-reduced (no gradient), the sum of
    exponentials all-reduced, the picked logit taken from the rank that
    holds the target and all-reduced, the entropy's sum all-reduced.
    Its inputs' gradients are local: everything after it is the same on
    every model rank, so each rank's output gradients are whole."""

    @staticmethod
    def forward(ctx, local, tokens, tp, offset, vocab_size, entropy):
        lg = _mask_padded(local, vocab_size, offset)
        m = tp.max(lg.max(dim=-1).values)
        s = tp.total(torch.exp(lg - m[..., None]).sum(dim=-1))
        logz = m + torch.log(s)
        logp = lg - logz[..., None]
        V = lg.shape[-1]
        lp = ent = None
        if tokens is not None:
            t = tokens.long() - offset
            mine = (t >= 0) & (t < V)
            t = torch.where(mine, t, 0)
            picked = torch.where(mine, lg.gather(-1, t[..., None])[..., 0],
                                 0.0)
            lp = tp.total(picked) - logz
        else:
            t = mine = None
        if entropy:
            ent = -tp.total((torch.exp(logp) * logp).sum(dim=-1))
        ctx.save_for_backward(logp, t, mine, ent)
        ctx.dtype = local.dtype
        zero = torch.zeros_like(logz)
        return (zero if lp is None else lp), (zero if ent is None else ent)

    @staticmethod
    def backward(ctx, g_lp, g_ent):
        logp, t, mine, ent = ctx.saved_tensors
        p = torch.exp(logp)
        grad = torch.zeros_like(logp)
        if t is not None:
            onehot = torch.zeros_like(logp).scatter_(
                -1, t[..., None], mine[..., None].float())
            grad = grad + g_lp[..., None] * (onehot - p)
        if ent is not None:
            grad = grad - g_ent[..., None] * p * (logp + ent[..., None])
        return grad.to(ctx.dtype), None, None, None, None, None


def token_logprobs(logits, tokens: torch.Tensor,
                   vocab_size: int = 0) -> torch.Tensor:
    """Log-probability of each target token; logits (..., V), tokens (...).

    vocab_size > 0 masks the padded-vocab region so generation-time and
    recompute-time logprobs agree exactly.  ``logits`` may be a
    :class:`VocabShard` (the vocab-parallel log-softmax).
    """
    if isinstance(logits, VocabShard):
        return _VocabLogSoftmax.apply(logits.local, tokens, logits.tp,
                                      logits.offset, vocab_size, False)[0]
    logits = _mask_padded(logits, vocab_size)
    logz = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, tokens[..., None].long())[..., 0]
    return picked - logz


def token_entropy(logits, vocab_size: int = 0) -> torch.Tensor:
    """Entropy of each row's softmax over the first ``vocab_size``
    entries; ``logits`` (..., V) or a :class:`VocabShard`."""
    if isinstance(logits, VocabShard):
        return _VocabLogSoftmax.apply(logits.local, None, logits.tp,
                                      logits.offset, vocab_size, True)[1]
    logp = torch.log_softmax(_mask_padded(logits, vocab_size), dim=-1)
    return -(torch.exp(logp) * logp).sum(-1)
