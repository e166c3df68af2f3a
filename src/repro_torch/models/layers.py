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
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
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
    return p["tokens"][tokens]


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    if "unembed" in p:
        return x @ p["unembed"]
    return x @ p["tokens"].T


# ---------------------------------------------------------------------------
# log-softmax helpers used by RL losses
# ---------------------------------------------------------------------------
def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor,
                   vocab_size: int = 0) -> torch.Tensor:
    """Log-probability of each target token; logits (..., V), tokens (...).

    vocab_size > 0 masks the padded-vocab region so generation-time and
    recompute-time logprobs agree exactly.
    """
    logits = logits.float()
    if vocab_size:
        V = logits.shape[-1]
        idx = torch.arange(V, device=logits.device)
        logits = torch.where(idx < vocab_size, logits,
                             torch.full_like(logits, NEG_INF))
    logz = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, tokens[..., None].long())[..., 0]
    return picked - logz
