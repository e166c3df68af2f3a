"""Optimizers by hand (no ``torch.optim``): AdamW + global-norm clip +
schedules.

Counterpart of the JAX package's ``train/optimizer.py``.  The state is a
plain tree mirroring the params, with f32 moments.  Unlike the JAX
functions, the updates write the params and moments IN PLACE and return
the same tensors: on one card that saves three f32 copies of the model
(at yi-9b width, 7.7 GB each for 8 layers).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.utils.treeutil import global_norm, tree_map

Params = Any


class AdamWState(NamedTuple):
    step: int
    mu: Params
    nu: Params


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    warmup_steps: int = 0
    total_steps: int = 0  # 0 = constant lr after warmup
    min_lr_frac: float = 0.1


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init_adamw(params: Params) -> AdamWState:
    return AdamWState(step=0, mu=tree_map(_zeros_f32, params),
                      nu=tree_map(_zeros_f32, params))


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def schedule_lr(cfg: AdamWConfig, step: int) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac, in f32 as the JAX
    version computes it (a 0-dim tensor on the host)."""
    step = _f32(float(step))
    lr = _f32(cfg.lr)
    if cfg.warmup_steps > 0:
        warm = torch.clamp((step + 1.0) / cfg.warmup_steps, max=1.0)
    else:
        warm = 1.0
    if cfg.total_steps > 0:
        frac = torch.clamp(
            (step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        decay = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    else:
        decay = 1.0
    return lr * warm * decay


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


def adamw_update(
    cfg: AdamWConfig,
    params: Params,
    grads: Params,
    state: AdamWState,
    grad_norm: Optional[Callable[[Params], torch.Tensor]] = None,
) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step: global-norm clip first, bias-corrected f32 moments,
    decoupled weight decay on tensors of ndim >= 2 only, the update cast
    back to each param's type.  ``params``, ``state.mu`` and ``state.nu``
    are updated in place; ``grads`` is left as it is.  Over shards
    (``train.parallel``) the three trees hold this rank's shards, and
    ``grad_norm`` gives the whole gradient's norm (``Layout.grad_norm``:
    each shard counted once over the ranks)."""
    gnorm = (grad_norm or global_norm)(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm) if cfg.clip_norm > 0 else None
    step = state.step + 1
    lr = schedule_lr(cfg, state.step)
    lr_f = float(lr)
    b1c = float(1.0 - _f32(cfg.b1) ** step)
    b2c = float(1.0 - _f32(cfg.b2) ** step)

    @torch.no_grad()
    def upd(p, g, m, v):
        g = g.float()
        if scale is not None:
            g = g * scale
        m.mul_(cfg.b1).add_(g, alpha=1.0 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1.0 - cfg.b2)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay > 0 and p.dim() >= 2:
            delta += cfg.weight_decay * p.float()
        p.copy_(p.float() - lr_f * delta)
        return p

    tree_map(upd, params, grads, state.mu, state.nu)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), metrics


# ---------------------------------------------------------------------------
# SGD (used by tests as a simple reference and for the critic warm start)
# ---------------------------------------------------------------------------
class SGDState(NamedTuple):
    step: int


def init_sgd(params: Params) -> SGDState:
    return SGDState(step=0)


def sgd_update(lr: float, params: Params, grads: Params, state: SGDState
               ) -> Tuple[Params, SGDState, Dict[str, torch.Tensor]]:
    """p -= lr * g, in f32, written back in place."""
    gnorm = global_norm(grads)

    @torch.no_grad()
    def upd(p, g):
        p.copy_(p.float() - lr * g.float())
        return p

    tree_map(upd, params, grads)
    return params, SGDState(step=state.step + 1), {"grad_norm": gnorm}
