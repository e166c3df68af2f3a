"""Model assembly.  This slice ports ``init_model`` for dense stacks.

Per-layer params carry a leading layer axis, as in the JAX package's
scan-stacked pytree, so bridged weights keep their keys and shapes.
``forward``, ``decode_step`` and the static engine come with the next
slice; serving runs through :mod:`repro_torch.serve.layouts`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import DENSE, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    Params,
    init_embedding,
    init_mlp,
    init_rmsnorm,
)


def _init_attn_layer(gen, cfg: ModelConfig, dtype, device, *,
                     lead=()) -> Params:
    d_ff = cfg.d_ff if cfg.d_ff else 4 * cfg.d_model
    return {
        "ln1": init_rmsnorm(cfg.d_model, dtype, device, lead=lead),
        "attn": attn.init_attention(gen, cfg, dtype, device, lead=lead),
        "ln2": init_rmsnorm(cfg.d_model, dtype, device, lead=lead),
        "mlp": init_mlp(gen, cfg.d_model, d_ff, dtype, device, lead=lead),
    }


def init_model(gen: Optional[torch.Generator], cfg: ModelConfig,
               dtype=torch.float32, device: DeviceLike = None) -> Params:
    """Random weights for ``cfg`` on ``device`` (the card by default),
    drawn from ``gen``, a generator on that device (seed 0 when None)."""
    cfg.validate()
    if cfg.kind != DENSE:
        raise NotImplementedError(
            f"repro_torch.init_model ports the dense kind only, not "
            f"{cfg.kind}")
    device = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
    p: Params = {"embed": init_embedding(gen, cfg, dtype, device),
                 "ln_f": init_rmsnorm(cfg.d_model, dtype, device)}
    p["layers"] = _init_attn_layer(gen, cfg, dtype, device,
                                   lead=(cfg.num_layers,))
    return p


def map_params(fn: Callable[[torch.Tensor], Any], tree: Dict) -> Dict:
    """``fn`` applied to every tensor leaf of a nested param dict."""
    return {k: map_params(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def layer_params(layers: Params, i: int) -> Params:
    """The params of layer ``i``: views into the stacked tensors."""
    return map_params(lambda x: x[i], layers)
