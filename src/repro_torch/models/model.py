"""Model assembly for dense and MoE stacks: ``init_model`` and the
full-sequence ``forward`` (logprob recompute and training).

Per-layer params carry a leading layer axis, as in the JAX package's
scan-stacked pytree, so bridged weights keep their keys and shapes; the
JAX ``lax.scan`` over that axis becomes a Python loop.  ``decode_step``,
``prefill`` and the static engine come with the static-engine slice;
serving runs through :mod:`repro_torch.serve.layouts`.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import DENSE, MOE, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (
    Params,
    embed,
    init_embedding,
    init_mlp,
    init_rmsnorm,
    mlp,
    rmsnorm,
    unembed,
)
from repro_torch.utils.treeutil import tree_leaves, tree_map


def _init_attn_layer(gen, cfg: ModelConfig, dtype, device, *,
                     lead=()) -> Params:
    d_ff = cfg.d_ff if cfg.d_ff else 4 * cfg.d_model
    return {
        "ln1": init_rmsnorm(cfg.d_model, dtype, device, lead=lead),
        "attn": attn.init_attention(gen, cfg, dtype, device, lead=lead),
        "ln2": init_rmsnorm(cfg.d_model, dtype, device, lead=lead),
        "mlp": init_mlp(gen, cfg.d_model, d_ff, dtype, device, lead=lead),
    }


def _init_moe_layer(gen, cfg: ModelConfig, dtype, device, *,
                    lead=()) -> Params:
    return {
        "ln1": init_rmsnorm(cfg.d_model, dtype, device, lead=lead),
        "attn": attn.init_attention(gen, cfg, dtype, device, lead=lead),
        "ln2": init_rmsnorm(cfg.d_model, dtype, device, lead=lead),
        "moe": moe_mod.init_moe(gen, cfg, dtype, device, lead=lead),
    }


_LAYER_INIT = {DENSE: _init_attn_layer, MOE: _init_moe_layer}


def init_model(gen: Optional[torch.Generator], cfg: ModelConfig,
               dtype=torch.float32, device: DeviceLike = None) -> Params:
    """Random weights for ``cfg`` on ``device`` (the card by default),
    drawn from ``gen``, a generator on that device (seed 0 when None)."""
    cfg.validate()
    if cfg.kind not in _LAYER_INIT:
        raise NotImplementedError(
            f"repro_torch.init_model ports the dense and MoE kinds only, "
            f"not {cfg.kind}")
    device = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
    p: Params = {"embed": init_embedding(gen, cfg, dtype, device),
                 "ln_f": init_rmsnorm(cfg.d_model, dtype, device)}
    p["layers"] = _LAYER_INIT[cfg.kind](gen, cfg, dtype, device,
                                        lead=(cfg.num_layers,))
    return p


def layer_params(layers: Params, i: int) -> Params:
    """The params of layer ``i``: views into the stacked tensors."""
    return tree_map(lambda x: x[i], layers)


def unstack_layers(layers: Params):
    """The per-layer param dicts of a stacked tree, as views made by one
    ``unbind`` per tensor: autograd then stacks each gradient once, where
    indexing layer by layer would add a full-size zero tensor per layer."""
    parts = tree_map(lambda t: t.unbind(0), layers)
    n = len(tree_leaves(parts)[0])
    return [tree_map(lambda ts, i=i: ts[i], parts) for i in range(n)]


# ===========================================================================
# Forward (training / inference logprobs) - full sequence
# ===========================================================================
def _attn_layer_fwd(lp: Params, cfg: ModelConfig, x, *, causal=True,
                    window=0):
    h = attn.attention(lp["attn"], cfg, rmsnorm(lp["ln1"], x, cfg.norm_eps),
                       causal=causal, window=window)
    x = x + h
    x = x + mlp(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps))
    return x


def _moe_layer_fwd(lp: Params, cfg: ModelConfig, x, *, window=0):
    h = attn.attention(lp["attn"], cfg, rmsnorm(lp["ln1"], x, cfg.norm_eps),
                       causal=True, window=window)
    x = x + h
    y, aux = moe_mod.moe_block(lp["moe"], cfg,
                               rmsnorm(lp["ln2"], x, cfg.norm_eps))
    return x + y, aux


def _layer_fwd(lp: Params, cfg: ModelConfig, x, *, window=0):
    """One layer of a dense or MoE stack: (x, the layer's aux loss or
    None)."""
    if cfg.kind == MOE:
        return _moe_layer_fwd(lp, cfg, x, window=window)
    return _attn_layer_fwd(lp, cfg, x, window=window), None


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            extra=None, *, remat: bool = False, return_hidden: bool = False):
    """Returns (logits (B, S, padded_vocab), aux_loss scalar), plus the
    final hidden state when ``return_hidden``.

    remat=True checkpoints each layer (activations recomputed in the
    backward pass).  An MoE stack sums each layer's aux loss, as JAX's
    scan carries it.  The JAX ``act_spec`` (sequence-parallel sharding) has
    no counterpart on one card.
    """
    if cfg.kind not in _LAYER_INIT:
        raise NotImplementedError(
            f"repro_torch.forward ports the dense and MoE kinds only, not "
            f"{cfg.kind}")
    x = embed(params["embed"], tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in unstack_layers(params["layers"]):
        body = functools.partial(_layer_fwd, lp, cfg,
                                 window=cfg.sliding_window)
        x, a = (checkpoint(body, x, use_reentrant=False) if remat
                else body(x))
        if a is not None:
            aux = aux + a
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    if return_hidden:
        return unembed(params["embed"], x), aux, x
    return unembed(params["embed"], x), aux
