"""Model assembly for dense, MoE, SSM and hybrid stacks: ``init_model``,
the full-sequence ``forward`` (logprob recompute and training), and for
the SSM and hybrid kinds ``init_decode_state`` and ``decode_step`` (the
state cache layout's step).

Per-layer params carry leading layer axes, as in the JAX package's
scan-stacked pytree (a hybrid stack's ``layers`` has two: groups, then
SSM layers a group), so bridged weights keep their keys and shapes; the
JAX ``lax.scan`` over those axes becomes a Python loop.  ``decode_step``
of the dense and MoE kinds, ``prefill`` and the static engine come with
the static-engine slice; dense and MoE serving runs through
:mod:`repro_torch.serve.layouts`.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import DENSE, HYBRID, MOE, SSM, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import KVCache
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


def _init_ssm_layer(gen, cfg: ModelConfig, dtype, device, *,
                    lead=()) -> Params:
    return {
        "ln1": init_rmsnorm(cfg.d_model, dtype, device, lead=lead),
        "mixer": ssm_mod.init_mamba2(gen, cfg, dtype, device, lead=lead),
    }


_LAYER_INIT = {DENSE: _init_attn_layer, MOE: _init_moe_layer,
               SSM: _init_ssm_layer, HYBRID: _init_ssm_layer}


def _hybrid_groups(cfg: ModelConfig) -> Tuple[int, int]:
    per = cfg.attn_every
    assert cfg.num_layers % per == 0, (cfg.num_layers, per)
    return cfg.num_layers // per, per


def init_model(gen: Optional[torch.Generator], cfg: ModelConfig,
               dtype=torch.float32, device: DeviceLike = None) -> Params:
    """Random weights for ``cfg`` on ``device`` (the card by default),
    drawn from ``gen``, a generator on that device (seed 0 when None).
    A hybrid stack's SSM layers have leading axes (groups, per group) and
    its one shared attention layer none."""
    cfg.validate()
    if cfg.kind not in _LAYER_INIT:
        raise NotImplementedError(
            f"repro_torch.init_model ports the dense, MoE, SSM and hybrid "
            f"kinds, not {cfg.kind}")
    device = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
    p: Params = {"embed": init_embedding(gen, cfg, dtype, device),
                 "ln_f": init_rmsnorm(cfg.d_model, dtype, device)}
    lead = (_hybrid_groups(cfg) if cfg.kind == HYBRID
            else (cfg.num_layers,))
    p["layers"] = _LAYER_INIT[cfg.kind](gen, cfg, dtype, device, lead=lead)
    if cfg.kind == HYBRID:
        p["shared_attn"] = _init_attn_layer(gen, cfg, dtype, device)
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


def _ssm_layer_fwd(lp: Params, cfg: ModelConfig, x):
    return x + ssm_mod.mamba2_block(lp["mixer"], cfg,
                                    rmsnorm(lp["ln1"], x, cfg.norm_eps))


def _hybrid_group_fwd(gp: Params, shared: Params, cfg: ModelConfig, x):
    """One hybrid group: its SSM layers, then the shared attention block,
    always windowed (``sliding_window or 4096``)."""
    for lp in unstack_layers(gp):
        x = _ssm_layer_fwd(lp, cfg, x)
    return _attn_layer_fwd(shared, cfg, x, window=cfg.sliding_window or 4096)


def _layer_fwd(lp: Params, cfg: ModelConfig, x, *, window=0,
               shared: Optional[Params] = None):
    """One layer of a dense, MoE or SSM stack, or one group of a hybrid
    stack with its ``shared`` attention layer: (x, the layer's aux loss or
    None)."""
    if cfg.kind == MOE:
        return _moe_layer_fwd(lp, cfg, x, window=window)
    if cfg.kind == SSM:
        return _ssm_layer_fwd(lp, cfg, x), None
    if cfg.kind == HYBRID:
        return _hybrid_group_fwd(lp, shared, cfg, x), None
    return _attn_layer_fwd(lp, cfg, x, window=window), None


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            extra=None, *, remat: bool = False, return_hidden: bool = False):
    """Returns (logits (B, S, padded_vocab), aux_loss scalar), plus the
    final hidden state when ``return_hidden``.

    remat=True checkpoints each layer (each group of a hybrid stack, as
    JAX does; activations recomputed in the backward pass).  An MoE stack
    sums each layer's aux loss, as JAX's scan carries it.  The JAX
    ``act_spec`` (sequence-parallel sharding) has no counterpart on one
    card.
    """
    if cfg.kind not in _LAYER_INIT:
        raise NotImplementedError(
            f"repro_torch.forward ports the dense, MoE, SSM and hybrid "
            f"kinds, not {cfg.kind}")
    x = embed(params["embed"], tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in unstack_layers(params["layers"]):
        body = functools.partial(_layer_fwd, lp, cfg,
                                 window=cfg.sliding_window,
                                 shared=params.get("shared_attn"))
        x, a = (checkpoint(body, x, use_reentrant=False) if remat
                else body(x))
        if a is not None:
            aux = aux + a
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    if return_hidden:
        return unembed(params["embed"], x), aux, x
    return unembed(params["embed"], x), aux


# ===========================================================================
# Decode state and step (SSM and hybrid kinds)
# ===========================================================================
class DecodeState(NamedTuple):
    """Union cache across arch kinds; unused members are () placeholders."""
    kv: Any = ()          # stacked KVCache for self-attn layers
    ssm: Any = ()         # stacked SSMState
    cross_kv: Any = ()    # precomputed (k, v) for cross-attn layers
    shared_kv: Any = ()   # hybrid: per-application KVCache for the shared block


def _stack_kv(cfg: ModelConfig, shape0, B, W, dtype, device) -> KVCache:
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return KVCache(
        k=torch.zeros(shape0 + (B, W, KV, hd), dtype=dtype, device=device),
        v=torch.zeros(shape0 + (B, W, KV, hd), dtype=dtype, device=device),
        positions=torch.full(shape0 + (B, W), -1, dtype=torch.int32,
                             device=device),
    )


def _stack_ssm_state(cfg: ModelConfig, shape0, B, dtype,
                     device) -> ssm_mod.SSMState:
    s = cfg.ssm
    nh, p, n = cfg.num_ssm_heads, s.head_dim, s.state_size
    conv_ch = cfg.d_inner + 2 * n
    return ssm_mod.SSMState(
        ssm=torch.zeros(shape0 + (B, nh, p, n), dtype=torch.float32,
                        device=device),
        conv=torch.zeros(shape0 + (B, s.conv_width - 1, conv_ch),
                         dtype=dtype, device=device),
    )


def init_decode_state(cfg: ModelConfig, B: int, cache_len: int,
                      dtype=torch.float32,
                      device: DeviceLike = None) -> DecodeState:
    """The decode cache of ``B`` rows: per SSM layer the f32 SSD state and
    the conv window; for a hybrid stack also one KV ring per application
    of the shared attention block, of ``min(cache_len, sliding_window or
    4096)`` slots.  The dense and MoE kinds come with the static engine."""
    device = resolve_device(device)
    w = cfg.sliding_window
    if cfg.kind == SSM:
        return DecodeState(ssm=_stack_ssm_state(cfg, (cfg.num_layers,), B,
                                                dtype, device))
    if cfg.kind == HYBRID:
        n_groups, per = _hybrid_groups(cfg)
        Wh = min(cache_len, w or 4096)
        return DecodeState(
            ssm=_stack_ssm_state(cfg, (n_groups, per), B, dtype, device),
            shared_kv=_stack_kv(cfg, (n_groups,), B, Wh, dtype, device),
        )
    raise NotImplementedError(
        f"repro_torch.init_decode_state ports the SSM and hybrid kinds; "
        f"{cfg.kind} comes with the static engine")


def _attn_decode_layer(lp, cfg, x, cache: KVCache, pos, window):
    h, cache = attn.decode_attention(
        lp["attn"], cfg, rmsnorm(lp["ln1"], x, cfg.norm_eps), cache, pos,
        window=window)
    x = x + h
    x = x + mlp(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps))
    return x, cache


def _ssm_decode_layer(lp, cfg, x, st: ssm_mod.SSMState):
    y, st = ssm_mod.mamba2_decode(
        lp["mixer"], cfg, rmsnorm(lp["ln1"], x, cfg.norm_eps), st)
    return x + y, st


def _stack_states(states, shape0) -> ssm_mod.SSMState:
    return ssm_mod.SSMState(
        *(torch.stack([getattr(st, f) for st in states]).reshape(
            shape0 + getattr(states[0], f).shape)
          for f in ssm_mod.SSMState._fields))


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                state: DecodeState, pos) -> Tuple[torch.Tensor, DecodeState]:
    """One token for every row: token (B, 1) -> (logits (B, 1, V), the new
    state).  ``pos`` holds each row's absolute position, (B,) (a scalar is
    taken for every row); the JAX function takes one scalar for the batch
    and the JAX state layout vmaps it over rows.  Only the hybrid's shared
    attention reads it.  Every SSM layer's state update goes through
    ``kernels.ops.ssm_state_update``.  Returns new state tensors; the
    input state is not written."""
    x = embed(params["embed"], token)  # (B, 1, d)
    pos = torch.as_tensor(pos, device=x.device).expand(x.shape[0])
    if cfg.kind == SSM:
        new = []
        for i, lp in enumerate(unstack_layers(params["layers"])):
            st = ssm_mod.SSMState(state.ssm.ssm[i], state.ssm.conv[i])
            x, st = _ssm_decode_layer(lp, cfg, x, st)
            new.append(st)
        state = state._replace(ssm=_stack_states(new, (cfg.num_layers,)))
    elif cfg.kind == HYBRID:
        shared = params["shared_attn"]
        wh = cfg.sliding_window or 4096
        n_groups, per = _hybrid_groups(cfg)
        new, kvs = [], []
        for g, gp in enumerate(unstack_layers(params["layers"])):
            for j, lp in enumerate(unstack_layers(gp)):
                st = ssm_mod.SSMState(state.ssm.ssm[g, j],
                                      state.ssm.conv[g, j])
                x, st = _ssm_decode_layer(lp, cfg, x, st)
                new.append(st)
            kv = KVCache(*(t[g] for t in state.shared_kv))
            x, kv = _attn_decode_layer(shared, cfg, x, kv, pos, wh)
            kvs.append(kv)
        state = state._replace(
            ssm=_stack_states(new, (n_groups, per)),
            shared_kv=KVCache(*(torch.stack(ts) for ts in zip(*kvs))))
    else:
        raise NotImplementedError(
            f"repro_torch.decode_step ports the SSM and hybrid kinds; "
            f"{cfg.kind} comes with the static engine")
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return unembed(params["embed"], x), state
