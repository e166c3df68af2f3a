"""Model assembly for every arch kind of the zoo (dense, MoE, SSM, hybrid,
VLM, encoder-decoder): ``init_model``, the full-sequence ``forward``
(logprob recompute and training) with ``encode``, and the decode path:
``init_decode_state``, ``precompute_cross_caches``, ``decode_step`` and
``prefill`` (the static engine's, and the state cache layout's step).

Per-layer params carry leading layer axes, as in the JAX package's
scan-stacked pytree (a hybrid stack's ``layers`` and a VLM's have two:
groups, then layers a group; a VLM's ``cross_layers`` and an
encoder-decoder's ``enc_layers`` one), so bridged weights keep their keys
and shapes; the JAX ``lax.scan`` over those axes becomes a Python loop.
Paged serving of the dense and MoE kinds runs through
:mod:`repro_torch.serve.layouts`.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (DENSE, ENCDEC, HYBRID, MOE, SSM, VLM,
                                      ModelConfig)
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


def _init_cross_layer(gen, cfg: ModelConfig, dtype, device, *,
                      lead=()) -> Params:
    d_ff = cfg.d_ff if cfg.d_ff else 4 * cfg.d_model
    return {
        "ln1": init_rmsnorm(cfg.d_model, dtype, device, lead=lead),
        "xattn": attn.init_attention(gen, cfg, dtype, device, lead=lead),
        "ln2": init_rmsnorm(cfg.d_model, dtype, device, lead=lead),
        "mlp": init_mlp(gen, cfg.d_model, d_ff, dtype, device, lead=lead),
        # llama3.2-style tanh gate
        "gate": torch.zeros(tuple(lead) + (1,), dtype=dtype, device=device),
    }


def _init_encdec_dec_layer(gen, cfg: ModelConfig, dtype, device, *,
                           lead=()) -> Params:
    return {
        "ln1": init_rmsnorm(cfg.d_model, dtype, device, lead=lead),
        "attn": attn.init_attention(gen, cfg, dtype, device, lead=lead),
        "lnx": init_rmsnorm(cfg.d_model, dtype, device, lead=lead),
        "xattn": attn.init_attention(gen, cfg, dtype, device, lead=lead),
        "ln2": init_rmsnorm(cfg.d_model, dtype, device, lead=lead),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device,
                        lead=lead),
    }


_LAYER_INIT = {DENSE: _init_attn_layer, MOE: _init_moe_layer,
               SSM: _init_ssm_layer, HYBRID: _init_ssm_layer,
               VLM: _init_attn_layer, ENCDEC: _init_encdec_dec_layer}


def _hybrid_groups(cfg: ModelConfig) -> Tuple[int, int]:
    per = cfg.attn_every
    assert cfg.num_layers % per == 0, (cfg.num_layers, per)
    return cfg.num_layers // per, per


def _vlm_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """num_layers counts self+cross; each group = (per self) + 1 cross."""
    n_cross = cfg.num_layers // cfg.cross_attn_every
    n_self = cfg.num_layers - n_cross
    assert n_self % n_cross == 0, (n_self, n_cross)
    return n_cross, n_self // n_cross


def _layers_lead(cfg: ModelConfig) -> Tuple[int, ...]:
    """The leading axes of ``params["layers"]``."""
    if cfg.kind == HYBRID:
        return _hybrid_groups(cfg)
    if cfg.kind == VLM:
        return _vlm_groups(cfg)
    return (cfg.num_layers,)


def init_model(gen: Optional[torch.Generator], cfg: ModelConfig,
               dtype=torch.float32, device: DeviceLike = None) -> Params:
    """Random weights for ``cfg`` on ``device`` (the card by default),
    drawn from ``gen``, a generator on that device (seed 0 when None).
    A hybrid stack's SSM layers have leading axes (groups, per group) and
    its one shared attention layer none; a VLM's self-attention layers
    (groups, per group) and its cross layers one a group; an
    encoder-decoder's ``enc_layers`` one, with ``ln_enc`` after them."""
    cfg.validate()
    if cfg.kind not in _LAYER_INIT:
        raise ValueError(cfg.kind)
    device = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
    p: Params = {"embed": init_embedding(gen, cfg, dtype, device),
                 "ln_f": init_rmsnorm(cfg.d_model, dtype, device)}
    p["layers"] = _LAYER_INIT[cfg.kind](gen, cfg, dtype, device,
                                        lead=_layers_lead(cfg))
    if cfg.kind == HYBRID:
        p["shared_attn"] = _init_attn_layer(gen, cfg, dtype, device)
    elif cfg.kind == VLM:
        p["cross_layers"] = _init_cross_layer(
            gen, cfg, dtype, device, lead=(_vlm_groups(cfg)[0],))
    elif cfg.kind == ENCDEC:
        p["enc_layers"] = _init_attn_layer(
            gen, cfg, dtype, device, lead=(cfg.num_encoder_layers,))
        p["ln_enc"] = init_rmsnorm(cfg.d_model, dtype, device)
    return p


def layer_params(layers: Params, i: int) -> Params:
    """The params of layer ``i``: views into the stacked tensors."""
    return tree_map(lambda x: x[i], layers)


def unstack_layers(layers: Params):
    """The per-layer param dicts of a stacked tree, as views made by one
    ``unbind`` per tensor: autograd then stacks each gradient once, where
    indexing layer by layer would add a full-size zero tensor per layer.
    A leaf that is not a tensor (a layout's tensor-parallel marker) goes
    to every layer as it is."""
    parts = tree_map(lambda t: t.unbind(0) if isinstance(t, torch.Tensor)
                     else t, layers)
    n = next(len(p) for p in tree_leaves(parts) if isinstance(p, tuple))
    return [tree_map(lambda ts, i=i: ts[i] if isinstance(ts, tuple) else ts,
                     parts) for i in range(n)]


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


def _cross_layer_fwd(lp: Params, cfg: ModelConfig, x, kv_src):
    """A VLM cross layer: attention to the image tokens and an MLP, each
    scaled by ``tanh(gate)`` (computed in f32)."""
    g = torch.tanh(lp["gate"].float()).to(x.dtype)
    h = attn.cross_attention(lp["xattn"], cfg,
                             rmsnorm(lp["ln1"], x, cfg.norm_eps), kv_src)
    x = x + g * h
    x = x + g * mlp(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps))
    return x


def _vlm_group_fwd(gp: Params, cp: Params, cfg: ModelConfig, x, img, *,
                   window=0):
    """One VLM group: its self-attention layers, then its cross layer."""
    for lp in unstack_layers(gp):
        x = _attn_layer_fwd(lp, cfg, x, window=window)
    return _cross_layer_fwd(cp, cfg, x, img)


def _encdec_layer_fwd(lp: Params, cfg: ModelConfig, x, enc, *, window=0):
    """One decoder layer: causal self-attention, cross-attention to the
    encoder's output, MLP."""
    x = x + attn.attention(lp["attn"], cfg,
                           rmsnorm(lp["ln1"], x, cfg.norm_eps),
                           causal=True, window=window)
    x = x + attn.cross_attention(lp["xattn"], cfg,
                                 rmsnorm(lp["lnx"], x, cfg.norm_eps), enc)
    return x + mlp(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps))


def _layer_fwd(lp: Params, cfg: ModelConfig, x, *, window=0,
               shared: Optional[Params] = None,
               cross: Optional[Params] = None, src=None):
    """One layer of a dense, MoE, SSM or encoder-decoder stack, or one
    group of a hybrid stack with its ``shared`` attention layer or of a
    VLM stack with its ``cross`` layer; ``src`` is what cross-attention
    reads (the image tokens, the encoder's output).  Returns (x, the
    layer's aux loss or None)."""
    if cfg.kind == MOE:
        return _moe_layer_fwd(lp, cfg, x, window=window)
    if cfg.kind == SSM:
        return _ssm_layer_fwd(lp, cfg, x), None
    if cfg.kind == HYBRID:
        return _hybrid_group_fwd(lp, shared, cfg, x), None
    if cfg.kind == VLM:
        return _vlm_group_fwd(lp, cross, cfg, x, src, window=window), None
    if cfg.kind == ENCDEC:
        return _encdec_layer_fwd(lp, cfg, x, src, window=window), None
    return _attn_layer_fwd(lp, cfg, x, window=window), None


def _checkpointed(body, x, remat: bool):
    return checkpoint(body, x, use_reentrant=False) if remat else body(x)


def _whole(tree, *path):
    """The gather of one rank holding every weight whole: the identity."""
    return tree


def _embedding(params: Params, gather, name: str) -> Params:
    """The embedding's dict with its one weight ``name`` gathered."""
    return gather({name: params["embed"][name]}, "embed")


def _unembed(params: Params, gather, x):
    """The output projection (the tied embedding when there is no
    ``unembed``)."""
    name = "unembed" if "unembed" in params["embed"] else "tokens"
    return unembed(_embedding(params, gather, name), x)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            extra=None, *, remat: bool = False, return_hidden: bool = False,
            gather=None):
    """Returns (logits (B, S, padded_vocab), aux_loss scalar), plus the
    final hidden state when ``return_hidden``; under a layout that splits
    the vocabulary the logits are this model rank's slice, a
    ``layers.VocabShard``.

    ``extra`` holds ``image_embeds`` (B, num_image_tokens, d) for a VLM
    and ``frame_embeds`` (B, encoder_seq_len, d) for an encoder-decoder,
    cast to the activations' type.  remat=True checkpoints each layer
    (each group of a hybrid or VLM stack, as JAX does; activations
    recomputed in the backward pass), and each encoder layer.  An MoE
    stack sums each layer's aux loss, as JAX's scan carries it.

    ``gather(tree, *path)`` maps the params at ``path`` to what the
    compute reads (``train.parallel.Layout.gather`` over shards; the
    identity by default).  Each layer's runs inside its checkpointed
    body, so remat gathers again in the backward.  A layout's model
    axis splits the compute wherever the rules store a leaf split there
    (the vocabulary, heads, d_ff, experts, SSM heads; the dicts carry
    its marker and the code below reads it).  The JAX ``act_spec`` (a
    sequence-parallel constraint its dry-run sets and its launcher does
    not) has no counterpart.
    """
    if cfg.kind not in _LAYER_INIT:
        raise ValueError(cfg.kind)
    g = gather or _whole
    x = embed(_embedding(params, g, "tokens"), tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    src, cross = None, None
    if cfg.kind == VLM:
        assert extra is not None and "image_embeds" in extra, \
            "VLM needs image_embeds"
        src = extra["image_embeds"].to(x.dtype)
        cross = unstack_layers(params["cross_layers"])
    elif cfg.kind == ENCDEC:
        assert extra is not None and "frame_embeds" in extra, \
            "encdec needs frame_embeds"
        src = encode(params, cfg, extra["frame_embeds"].to(x.dtype),
                     remat=remat, gather=gather)
    for i, lp in enumerate(unstack_layers(params["layers"])):
        def body(x, lp=lp, cp=cross[i] if cross else None):
            shared = (g(params["shared_attn"], "shared_attn")
                      if "shared_attn" in params else None)
            return _layer_fwd(g(lp, "layers"), cfg, x,
                              window=cfg.sliding_window, shared=shared,
                              cross=None if cp is None
                              else g(cp, "cross_layers"), src=src)

        x, a = _checkpointed(body, x, remat)
        if a is not None:
            aux = aux + a
    x = rmsnorm(g(params["ln_f"], "ln_f"), x, cfg.norm_eps)
    if return_hidden:
        return _unembed(params, g, x), aux, x
    return _unembed(params, g, x), aux


def encode(params: Params, cfg: ModelConfig, frame_embeds: torch.Tensor, *,
           remat: bool = False, gather=None) -> torch.Tensor:
    """Whisper-style encoder over precomputed (stub-frontend) frames:
    bidirectional self-attention layers (``kops.flash_attention`` with
    ``causal=False``), then ``ln_enc``; ``gather`` as :func:`forward`'s
    (a model axis splits the encoder's heads and d_ff)."""
    g = gather or _whole
    x = frame_embeds
    for lp in unstack_layers(params["enc_layers"]):
        def body(x, lp=lp):
            return _attn_layer_fwd(g(lp, "enc_layers"), cfg, x,
                                   causal=False)

        x = _checkpointed(body, x, remat)
    return rmsnorm(g(params["ln_enc"], "ln_enc"), x, cfg.norm_eps)


# ===========================================================================
# Decode state
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


def _zero_cross(cfg: ModelConfig, n: int, B: int, S: int, dtype,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    shape = (n, B, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def init_decode_state(cfg: ModelConfig, B: int, cache_len: int,
                      dtype=torch.float32,
                      device: DeviceLike = None) -> DecodeState:
    """The decode cache of ``B`` rows.  Self-attention layers keep a KV
    ring of ``min(cache_len, sliding_window)`` slots when windowed, else
    ``cache_len``; SSM layers the f32 SSD state and the conv window; a
    hybrid stack one KV ring per application of the shared attention
    block, of ``min(cache_len, sliding_window or 4096)`` slots; VLM and
    encoder-decoder stacks zero cross K/V, one a cross layer, that
    :func:`precompute_cross_caches` fills."""
    device = resolve_device(device)
    w = cfg.sliding_window
    W = min(cache_len, w) if w else cache_len
    if cfg.kind in (DENSE, MOE):
        return DecodeState(kv=_stack_kv(cfg, (cfg.num_layers,), B, W, dtype,
                                        device))
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
    if cfg.kind == VLM:
        n_groups, per = _vlm_groups(cfg)
        return DecodeState(
            kv=_stack_kv(cfg, (n_groups, per), B, W, dtype, device),
            cross_kv=_zero_cross(cfg, n_groups, B, cfg.num_image_tokens,
                                 dtype, device))
    if cfg.kind == ENCDEC:
        L = cfg.num_layers
        return DecodeState(
            kv=_stack_kv(cfg, (L,), B, W, dtype, device),
            cross_kv=_zero_cross(cfg, L, B, cfg.encoder_seq_len, dtype,
                                 device))
    raise ValueError(cfg.kind)


def precompute_cross_caches(params: Params, cfg: ModelConfig, extra,
                            state: DecodeState) -> DecodeState:
    """Fill cross-attn K/V from image/frame embeddings (prefill-time): a
    VLM's from ``extra["image_embeds"]``, an encoder-decoder's from
    ``extra["encoder_out"]`` or else from encoding
    ``extra["frame_embeds"]``.  Other kinds: the state unchanged."""
    if cfg.kind == VLM:
        src, layers = extra["image_embeds"], params["cross_layers"]
    elif cfg.kind == ENCDEC:
        src = extra.get("encoder_out")
        if src is None:
            src = encode(params, cfg, extra["frame_embeds"])
        layers = params["layers"]
    else:
        return state
    ks, vs = zip(*(attn.precompute_cross_kv(lp["xattn"], src)
                   for lp in unstack_layers(layers)))
    return state._replace(cross_kv=(torch.stack(ks), torch.stack(vs)))


# ===========================================================================
# Decode step (one token)
# ===========================================================================
def _attn_decode_layer(lp, cfg, x, cache: KVCache, pos, window):
    h, cache = attn.decode_attention(
        lp["attn"], cfg, rmsnorm(lp["ln1"], x, cfg.norm_eps), cache, pos,
        window=window)
    x = x + h
    x = x + mlp(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps))
    return x, cache


def _moe_decode_layer(lp, cfg, x, cache: KVCache, pos, window):
    """Attention, then the exact top-k combine (``moe_decode_exact``), NOT
    capacity dispatch: decode outputs must not depend on batch
    composition (capacity drops do)."""
    h, cache = attn.decode_attention(
        lp["attn"], cfg, rmsnorm(lp["ln1"], x, cfg.norm_eps), cache, pos,
        window=window)
    x = x + h
    y = moe_mod.moe_decode_exact(lp["moe"], cfg,
                                 rmsnorm(lp["ln2"], x, cfg.norm_eps))
    return x + y, cache


def _cross_decode_layer(cp, cfg, x, ck, cv):
    g = torch.tanh(cp["gate"].float()).to(x.dtype)
    h = attn.cross_attention_cached(
        cp["xattn"], rmsnorm(cp["ln1"], x, cfg.norm_eps), ck, cv)
    x = x + g * h
    return x + g * mlp(cp["mlp"], rmsnorm(cp["ln2"], x, cfg.norm_eps))


def _encdec_decode_layer(lp, cfg, x, cache: KVCache, pos, window, ck, cv):
    h, cache = attn.decode_attention(
        lp["attn"], cfg, rmsnorm(lp["ln1"], x, cfg.norm_eps), cache, pos,
        window=window)
    x = x + h
    x = x + attn.cross_attention_cached(
        lp["xattn"], rmsnorm(lp["lnx"], x, cfg.norm_eps), ck, cv)
    return x + mlp(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps)), cache


def _ssm_decode_layer(lp, cfg, x, st: ssm_mod.SSMState):
    y, st = ssm_mod.mamba2_decode(
        lp["mixer"], cfg, rmsnorm(lp["ln1"], x, cfg.norm_eps), st)
    return x + y, st


def _stack_states(states, shape0) -> ssm_mod.SSMState:
    return ssm_mod.SSMState(
        *(torch.stack([getattr(st, f) for st in states]).reshape(
            shape0 + getattr(states[0], f).shape)
          for f in ssm_mod.SSMState._fields))


def _stack_caches(caches) -> KVCache:
    return KVCache(*(torch.stack(ts) for ts in zip(*caches)))


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                state: DecodeState, pos) -> Tuple[torch.Tensor, DecodeState]:
    """One token for every row: token (B, 1) -> (logits (B, 1, V), the new
    state).  ``pos`` holds each row's absolute position, (B,) (a scalar is
    taken for every row); the JAX function takes one scalar for the batch
    and the JAX state layout vmaps it over rows.  Attention reads the
    dense KV ring in plain products, as JAX's XLA path does; every MoE
    layer goes through ``moe_decode_exact`` (``kernels.ops.moe_decode``)
    and every SSM layer's state update through
    ``kernels.ops.ssm_state_update``.  Cross-attention reads the cached
    cross K/V.  Returns new state tensors; the input state is not
    written."""
    x = embed(params["embed"], token)  # (B, 1, d)
    pos = torch.as_tensor(pos, device=x.device).expand(x.shape[0])
    w = cfg.sliding_window
    if cfg.kind in (DENSE, MOE, ENCDEC):
        caches = []
        for i, lp in enumerate(unstack_layers(params["layers"])):
            kv = KVCache(*(t[i] for t in state.kv))
            if cfg.kind == ENCDEC:
                ck, cv = (t[i] for t in state.cross_kv)
                x, kv = _encdec_decode_layer(lp, cfg, x, kv, pos, w, ck, cv)
            elif cfg.kind == MOE:
                x, kv = _moe_decode_layer(lp, cfg, x, kv, pos, w)
            else:
                x, kv = _attn_decode_layer(lp, cfg, x, kv, pos, w)
            caches.append(kv)
        state = state._replace(kv=_stack_caches(caches))
    elif cfg.kind == VLM:
        groups = []
        for g, (gp, cp) in enumerate(zip(
                unstack_layers(params["layers"]),
                unstack_layers(params["cross_layers"]))):
            caches = []
            for j, lp in enumerate(unstack_layers(gp)):
                kv = KVCache(*(t[g, j] for t in state.kv))
                x, kv = _attn_decode_layer(lp, cfg, x, kv, pos, w)
                caches.append(kv)
            groups.append(_stack_caches(caches))
            x = _cross_decode_layer(cp, cfg, x, *(t[g] for t in
                                                  state.cross_kv))
        state = state._replace(kv=_stack_caches(groups))
    elif cfg.kind == SSM:
        new = []
        for i, lp in enumerate(unstack_layers(params["layers"])):
            st = ssm_mod.SSMState(state.ssm.ssm[i], state.ssm.conv[i])
            x, st = _ssm_decode_layer(lp, cfg, x, st)
            new.append(st)
        state = state._replace(ssm=_stack_states(new, (cfg.num_layers,)))
    elif cfg.kind == HYBRID:
        shared = params["shared_attn"]
        wh = w or 4096
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
            shared_kv=_stack_caches(kvs))
    else:
        raise ValueError(cfg.kind)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return unembed(params["embed"], x), state


# ===========================================================================
# Prefill: the prompt decoded into the cache (the static engine's)
# ===========================================================================
def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            state: DecodeState, extra=None
            ) -> Tuple[torch.Tensor, DecodeState]:
    """Decode the prompt ``tokens`` (B, S) into the cache a position at a
    time, as the JAX function scans ``decode_step`` over positions (every
    row at position t, left padding included).  With ``extra`` the cross
    caches are filled first.  Returns (the last position's logits
    (B, 1, V), the state)."""
    if extra is not None:
        state = precompute_cross_caches(params, cfg, extra, state)
    logits = None
    for t in range(tokens.shape[1]):
        logits, state = decode_step(params, cfg, tokens[:, t:t + 1], state, t)
    return logits, state
