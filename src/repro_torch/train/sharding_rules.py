"""Parameter/batch sharding rules for the production meshes.

Counterpart of the JAX package's ``train/sharding_rules.py``, with its
rule table, keyed on the port's parameter paths (the same keys and
nesting as JAX's, see ``bridge.py``):
  * TP  ("model" axis): attention heads / d_ff / expert dim / vocab
  * FSDP ("data" axis): d_model-sized dims of every weight, ZeRO-sharding
    the optimizer moments too since they mirror param sharding.
  * batch over ("pod", "data") — pods are pure data-parallel replicas of
    the weight sharding, so only the gradient all-reduce crosses them.

Every rule goes through ``spec_for``, which drops any axis that does not
divide (24 heads on a 16-way axis -> replicated heads, d_ff still
sharded).  A spec is a ``PartitionSpec`` (``utils.sharding``); ``P()``
is replicated.
The launcher (``launch/train.py``) lays its params and moments out by
them (``train/parallel.py``); the dry-run (``launch/dryrun.py``) sizes
every layout the rules give.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.utils.sharding import (
    DATA,
    MODEL,
    P,
    Spec,
    batch_axes,
    maybe_axis,
    mesh_shape,
    spec_axes,
    spec_for,
)
from repro_torch.utils.treeutil import map_with_path, pytree_map

# (suffix, base_rank, axes) — first match wins, most specific first.
# base_rank is the unstacked rank; stacked leading layer dims get None.
_RULES: Sequence[Tuple[str, int, Tuple]] = (
    ("/embed/tokens", 2, (MODEL, DATA)),
    ("/embed/unembed", 2, (DATA, MODEL)),
    ("/attn/wq", 3, (DATA, MODEL, None)),
    ("/attn/wk", 3, (DATA, MODEL, None)),
    ("/attn/wv", 3, (DATA, MODEL, None)),
    ("/attn/wo", 3, (MODEL, None, DATA)),
    ("/xattn/wq", 3, (DATA, MODEL, None)),
    ("/xattn/wk", 3, (DATA, MODEL, None)),
    ("/xattn/wv", 3, (DATA, MODEL, None)),
    ("/xattn/wo", 3, (MODEL, None, DATA)),
    ("/mlp/gate", 2, (DATA, MODEL)),
    ("/mlp/up", 2, (DATA, MODEL)),
    ("/mlp/down", 2, (MODEL, DATA)),
    ("/shared/gate", 2, (DATA, MODEL)),
    ("/shared/up", 2, (DATA, MODEL)),
    ("/shared/down", 2, (MODEL, DATA)),
    ("/moe/router", 2, (DATA, None)),
    ("/mixer/in_proj", 2, (DATA, MODEL)),
    ("/mixer/out_proj", 2, (MODEL, DATA)),
    ("/mixer/conv_w", 2, (None, MODEL)),
    ("/mixer/conv_b", 1, (MODEL,)),
)

_MOE_EXPERT_RULES = {
    # when num_experts % model_axis == 0 -> expert parallelism
    "/moe/gate": ((MODEL, DATA, None), (None, DATA, MODEL)),
    "/moe/up": ((MODEL, DATA, None), (None, DATA, MODEL)),
    "/moe/down": ((MODEL, None, DATA), (None, MODEL, DATA)),
}


def _rule_axes(mesh: Any, cfg: ModelConfig, path: str,
               rank: int) -> Tuple:
    """The axes the rules ask for the leaf at ``path`` (before
    ``spec_for`` drops those that do not divide); () for a replicated
    leaf."""
    for suffix, base_rank, axes in _RULES:
        if path.endswith(suffix):
            return (None,) * (rank - base_rank) + tuple(axes)
    for suffix, (ep_axes, tp_axes) in _MOE_EXPERT_RULES.items():
        if path.endswith(suffix):
            assert cfg.moe is not None
            msize = mesh_shape(mesh).get(MODEL, 1)
            axes = ep_axes if cfg.moe.num_experts % msize == 0 else tp_axes
            return (None,) * (rank - 3) + tuple(axes)
    # biases, norms, A_log, D, gates ... -> replicated
    return ()


def _spec_for_leaf(mesh: Any, cfg: ModelConfig, path: str, leaf) -> Spec:
    shape = tuple(leaf.shape)
    axes = _rule_axes(mesh, cfg, path, len(shape))
    return spec_for(mesh, shape, axes) if axes else P()


def param_specs(mesh: Any, cfg: ModelConfig, params: Any) -> Any:
    """Spec tree mirroring ``params`` (tensors of any device, meta too)."""
    return map_with_path(
        lambda p, leaf: _spec_for_leaf(mesh, cfg, p, leaf), params)


def model_axis_misses(mesh: Any, cfg: ModelConfig, params: Any) -> List[str]:
    """The paths of the leaves whose compute the mesh's model axis cannot
    split: the rules put a dimension on "model" and the axis does not
    divide it (heads, d_ff, experts and d_ff both, the vocabulary), or a
    mixer's SSM heads do not divide.  A ``wk`` or ``wv`` kept whole
    beside a split ``wq`` is not one: each rank reads the KV heads its
    query heads map to."""
    msize = mesh_shape(mesh).get(MODEL, 1)
    if msize == 1:
        return []
    flat: dict = {}
    map_with_path(lambda p, x: flat.setdefault(p, x), params)

    def split(path: str) -> bool:
        shape = tuple(flat[path].shape)
        axes = _rule_axes(mesh, cfg, path, len(shape))
        return any(MODEL in a for a in spec_axes(spec_for(mesh, shape, axes)))

    out: List[str] = []
    for path, x in flat.items():
        if MODEL not in _rule_axes(mesh, cfg, path, len(x.shape)):
            continue
        if split(path):
            if (path.endswith("/mixer/out_proj")
                    and cfg.num_ssm_heads % msize):
                out.append(path)
        elif not (path.endswith(("/wk", "/wv"))
                  and split(path[:-2] + "wq")):
            out.append(path)
    return out


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------
def batch_spec(mesh: Any, batch_size: int) -> Spec:
    return P(maybe_axis(mesh, batch_size, batch_axes(mesh)))


def array_batch_specs(mesh: Any, tree: Any) -> Any:
    """Shard dim0 (batch) of every array in a batch tree."""

    def leaf(x):
        b = x.shape[0] if len(x.shape) else 1
        ax = maybe_axis(mesh, b, batch_axes(mesh))
        return P(ax, *(None,) * (len(x.shape) - 1))

    return pytree_map(leaf, tree)


def decode_state_specs(mesh: Any, cfg: ModelConfig, state: Any) -> Any:
    """KV/SSM cache specs: batch over ("pod","data"); "model" goes to
    kv-heads when divisible, otherwise to the cache *sequence* dim (W) —
    sequence-parallel decode attention instead of replicating a
    multi-GB cache.

    Cache layouts (see models.model):
      kv.k/v        (L..., B, W, KV, hd)
      kv.positions  (L..., B, W)
      ssm.ssm       (L..., B, H, P, N)
      ssm.conv      (L..., B, w-1, ch)
      cross k/v     (L, B, S_src, KV, hd)
    """
    bax = batch_axes(mesh)
    msize = mesh_shape(mesh).get(MODEL, 1)

    def kv_axes(shape):
        # (..., B, W, KV, hd): prefer heads on model, else W on model
        lead = len(shape) - 4
        B, W, KV, hd = shape[-4:]
        if KV % msize == 0:
            return (None,) * lead + (bax, None, MODEL, None)
        if W % msize == 0:
            return (None,) * lead + (bax, MODEL, None, None)
        return (None,) * lead + (bax, None, None, None)

    def leaf(path: str, x) -> Spec:
        shape = tuple(x.shape)
        rank = len(shape)
        if path.endswith("/positions"):
            # (..., B, W) — shard W on model iff k/v shard W
            lead = rank - 2
            W = shape[-1]
            seq = cfg.num_kv_heads % msize != 0 and W % msize == 0
            axes = (None,) * lead + (bax, MODEL if seq else None)
            return spec_for(mesh, shape, axes)
        if path.endswith("/k") or path.endswith("/v") or "cross_kv" in path:
            return spec_for(mesh, shape, kv_axes(shape))
        if path.endswith("/ssm"):
            axes = (None,) * (rank - 4) + (bax, MODEL, None, None)
            return spec_for(mesh, shape, axes)
        if path.endswith("/conv"):
            axes = (None,) * (rank - 3) + (bax, None, MODEL)
            return spec_for(mesh, shape, axes)
        return P()

    return map_with_path(leaf, state)
