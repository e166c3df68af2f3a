"""Weight sync between workers: the data plane of the weight-update
barrier.

The trainer updates its params in place (``train.optimizer``), so a
weight sync that handed the rollout or inference worker the trainer's
own tensors would let the next train step change their weights under
them.  A sync therefore COPIES: each leaf of the trainer's tree into the
destination's own tensor of the same shape and type, then waits for the
device.  This module does that copy, plus the byte accounting the
profiler feeds to the scheduler (weight sync is part of the
context-switch cost).

Counterpart of the JAX package's ``comm/resharding.py``, whose sync is a
pytree ``device_put`` onto the destination's shardings (JAX arrays are
immutable, so it may pass references).  :func:`reshard` and
:func:`reshard_params` move a tree between layouts on a ``DeviceMesh``
(DTensor ``redistribute``: torch emits the collectives), the data plane
when trainer and rollout hold the weights laid out differently.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Tuple

import torch

from repro_torch.comm.primitives import leaf_nbytes
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.utils.sharding import NamedSharding, map_specs
from repro_torch.utils.treeutil import (
    pytree_flatten,
    pytree_map,
    pytree_unflatten,
)


def reshard(tree: Any, shardings: Any) -> Any:
    """Lay every leaf of ``tree`` out as its destination
    :class:`~repro_torch.utils.sharding.NamedSharding` says: a DTensor
    is redistributed, a plain tensor (the same full value on every rank)
    distributed from it."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    leaves, treedef = pytree_flatten(tree)
    dst = pytree_flatten(shardings)[0]
    if len(dst) != len(leaves):
        raise ValueError(f"{len(dst)} shardings for {len(leaves)} leaves")
    out = []
    for x, s in zip(leaves, dst):
        if isinstance(x, DTensor):
            out.append(x.redistribute(s.mesh, s.placements))
        else:
            out.append(distribute_tensor(x, s.mesh, s.placements))
    return pytree_unflatten(treedef, out)


def reshard_params(params: Any, mesh: Any, specs: Any) -> Any:
    """:func:`reshard` onto ``specs`` (a spec tree from
    ``train.sharding_rules``) on ``mesh``."""
    return reshard(params, map_specs(lambda sp: NamedSharding(mesh, sp),
                                     specs))


def transfer_stats(tree: Any) -> Dict[str, float]:
    """Bytes that a weight-sync of this tree moves (profiler input)."""
    leaves = [l for l in pytree_flatten(tree)[0] if leaf_nbytes(l)]
    return {"bytes": float(sum(leaf_nbytes(l) for l in leaves)),
            "arrays": float(len(leaves))}


def empty_like_tree(tree: Any, device: torch.device) -> Any:
    """Fresh tensors shaped like ``tree``'s tensor leaves on ``device``
    (other leaves as they are) — a sync destination that does not exist
    yet."""
    return pytree_map(
        lambda x: torch.empty(x.shape, dtype=x.dtype, device=device)
        if isinstance(x, torch.Tensor) else x, tree)


def timed_weight_sync(params: Any, dst: Any) -> Tuple[Any, float]:
    """Copy ``params`` into the tensors of ``dst`` and block, returning
    (dst, seconds) — the measured weight-update-barrier cost the
    scheduler charges between training and generation stages."""
    dl, sl = pytree_flatten(dst)[0], pytree_flatten(params)[0]
    if len(dl) != len(sl):
        raise ValueError(f"sync destination has {len(dl)} leaves, the "
                         f"source {len(sl)}")
    t0 = time.perf_counter()
    with torch.no_grad():
        for d, s in zip(dl, sl):
            if isinstance(s, torch.Tensor):
                d.copy_(s)
    for dev in {d.device for d in dl
                if isinstance(d, torch.Tensor) and d.is_cuda}:
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    tr = _trace.active()
    if tr is not None:
        stats = transfer_stats(params)
        tr.add("weight-sync", "sync", t0, t1, bytes=stats["bytes"],
               arrays=int(stats["arrays"]))
        reg = _metrics.active()
        if reg is not None:
            reg.counter("sync/count").inc()
            reg.counter("sync/bytes").inc(stats["bytes"])
            reg.histogram("sync/seconds").observe(t1 - t0)
    return dst, t1 - t0
