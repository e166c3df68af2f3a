"""Mesh construction.

Counterpart of the JAX package's ``launch/mesh.py``.  Functions, not
module-level constants: importing this module touches no device and no
process group.

  * :func:`make_production_mesh` — the (data=16, model=16) and (pod=2,
    data=16, model=16) meshes as :class:`LogicalMesh` es: axis names and
    sizes for the sharding rules and the dry-run, no devices;
  * :func:`make_local_mesh` — a ``DeviceMesh`` ("data", "model"), or
    ("pod", "data", "model") with a pod axis, over the process group's
    ranks when one is initialized (its size must be the product of the
    axes), else the logical mesh of one process;
  * :func:`mesh_for_devices` — the local devices backing a cluster
    device slice, the mesh a worker rebuilds when a plan rebinds it.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.utils.sharding import LogicalMesh


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    if multi_pod:
        return LogicalMesh(("pod", "data", "model"), (2, 16, 16))
    return LogicalMesh(("data", "model"), (16, 16))


def make_local_mesh(model: int = 1, data: int = 1,
                    device_type: Optional[str] = None, *,
                    pod: Optional[int] = None):
    """A (data, model) ``DeviceMesh`` over the process group, (pod, data,
    model) when ``pod`` is given (ranks pod-major, as JAX lays out its
    multi-pod mesh), or the logical mesh of those axes when no process
    group is up (one process: the axes' product must then be 1).
    ``device_type`` defaults to the process group's backend's: "cuda"
    under nccl, else "cpu"."""
    import torch.distributed as dist

    names: Tuple[str, ...] = ("data", "model")
    sizes: Tuple[int, ...] = (data, model)
    if pod is not None:
        names, sizes = ("pod",) + names, (pod,) + sizes
    n = 1
    for s in sizes:
        n *= s
    if not (dist.is_available() and dist.is_initialized()):
        assert n == 1, (dict(zip(names, sizes)), "no process group")
        return LogicalMesh(names, sizes)
    assert n == dist.get_world_size(), (dict(zip(names, sizes)),
                                        dist.get_world_size())
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, sizes, mesh_dim_names=names)


def mesh_for_devices(global_ids: Sequence[int], *,
                     device: DeviceLike = None
                     ) -> Optional[Tuple[torch.device, ...]]:
    """The distinct local devices backing the cluster device slice
    ``global_ids``, in slice order; None for an empty slice.

    Global cluster ids fold onto the local cards round-robin
    (``id % torch.cuda.device_count()``): at scale the slice maps 1:1
    onto real cards; on one card every id lands on it.  ``device`` names
    the platform (the card by default); a caller that asks for the CPU
    (or the meta device) gets that one device whatever the ids."""
    if not global_ids:
        return None
    base = resolve_device(device)
    if base.type != "cuda":
        return (base,)
    count = torch.cuda.device_count()
    picked = []
    for g in global_ids:
        d = torch.device("cuda", int(g) % count)
        if d not in picked:
            picked.append(d)
    return tuple(picked)
