"""Sharding helpers: divisibility-aware axis assignment.

Counterpart of the JAX package's ``utils/sharding.py``.  The production
meshes are (data=16, model=16) and (pod=2, data=16, model=16).  Many
assigned architectures have dims that do not divide the 16-way model
axis (24 heads, 20 heads, 40 experts ...), so every sharding rule goes
through :func:`maybe_axis`, which falls back to replication when the
dim is not divisible.

A spec is a :class:`PartitionSpec`, as JAX's: a tuple with one entry a
dimension, each an axis name, a tuple of axis names or None (``P()`` is
fully replicated).  It is a tuple subclass of its own so that spec trees
can hold plain tuples of specs (``map_specs`` treats a spec as a leaf).
The spec functions read only a mesh's axis names and sizes, so they
take a :class:`LogicalMesh` (the dry-run's production meshes, which need
no devices) or a ``torch.distributed.device_mesh.DeviceMesh`` alike and
need no process group.  :func:`named` and :func:`replicated` give a
:class:`NamedSharding`, whose ``placements`` are a spec's DTensor
placements on a ``DeviceMesh``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

from repro_torch.utils.treeutil import pytree_flatten

AxisName = Union[str, Tuple[str, ...], None]


class PartitionSpec(tuple):
    """One entry a tensor dimension: an axis name, a tuple of axis names
    (sharded major to minor) or None."""

    def __new__(cls, *entries: AxisName) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = Spec = PartitionSpec

# Canonical axis names
POD = "pod"
DATA = "data"
MODEL = "model"


@dataclass(frozen=True)
class LogicalMesh:
    """Axis names and sizes without devices: what the sharding rules read
    of a mesh."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """{axis name: size} of a :class:`LogicalMesh` or a ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def axis_size(mesh: Any, axis: AxisName) -> int:
    shape = mesh_shape(mesh)
    if axis is None:
        return 1
    if isinstance(axis, str):
        return shape.get(axis, 1)
    n = 1
    for a in axis:
        n *= shape.get(a, 1)
    return n


def batch_axes(mesh: Any) -> AxisName:
    """Batch shards over ("pod","data") when the pod axis exists."""
    names = tuple(mesh_shape(mesh))
    if POD in names and DATA in names:
        return (POD, DATA)
    if DATA in names:
        return DATA
    return None


def maybe_axis(mesh: Any, dim: int, axis: AxisName) -> AxisName:
    """Return ``axis`` if ``dim`` divides its total size, else None.

    For tuple axes, tries progressively shorter prefixes, e.g. a batch of 8
    on (pod=2, data=16) keeps only what divides.
    """
    if axis is None:
        return None
    if isinstance(axis, tuple):
        for k in range(len(axis), 0, -1):
            cand = axis[:k]
            if dim % axis_size(mesh, cand) == 0:
                return cand if len(cand) > 1 else cand[0]
        return None
    return axis if dim % axis_size(mesh, axis) == 0 else None


def spec_for(mesh: Any, shape: Sequence[int],
             axes: Sequence[AxisName]) -> Spec:
    """A spec of ``axes``, dropping any axis that does not divide."""
    assert len(shape) == len(axes), (shape, axes)
    return P(*(maybe_axis(mesh, d, a) for d, a in zip(shape, axes)))


def spec_axes(spec: Spec) -> Tuple[Tuple[str, ...], ...]:
    """The mesh axes of each dimension of ``spec``, as tuples."""
    return tuple(() if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


def shard_shape(mesh: Any, shape: Sequence[int],
                spec: Spec) -> Tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` tensor laid out by
    ``spec`` (every named axis divides its dim, as :func:`spec_for`
    guarantees)."""
    dims = list(shape)
    for i, axes in enumerate(spec_axes(spec)):
        dims[i] //= axis_size(mesh, axes) if axes else 1
    return tuple(dims)


def placements(mesh: Any, spec: Spec):
    """DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(d)``
    on every mesh dimension that dimension ``d`` of the spec names (in
    the spec's order, so a tuple axis shards major to minor), else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec_axes(spec)):
        for a in axes:
            if a in names:
                out[names.index(a)] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh``: the destination of :func:`reshard`."""
    mesh: Any
    spec: Spec

    @property
    def placements(self):
        return placements(self.mesh, self.spec)


def named(mesh: Any, shape: Sequence[int],
          axes: Sequence[AxisName]) -> NamedSharding:
    return NamedSharding(mesh, spec_for(mesh, shape, axes))


def replicated(mesh: Any) -> NamedSharding:
    """Fully-replicated sharding on ``mesh``."""
    return NamedSharding(mesh, P())


def map_specs(fn, tree: Any) -> Any:
    """``fn`` over the specs of a spec tree (dicts, lists, tuples and
    NamedTuples of :class:`PartitionSpec`), the containers rebuilt."""
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v) for v in tree)
    return fn(tree)


_ACTIVE_MESH: list = [None]


def set_active_mesh(mesh: Optional[Any]) -> None:
    """Register the mesh a launcher runs under (the launcher sets it and
    clears it on the way out; unit tests leave it unset)."""
    _ACTIVE_MESH[0] = mesh


def get_active_mesh() -> Optional[Any]:
    return _ACTIVE_MESH[0]


def bytes_of(tree: Any) -> int:
    """Bytes of every tensor leaf (meta tensors included)."""
    return sum(int(x.numel()) * x.element_size()
               for x in pytree_flatten(tree)[0]
               if hasattr(x, "numel") and hasattr(x, "element_size"))
