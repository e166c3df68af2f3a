"""Roofline terms of one dry-run case.

Counterpart of the JAX package's ``utils/roofline.py``:

    compute term    = FLOPs a device / peak FLOP/s
    memory term     = bytes a device / HBM bandwidth
    collective term = collective bytes a device / (links x link bandwidth)

JAX reads FLOPs, bytes and collectives from the compiled HLO
(``parse_collectives``); torch emits no HLO, so the port's dry-run
(``launch/dryrun.py``) counts them itself: FLOPs from ``model_flops``
(cross-checked with ``torch.utils.flop_counter`` over a meta forward),
bytes from the sharding rules, and collectives with
:func:`collective_bytes`, which derives each step's collectives from
the parameters' specs.  On the H100 the chip's ``ici_link_bandwidth`` is
the card's whole NVLink rate, so :meth:`RooflineReport.finalize` counts
one link by default.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from repro_torch.utils.hardware import DEFAULT_CHIP, ChipSpec
from repro_torch.utils.sharding import (
    DATA,
    POD,
    PartitionSpec,
    axis_size,
    map_specs,
    shard_shape,
    spec_axes,
)
from repro_torch.utils.treeutil import pytree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter")


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float  # per device
    hlo_bytes: float  # per device
    collective_bytes: float  # per device
    model_flops: float  # global 6ND
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    arg_bytes: int = 0
    temp_bytes: int = 0
    collective_counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    def finalize(self, chip: ChipSpec = DEFAULT_CHIP,
                 links_per_chip: int = 1) -> "RooflineReport":
        self.compute_s = self.hlo_flops / chip.peak_flops_bf16
        self.memory_s = self.hlo_bytes / chip.hbm_bandwidth
        self.collective_s = self.collective_bytes / (
            chip.ici_link_bandwidth * links_per_chip
        )
        return self

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (global counted FLOPs) — catches recompute and
        redundancy."""
        total_hlo = self.hlo_flops * self.chips
        return self.model_flops / total_hlo if total_hlo else 0.0

    def row(self) -> str:
        return (
            f"{self.arch:>24s} {self.shape:>12s} {self.mesh:>9s} "
            f"C={self.compute_s*1e3:9.3f}ms M={self.memory_s*1e3:9.3f}ms "
            f"X={self.collective_s*1e3:9.3f}ms dom={self.dominant:10s} "
            f"useful={self.useful_flops_ratio:6.3f}"
        )


def model_flops(cfg, shape) -> float:
    """6·N·D with N = active params, D = tokens processed per step."""
    n = cfg.active_param_count()
    d = shape.tokens_per_step
    mult = 3.0 if shape.phase == "train" else 1.0  # fwd+bwd = 3x fwd
    return 2.0 * n * d * mult


def collective_bytes(mesh: Any, params: Any, specs: Any, *,
                     train: bool) -> Dict[str, Dict[str, int]]:
    """Each step's collectives a device takes part in, from the weights'
    specs, as JAX counts them (the result size of each op):

      * a weight sharded over "data" (FSDP) is all-gathered over "data"
        before use: once in a forward, twice in a train step (the
        backward's recompute gathers it again);
      * in a train step each gradient is reduce-scattered over "data"
        where its weight is sharded there, else all-reduced over the
        data axes; pods then all-reduce their shard over "pod".

    Returns {"counts": {kind: ops}, "bytes": {kind: bytes}}.  The
    activations' tensor-parallel collectives over "model" are not
    counted (a count of them depends on the layer code, not the rules).
    """
    counts = {k: 0 for k in COLLECTIVES}
    nbytes = {k: 0 for k in COLLECTIVES}
    leaves = pytree_flatten(params)[0]
    flat_specs = []
    map_specs(flat_specs.append, specs)
    n_data = axis_size(mesh, DATA)
    n_pod = axis_size(mesh, POD)

    def add(kind: str, n: int, times: int = 1) -> None:
        counts[kind] += times
        nbytes[kind] += n * times

    for x, spec in zip(leaves, flat_specs):
        shard = 1
        for d in shard_shape(mesh, tuple(x.shape), spec):
            shard *= d
        shard *= x.element_size()
        fsdp = n_data > 1 and any(DATA in axes for axes in spec_axes(spec))
        if fsdp:
            add("all-gather", shard * n_data, 2 if train else 1)
        if not train:
            continue
        if fsdp:
            add("reduce-scatter", shard)
        elif n_data > 1:
            add("all-reduce", shard)
        if n_pod > 1:
            add("all-reduce", shard)
    return {"counts": counts, "bytes": nbytes}


def per_device_bytes(mesh: Any, tree: Any, specs: Any) -> int:
    """Bytes one device holds of ``tree`` laid out by ``specs``."""
    flat_specs = []
    map_specs(flat_specs.append, specs)
    total = 0
    for x, spec in zip(pytree_flatten(tree)[0], flat_specs):
        assert isinstance(spec, PartitionSpec), spec
        n = x.element_size()
        for d in shard_shape(mesh, tuple(x.shape), spec):
            n *= d
        total += n
    return total
