"""Cluster + flexible device allocation (paper §4).

Ray only offers packed/spread placement; RLinf lets any worker claim any
device(s) by global ID.  We model the cluster as a flat list of global
device IDs (node i, local device j -> global id i*devices_per_node + j)
with explicit allocate/free and an occupancy map so temporal multiplexing
(two workers on the same device at different times) is expressible.

A copy of the JAX package's ``core/placement.py``; only its imports
differ.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple


@dataclass
class Cluster:
    num_nodes: int = 1
    devices_per_node: int = 8
    _allocations: Dict[str, List[int]] = field(default_factory=dict)
    # device id -> owner for devices held EXCLUSIVELY; persisted so later
    # allocations (exclusive or not) cannot land on them
    _exclusive: Dict[int, str] = field(default_factory=dict)
    _cursor: int = 0

    @property
    def num_devices(self) -> int:
        return self.num_nodes * self.devices_per_node

    def node_of(self, global_id: int) -> int:
        return global_id // self.devices_per_node

    # -- liveness -----------------------------------------------------------
    def device_alive(self, global_id: int) -> bool:
        """Whether a device can host new allocations.  The base cluster
        never loses devices; SimulatedCluster overrides this to model
        host failure (launch.cluster)."""
        return True

    def available_devices(self) -> List[int]:
        """Global IDs of live devices — the universe planning and
        allocation draw from after a failure shrinks the cluster."""
        return [i for i in range(self.num_devices) if self.device_alive(i)]

    # -- allocation ---------------------------------------------------------
    def allocate(self, owner: str, count: int,
                 *, device_ids: Optional[Sequence[int]] = None,
                 exclusive: bool = False) -> List[int]:
        """Allocate ``count`` devices; arbitrary global IDs may be pinned.

        Non-exclusive allocations may overlap each other (temporal
        multiplexing), but exclusivity is enforced in BOTH directions: an
        exclusive request rejects devices with any current occupant, and
        every request rejects devices already held exclusively.  Auto
        assignment (``device_ids=None``) skips ineligible devices instead
        of failing on them.
        """
        occ = self.occupancy()

        def _reject(i: int) -> Optional[str]:
            if not self.device_alive(i):
                return f"device {i} is on a failed host"
            if i in self._exclusive and self._exclusive[i] != owner:
                return (f"device {i} is exclusively held by "
                        f"'{self._exclusive[i]}'")
            if exclusive and occ.get(i):
                return (f"device {i} already occupied by "
                        f"{occ[i]} (exclusive requested)")
            return None

        if device_ids is not None:
            ids = list(device_ids)
            assert len(ids) == count
            for i in ids:
                msg = _reject(i)
                if msg:
                    raise ValueError(msg)
        else:
            ids = []
            for off in range(self.num_devices):
                i = (self._cursor + off) % self.num_devices
                if _reject(i) is None:
                    ids.append(i)
                    if len(ids) == count:
                        break
            if len(ids) < count:
                raise ValueError(
                    f"cannot allocate {count} device(s) for '{owner}': "
                    f"only {len(ids)} eligible")
            self._cursor = (ids[-1] + 1) % self.num_devices
        if exclusive:
            for i in ids:
                self._exclusive[i] = owner
        self._allocations.setdefault(owner, []).extend(ids)
        return ids

    def free(self, owner: str) -> None:
        self._allocations.pop(owner, None)
        self._exclusive = {i: o for i, o in self._exclusive.items()
                           if o != owner}

    def occupancy(self) -> Dict[int, List[str]]:
        occ: Dict[int, List[str]] = {}
        for owner, ids in self._allocations.items():
            for i in ids:
                occ.setdefault(i, []).append(owner)
        return occ

    def collocated(self, a: str, b: str) -> bool:
        da = set(self._allocations.get(a, ()))
        db = set(self._allocations.get(b, ()))
        return bool(da & db)


class PlacementManager:
    """Realizes an ExecutionPlan's placement on a Cluster (paper §4).

    The plan's placement column used to be advisory — workers kept the
    device slices hard-coded at construction.  This manager makes it
    binding: :meth:`apply` diffs the planned placement against the
    cluster's current allocations, frees owners whose slices changed (or
    who left the plan), allocates the planned slices, and rebinds each
    live worker via ``Worker.bind_devices`` (rebuilding its mesh and
    re-placing its state through the resharding data plane).

    Invariants:
      * idempotent — applying the same plan twice is a no-op;
      * no stale entries — after ``apply``, every managed owner's
        ``Cluster._allocations`` entry equals the plan's slice exactly;
        owners managed by a previous plan but absent from the new one
        are freed;
      * foreign owners (never placed by this manager and not named in
        the plan) are left untouched.
    """

    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        self._managed: Set[str] = set()

    def apply(self, plan, workers: Optional[Dict[str, object]] = None
              ) -> Dict[str, List[int]]:
        """Diff + rebind; returns {worker: new_devices} for every worker
        whose binding actually changed."""
        placement: Dict[str, List[int]] = dict(
            plan.placement if hasattr(plan, "placement") else plan)
        workers = workers or {}
        # Scope: everything this manager ever placed, plus the plan's
        # names (adopting same-named construction-time allocations).
        scope = self._managed | set(placement)
        for owner in list(self.cluster._allocations):
            if owner not in scope:
                continue
            cur = sorted(self.cluster._allocations.get(owner, []))
            if cur != sorted(placement.get(owner, [])):
                self.cluster.free(owner)
        changed: Dict[str, List[int]] = {}
        for name, devs in placement.items():
            if devs and name not in self.cluster._allocations:
                self.cluster.allocate(name, len(devs),
                                      device_ids=list(devs))
            w = workers.get(name)
            if w is not None and tuple(devs) != tuple(
                    getattr(w, "devices", ())):
                w.bind_devices(devs)
                changed[name] = list(devs)
        self._managed = {n for n, d in placement.items() if d}
        return changed

    def release_all(self) -> None:
        """Free every allocation this manager placed — the teardown half
        of failure recovery, guaranteeing no stale entries survive into
        the re-placement."""
        for owner in self._managed:
            self.cluster.free(owner)
        self._managed = set()


def split_devices(n_devices: int, shares: Sequence[int]) -> List[List[int]]:
    """Partition [0..n) into contiguous groups of the given sizes."""
    assert sum(shares) <= n_devices, (shares, n_devices)
    out, cur = [], 0
    for s in shares:
        out.append(list(range(cur, cur + s)))
        cur += s
    return out
