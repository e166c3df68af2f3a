"""Simulated multi-host launch path (paper §4 scale-out).

Counterpart of the JAX package's ``launch/cluster.py``: N hosts x M
devices behind the ``Cluster`` abstraction, so every plan -> place ->
execute path runs against more than one host without real machines:

  * :class:`SimulatedCluster` — a ``Cluster`` whose devices belong to
    named hosts; hosts can *fail* (their devices drop out of
    ``available_devices`` and new allocations reject them) and be
    *restored*, which is what the fault-injection harness
    (``core.faults``) drives;
  * :func:`cluster_from_env` — topology from ``REPRO_DRYRUN_HOSTS`` /
    ``REPRO_DRYRUN_DEVICES``, so tests and benchmarks can parametrize
    shape instead of hardcoding one.

Global device IDs stay flat (host h, local device j -> ``h*M + j``), so
schedules, placements, and worker meshes are oblivious to host
boundaries; only liveness carries host identity.  The JAX package's
``maybe_init_jax_distributed`` has no counterpart yet: its port is the
``torch.distributed`` start of the multi-device work (ROADMAP.md queue
1, item 12).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Set

from repro_torch.core.placement import Cluster


@dataclass
class SimulatedCluster(Cluster):
    """A ``Cluster`` whose nodes are named hosts with a liveness bit.

    ``num_nodes``/``devices_per_node`` keep their base meaning; a failed
    host's devices stay visible in ``num_devices`` (global IDs must not
    shift under running placements) but disappear from
    ``available_devices`` and are rejected by ``allocate``.
    """
    _dead_hosts: Set[int] = field(default_factory=set)

    # -- host identity ------------------------------------------------------
    @property
    def num_hosts(self) -> int:
        return self.num_nodes

    def host_name(self, host: int) -> str:
        return f"host{host}"

    def host_of(self, global_id: int) -> str:
        return self.host_name(self.node_of(global_id))

    def host_devices(self, host: int) -> List[int]:
        lo = host * self.devices_per_node
        return list(range(lo, lo + self.devices_per_node))

    # -- liveness -----------------------------------------------------------
    def device_alive(self, global_id: int) -> bool:
        return self.node_of(global_id) not in self._dead_hosts

    def alive_hosts(self) -> List[int]:
        return [h for h in range(self.num_nodes) if h not in self._dead_hosts]

    def fail_host(self, host: int) -> List[int]:
        """Mark a host dead; returns the owners whose allocations touched
        it.  Their ``Cluster`` entries are NOT freed here — detection and
        re-placement are the recovery path's job (runner.recover), and a
        half-freed cluster would hide exactly the stale-allocation bugs
        the fault tests exist to catch."""
        assert 0 <= host < self.num_nodes, host
        self._dead_hosts.add(host)
        dead = set(self.host_devices(host))
        return sorted(owner for owner, ids in self._allocations.items()
                      if dead & set(ids))

    def restore_host(self, host: int) -> None:
        self._dead_hosts.discard(host)


def cluster_from_env(default_hosts: int = 1,
                     default_devices: int = 8,
                     *, hosts: Optional[int] = None,
                     devices_per_host: Optional[int] = None
                     ) -> SimulatedCluster:
    """Build a SimulatedCluster from the dry-run topology knobs.

    Explicit arguments win over ``REPRO_DRYRUN_HOSTS`` /
    ``REPRO_DRYRUN_DEVICES``, which win over the defaults.
    """
    n = hosts if hosts is not None else int(
        os.environ.get("REPRO_DRYRUN_HOSTS", default_hosts))
    m = devices_per_host if devices_per_host is not None else int(
        os.environ.get("REPRO_DRYRUN_DEVICES", default_devices))
    assert n >= 1 and m >= 1, (n, m)
    return SimulatedCluster(num_nodes=n, devices_per_node=m)
