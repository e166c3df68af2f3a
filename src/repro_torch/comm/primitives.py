"""Adaptive communication layer (paper §3.5), single-host adaptation.

The paper's workers are Ray processes picking NCCL / cudaIPC / Gloo per
placement.  Here workers are threads of one process driving torch
devices; the same *protocol* survives:

  * transparent connection lifecycle — a global :class:`Router` registers
    every worker at launch; point-to-point links are created lazily on
    first send and torn down on worker termination;
  * placement-aware backend choice — payload tensors travel as zero-copy
    references when src/dst share their devices, and as host copies when
    they live on different ones;
  * structure-aware payloads — arbitrary trees (dicts, lists, tuples,
    NamedTuples) are flattened; tensor leaves are moved buffer-by-buffer
    with the treedef piggybacked as metadata (never pickled).

Counterpart of the JAX package's ``comm/primitives.py``: the tree walk is
the port's own (``utils.treeutil``), and a host transfer copies tensors
to the CPU where the JAX package takes its arrays to numpy.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.utils.treeutil import pytree_flatten, pytree_unflatten


def leaf_nbytes(leaf: Any) -> int:
    """Bytes of one tensor or numpy leaf; 0 for anything else."""
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    if hasattr(leaf, "nbytes"):
        return int(leaf.nbytes)
    return 0


@dataclass
class Payload:
    """Structure-aware message: leaves + treedef travel separately."""

    treedef: Any
    leaves: List[Any]
    meta: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def pack(cls, obj: Any, **meta) -> "Payload":
        leaves, treedef = pytree_flatten(obj)
        return cls(treedef=treedef, leaves=leaves, meta=meta)

    def unpack(self) -> Any:
        return pytree_unflatten(self.treedef, self.leaves)

    def nbytes(self) -> int:
        return sum(leaf_nbytes(l) for l in self.leaves)


class Connection:
    """A lazily-created point-to-point link (one queue per direction)."""

    def __init__(self, a: str, b: str):
        self.key = (a, b)
        self.q: "queue.Queue[Payload]" = queue.Queue()
        self.bytes_sent = 0
        self.messages = 0


class Router:
    """Global worker/connection manager (paper: worker manager + connection
    manager).  Thread-safe; one per Controller."""

    def __init__(self):
        self._workers: Dict[str, Dict[str, Any]] = {}
        self._conns: Dict[Tuple[str, str], Connection] = {}
        self._lock = threading.Lock()

    # -- registration (protocol level) ---------------------------------
    def register(self, name: str, *, devices: Optional[List[int]] = None,
                 host: str = "local") -> None:
        with self._lock:
            self._workers[name] = {
                "devices": devices or [], "host": host,
                "registered_at": time.time(),
            }

    def deregister(self, name: str) -> None:
        with self._lock:
            self._workers.pop(name, None)
            for key in [k for k in self._conns if name in k]:
                del self._conns[key]  # notify + teardown

    def placement(self, name: str) -> Optional[Dict[str, Any]]:
        return self._workers.get(name)

    def _conn(self, src: str, dst: str) -> Connection:
        with self._lock:
            key = (src, dst)
            if key not in self._conns:
                self._conns[key] = Connection(src, dst)
            return self._conns[key]

    # -- primitives ------------------------------------------------------
    def _needs_transfer(self, src: str, dst: str) -> bool:
        src_info, dst_info = self.placement(src), self.placement(dst)
        return bool(
            src_info and dst_info
            and src_info["devices"] and dst_info["devices"]
            and src_info["devices"] != dst_info["devices"]
        )

    @staticmethod
    def _host_leaves(leaves: List[Any]) -> List[Any]:
        """Copy tensor leaves to the host (the NCCL/cudaIPC analogue): a
        copy even of a CPU tensor, so the receiver never aliases the
        sender's buffer."""
        return [l.detach().to("cpu", copy=True)
                if isinstance(l, torch.Tensor) else l for l in leaves]

    def _dispatch(self, src: str, dst: str, payload: Payload) -> None:
        conn = self._conn(src, dst)
        conn.q.put(payload)
        conn.bytes_sent += payload.nbytes()
        conn.messages += 1

    def send(self, src: str, dst: str, obj: Any, *, async_op: bool = True):
        """Backend selection happens here: same-device payloads pass by
        reference; cross-device tensors travel as host copies."""
        payload = Payload.pack(obj, src=src, dst=dst)
        if self._needs_transfer(src, dst):
            payload.leaves = self._host_leaves(payload.leaves)
            payload.meta["backend"] = "device_transfer"
        else:
            payload.meta["backend"] = "zero_copy"
        self._dispatch(src, dst, payload)
        return None

    def recv(self, dst: str, src: str, *, timeout: Optional[float] = None) -> Any:
        conn = self._conn(src, dst)
        payload = conn.q.get(timeout=timeout)
        return payload.unpack()

    def broadcast(self, src: str, dsts: List[str], obj: Any) -> None:
        """One-to-many send that flattens the tree ONCE and shares the
        leaf buffers across destinations (leaves are read-only in transit,
        so structural sharing is safe); the host copy for cross-device
        destinations is also made at most once."""
        packed = Payload.pack(obj, src=src)
        host_leaves: Optional[List[Any]] = None  # lazily built, shared
        for d in dsts:
            if self._needs_transfer(src, d):
                if host_leaves is None:
                    host_leaves = self._host_leaves(packed.leaves)
                leaves, backend = host_leaves, "device_transfer"
            else:
                leaves, backend = packed.leaves, "zero_copy"
            self._dispatch(src, d, Payload(
                treedef=packed.treedef, leaves=leaves,
                meta={"src": src, "dst": d, "backend": backend,
                      "broadcast": True}))

    # -- stats -----------------------------------------------------------
    def stats(self) -> Dict[str, Dict[str, int]]:
        return {
            f"{a}->{b}": {"bytes": c.bytes_sent, "messages": c.messages}
            for (a, b), c in self._conns.items()
        }


_GLOBAL_ROUTER: Optional[Router] = None


def global_router() -> Router:
    global _GLOBAL_ROUTER
    if _GLOBAL_ROUTER is None:
        _GLOBAL_ROUTER = Router()
    return _GLOBAL_ROUTER


def reset_router() -> None:
    global _GLOBAL_ROUTER
    _GLOBAL_ROUTER = None
