"""flowlint Pass 2 — concurrency analysis over the channel topology.

The executor realizes a plan as threads blocked on channels and device
locks: Pipelined sides hand chunks over a per-run Channel, hybrid cycle
leaves double-buffer env chunks through a ring of channels, Async plans
gate a producer on an AsyncQueue's staleness bound, and workers
time-sharing devices serialize through DeviceLock priority ranks.  Each
of those is a place a configuration bug becomes a deadlock that only
manifests at fleet scale.

This pass builds a declarative :class:`ChannelTopology` from the plan
(:func:`build_topology` mirrors the wiring in ``core.pipeline``), then
checks it without running anything:

  * rings nobody primes (every member blocks on its first ``get``);
  * bounded-capacity cycles that cannot hold the in-flight items;
  * AsyncQueue configurations that can never admit a put;
  * DeviceLock priority ranks contradicting the data-dependency order;
  * lock-order inversions across workers acquiring multiple locks;
  * blocking ``get``s that a WorkerFailure cannot interrupt.

:class:`LockOrderRecorder` is the runtime half: armed (in tests) via
``repro_torch.core.channel.set_lock_observer``, it records every DeviceLock
wait/grant and validates the static model against what actually
interleaved.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.core.flowgraph import (
    DiGraph,
    FlowGraph,
    NoCycle,
    find_cycle,
    strongly_connected_components,
    topological_sort,
)
from repro_torch.core.scheduler import Async, Leaf, Pipelined, Temporal, leaves

PASS = "concurrency"


def _f(code: str, severity: str, subject: str, message: str,
       hint: str = "") -> Finding:
    return Finding(code, severity, subject, message, hint, PASS)


# ---------------------------------------------------------------------------
# Channel-topology IR
# ---------------------------------------------------------------------------
@dataclass
class ChannelDecl:
    """One channel as the analyzer sees it.  ``capacity`` follows
    ``core.channel.Channel`` semantics: 0 = unbounded.  ``primed`` is the
    number of items seeded before the consumer loop starts (the hybrid
    ring's chunk seeding).  ``closed_on_failure`` records whether every
    producer's failure path closes the channel (the property that makes a
    timeout-less ``get`` interruptible)."""
    name: str
    kind: str = "fifo"  # "fifo" | "async"
    capacity: int = 0
    primed: int = 0
    closed_on_failure: bool = True
    # async-queue fields (kind == "async")
    staleness_bound: int = 0
    # producer of item i waits until the consumer published version
    # >= i - gate_offset (AsyncPipelineDriver's staleness gate)
    gate_offset: int = 0
    stale_policy: str = "strict"


@dataclass
class PortDecl:
    """A worker endpoint on a channel.  ``timeout=None`` blocks forever."""
    worker: str
    channel: str
    kind: str  # "put" | "get"
    timeout: Optional[float] = None


@dataclass
class LockSite:
    """The ordered DeviceLock acquisitions of one worker."""
    worker: str
    locks: Tuple[str, ...]


@dataclass
class ChannelTopology:
    channels: Dict[str, ChannelDecl] = field(default_factory=dict)
    ports: List[PortDecl] = field(default_factory=list)
    # DeviceLock priority ranks (data-dependency order: producers lower)
    ranks: Dict[str, int] = field(default_factory=dict)
    lock_sites: List[LockSite] = field(default_factory=list)
    # worker -> device set, for "who shares devices" queries
    devices: Dict[str, Set[int]] = field(default_factory=dict)
    # channel edges (producer -> consumer) for rank checks
    edges: List[Tuple[str, str]] = field(default_factory=list)

    def add_channel(self, decl: ChannelDecl) -> ChannelDecl:
        self.channels[decl.name] = decl
        return decl

    def put(self, worker: str, channel: str,
            timeout: Optional[float] = None) -> None:
        self.ports.append(PortDecl(worker, channel, "put", timeout))

    def get(self, worker: str, channel: str,
            timeout: Optional[float] = None) -> None:
        self.ports.append(PortDecl(worker, channel, "get", timeout))


# ---------------------------------------------------------------------------
# Construction: plan -> topology (mirrors core.pipeline's wiring)
# ---------------------------------------------------------------------------
def build_topology(graph: Optional[FlowGraph], plan: Any,
                   cycle_specs: Optional[Dict[str, Any]] = None
                   ) -> ChannelTopology:
    topo = ChannelTopology()
    members: Dict[str, Tuple[str, ...]] = dict(
        getattr(plan, "members", None) or {})
    placement: Dict[str, List[int]] = dict(plan.placement or {})
    for w, devs in placement.items():
        topo.devices[w] = set(devs)
    specs = cycle_specs or {}

    # DeviceLock priority ranks follow the (condensed) graph's
    # topological order — producers acquire before consumers; cycle
    # members share their collapsed node's rank.
    if graph is not None:
        dag, g_members = graph.condense()
        for i, node in enumerate(topological_sort(dag.g)):
            for w in g_members.get(node, (node,)):
                topo.ranks[w] = i
        for a, b in graph.edges():
            topo.edges.append((a, b))

    counter = itertools.count()

    def expand(name: str) -> Tuple[str, ...]:
        return members.get(name, (name,))

    def side_workers(node) -> List[str]:
        out: List[str] = []
        for lf in leaves(node):
            out.extend(expand(lf.worker))
        return out

    def walk(node):
        if isinstance(node, Leaf):
            ms = members.get(node.worker, ())
            spec = specs.get(node.worker)
            if (node.cycle_mode == "hybrid" and len(ms) >= 2
                    and spec is not None):
                # hybrid double-buffer ring (pipeline._run_cycle_hybrid):
                # one channel per member, member j gets from ring[j] and
                # puts to ring[(j+1) % k]; the executor primes ring[0]
                # with one carry per env chunk before the loop starts,
                # and close_all() on any member failure unblocks getters.
                order = tuple(spec.order)
                k = len(order)
                chunks = max(getattr(node, "cycle_chunks", None)
                             or getattr(spec, "chunks", 2), 1)
                rings = [topo.add_channel(ChannelDecl(
                    f"ring:{node.worker}:{j}", capacity=0,
                    primed=chunks if j == 0 else 0,
                    closed_on_failure=True)) for j in range(k)]
                for j, m in enumerate(order):
                    topo.get(m, rings[j].name)
                    topo.put(m, rings[(j + 1) % k].name)
            return
        if isinstance(node, Temporal):
            # both sides time-share devices: one DeviceLock, acquired in
            # rank order — no channel between them (direct hand-off)
            lock = f"devlock:{next(counter)}"
            for w in side_workers(node.s) + side_workers(node.t):
                topo.lock_sites.append(LockSite(w, (lock,)))
        elif isinstance(node, Pipelined):
            # per-run hand-off channel (pipeline Pipelined branch):
            # producer thread closes it in `finally`, so the consumer's
            # timeout-less get is interruptible
            ch = topo.add_channel(ChannelDecl(
                f"pipe:{next(counter)}", capacity=0,
                closed_on_failure=True))
            for w in side_workers(node.s):
                topo.put(w, ch.name)
            for w in side_workers(node.t):
                topo.get(w, ch.name)
        elif isinstance(node, Async):
            depth = max(int(node.depth), 0)
            ch = topo.add_channel(ChannelDecl(
                f"async:{next(counter)}", kind="async",
                capacity=max(depth, 1), staleness_bound=depth,
                gate_offset=depth, closed_on_failure=True))
            for w in side_workers(node.s):
                topo.put(w, ch.name)
            for w in side_workers(node.t):
                topo.get(w, ch.name)
        walk(node.s)
        walk(node.t)

    walk(plan.schedule)
    return topo


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------
def check_topology(topo: ChannelTopology) -> List[Finding]:
    out: List[Finding] = []
    out.extend(_check_channel_cycles(topo))
    out.extend(_check_async_queues(topo))
    out.extend(_check_orphan_channels(topo))
    out.extend(_check_rank_order(topo))
    out.extend(_check_lock_order(topo))
    out.extend(_check_uninterruptible_gets(topo))
    return out


def _channel_graph(topo: ChannelTopology) -> DiGraph:
    """Bipartite digraph channel -> consumer -> produced channel."""
    g = DiGraph()
    for name in topo.channels:
        g.add_node(("ch", name))
    for p in topo.ports:
        if p.channel not in topo.channels:
            continue
        g.add_node(("w", p.worker))
        if p.kind == "get":
            g.add_edge(("ch", p.channel), ("w", p.worker))
        else:
            g.add_edge(("w", p.worker), ("ch", p.channel))
    return g


def _check_channel_cycles(topo: ChannelTopology) -> List[Finding]:
    out: List[Finding] = []
    g = _channel_graph(topo)
    for comp in strongly_connected_components(g):
        chans = [topo.channels[n[1]] for n in comp if n[0] == "ch"]
        workers = sorted(n[1] for n in comp if n[0] == "w")
        if not chans or not workers:
            continue
        label = "+".join(c.name for c in chans)
        primed = sum(c.primed for c in chans)
        # C101 — a ring nobody primes: every member's first action is a
        # blocking get on an empty channel; the loop never starts.
        if primed == 0:
            out.append(_f(
                "C101", "error", label,
                f"channel cycle through {workers} has no primed items — "
                f"every member blocks on its first get (startup "
                f"deadlock)",
                "seed the ring before starting the member loops (the "
                "hybrid executor primes ring[0] with one carry per env "
                "chunk)"))
            continue
        # C102 — bounded ring that cannot hold the in-flight items: once
        # the buffers and the members' hands are full, every put blocks
        # while every get upstream is starved.
        if all(c.capacity > 0 for c in chans):
            slots = sum(c.capacity for c in chans) + len(workers)
            if slots < primed:
                out.append(_f(
                    "C102", "error", label,
                    f"bounded cycle holds at most {slots} item(s) "
                    f"(capacities + one in hand per member) but "
                    f"{primed} are primed — the double-buffer ring "
                    f"deadlocks on put",
                    "make at least one ring channel unbounded "
                    "(capacity=0) or prime no more items than the "
                    "cycle can hold"))
    return out


def _check_async_queues(topo: ChannelTopology) -> List[Finding]:
    out: List[Finding] = []
    for c in topo.channels.values():
        if c.kind != "async":
            continue
        # C103 — configurations under which no put is ever admitted: the
        # producer livelocks before the first item reaches the trainer.
        if c.staleness_bound < 0:
            out.append(_f(
                "C103", "error", c.name,
                f"negative staleness bound {c.staleness_bound}",
                "K must be >= 0 (0 = fully synchronous)"))
        if c.capacity < 1:
            out.append(_f(
                "C103", "error", c.name,
                f"async queue capacity {c.capacity} < 1 — even the "
                f"K=0 hand-off needs one slot, so no put is ever "
                f"admitted",
                "capacity must be max(K, 1) (what AsyncQueue.put "
                "enforces)"))
        if c.gate_offset < 0:
            out.append(_f(
                "C103", "error", c.name,
                f"staleness gate offset {c.gate_offset} < 0: the "
                f"producer's first put waits for consumer version "
                f"{-c.gate_offset}, which the consumer can only reach "
                f"by consuming items that were never produced "
                f"(producer livelock)",
                "gate item i on wait_for_version(i - K) with K >= 0"))
        elif c.gate_offset > c.staleness_bound:
            out.append(_f(
                "C104", "warning", c.name,
                f"gate offset {c.gate_offset} exceeds the staleness "
                f"bound {c.staleness_bound}: the gate admits samples "
                f"the strict get then rejects (StalenessExceeded at "
                f"steady state)",
                "keep the producer gate at the queue's own bound K"))
    return out


def _check_orphan_channels(topo: ChannelTopology) -> List[Finding]:
    out: List[Finding] = []
    for c in topo.channels.values():
        getters = [p.worker for p in topo.ports
                   if p.channel == c.name and p.kind == "get"]
        putters = [p.worker for p in topo.ports
                   if p.channel == c.name and p.kind == "put"]
        if getters and not putters and c.primed == 0:
            # C105 — a getter on a channel nothing ever feeds: exactly
            # the orphaned-channel hang Channel.reset_all now closes.
            out.append(_f(
                "C105", "error", c.name,
                f"channel has consumer(s) {sorted(set(getters))} but no "
                f"producer and no primed items — gets block forever",
                "wire a producer or drop the consumer port"))
    return out


def _check_rank_order(topo: ChannelTopology) -> List[Finding]:
    out: List[Finding] = []
    if not topo.ranks:
        return out
    for src, dst in topo.edges:
        rs, rd = topo.ranks.get(src), topo.ranks.get(dst)
        if rs is None or rd is None or src == dst:
            continue
        shared = topo.devices.get(src, set()) & topo.devices.get(dst, set())
        if rs > rd and shared:
            # C106 — priority inversion on a shared-device edge: the
            # DeviceLock grants by rank, so the consumer would grab the
            # devices before its producer released them — the deadlock
            # the data-dependency ordering exists to rule out.
            out.append(_f(
                "C106", "error", f"{src}->{dst}",
                f"DeviceLock rank of producer {src!r} ({rs}) is higher "
                f"than consumer {dst!r} ({rd}) although they share "
                f"device(s) {sorted(shared)}",
                "derive lock priorities from the workflow graph's "
                "topological order (producers acquire first)"))
    return out


def _check_lock_order(topo: ChannelTopology) -> List[Finding]:
    """C107 — classic lock-order inversion: the union of every worker's
    acquisition sequence must be acyclic, or two workers holding one
    lock each can wait on the other's forever."""
    out: List[Finding] = []
    g = DiGraph()
    holders: Dict[Tuple[str, str], List[str]] = {}
    for site in topo.lock_sites:
        for a, b in zip(site.locks, site.locks[1:]):
            g.add_edge(a, b)
            holders.setdefault((a, b), []).append(site.worker)
    try:
        cyc = find_cycle(g)
    except NoCycle:
        return out
    locks = [a for a, _ in cyc]
    ws: Set[str] = set()
    for a, b in cyc:
        ws.update(holders.get((a, b), ()))
    out.append(_f(
        "C107", "error", "->".join(locks + [locks[0]]),
        f"lock-order inversion: workers {sorted(ws)} acquire "
        f"{sorted(set(locks))} in conflicting orders",
        "impose one global acquisition order (e.g. the schedule's "
        "stage order) on every worker touching multiple device locks"))
    return out


def _check_uninterruptible_gets(topo: ChannelTopology) -> List[Finding]:
    out: List[Finding] = []
    for p in topo.ports:
        if p.kind != "get" or p.timeout is not None:
            continue
        c = topo.channels.get(p.channel)
        if c is not None and not c.closed_on_failure:
            # C108 — a blocking get that WorkerFailure recovery cannot
            # interrupt: the producer's failure path never closes the
            # channel, so recovery's teardown joins a thread that is
            # parked forever.
            out.append(_f(
                "C108", "warning", f"{p.worker}@{p.channel}",
                f"timeout-less get on {p.channel!r}, whose producers do "
                f"not close it on failure — WorkerFailure recovery "
                f"cannot interrupt this thread",
                "close the channel in the producer's failure path "
                "(finally:) or give the get a timeout"))
    return out


# ---------------------------------------------------------------------------
# Runtime hygiene: LockOrderRecorder (armed in tests)
# ---------------------------------------------------------------------------
class LockOrderRecorder:
    """Records DeviceLock wait/grant events and validates Pass 2's model
    against the real interleaving.

    Arm it through :func:`repro_torch.core.channel.set_lock_observer`; every
    ``DeviceLock.acquire`` then reports when a worker starts waiting and
    when it is granted the lock.  :meth:`violations` replays the event
    log: a grant to worker ``w`` while a strictly lower-rank worker is
    still waiting on the same lock contradicts the data-dependency
    acquisition priority (exactly what Pass 2's C106 predicts
    statically)."""

    def __init__(self):
        self.events: List[Tuple[str, str, str, int]] = []
        import threading
        self._lock = threading.Lock()

    # -- observer interface (called by DeviceLock) -------------------------
    def record(self, kind: str, lock: str, worker: str,
               rank: int = 0) -> None:
        with self._lock:
            self.events.append((kind, lock, worker, rank))

    def clear(self) -> None:
        with self._lock:
            self.events = []

    # -- analysis ----------------------------------------------------------
    def grants(self, lock: Optional[str] = None) -> List[str]:
        """Workers in grant order (optionally for one lock)."""
        return [w for k, l, w, _ in self.events
                if k == "grant" and (lock is None or l == lock)]

    def violations(self, ranks: Optional[Dict[str, int]] = None
                   ) -> List[str]:
        """Grant events contradicting the priority model.  ``ranks``
        overrides the recorded ranks (pass the static model's ranks to
        validate the configuration against the graph order)."""
        out: List[str] = []
        waiting: Dict[str, Dict[str, int]] = {}
        for kind, lock, worker, rank in self.events:
            r = ranks.get(worker, rank) if ranks is not None else rank
            lw = waiting.setdefault(lock, {})
            if kind == "wait":
                lw[worker] = r
            elif kind == "leave":  # timed-out waiter withdrew
                lw.pop(worker, None)
            elif kind == "grant":
                lw.pop(worker, None)
                lower = [(w2, r2) for w2, r2 in lw.items() if r2 < r]
                if lower:
                    out.append(
                        f"{lock}: granted to {worker!r} (rank {r}) while "
                        f"lower-rank {sorted(lower)} still waiting")
        return out
