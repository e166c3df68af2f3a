"""Load-balancing data channel + distributed device lock (paper §3.3/§3.5).

The channel decouples producer/consumer control flow (the foundation of
elastic pipelining) and carries the *device lock* that realizes automatic
context switching: workers sharing devices acquire the lock before using
them; acquisition priority follows the channel's data-dependency order
(producers before consumers), which rules out deadlock; onload/offload
hooks run automatically around acquisition.

A copy of the JAX package's ``core/channel.py``; only its imports
differ.
"""
from __future__ import annotations

import heapq
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace


def _chan_family(name: str) -> str:
    """Metric key for a channel: anonymous per-run channels (pipe-…,
    cycle-…) collapse onto their family so the registry stays bounded."""
    head = name.split("-", 1)[0]
    return head if head in ("pipe", "cycle") else name


def _record_block(kind: str, name: str, t0: float, t1: float,
                  depth: int) -> None:
    """One blocked put/get: span (cat=channel-wait, feeds the report's
    gap attribution) + block-seconds counter + depth gauge."""
    tr = _trace.active()
    if tr is None:
        return
    tr.add(f"{kind}-wait", "channel-wait", t0, t1, channel=name)
    reg = _metrics.active()
    if reg is not None:
        fam = _chan_family(name)
        reg.counter(f"channel/{fam}/{kind}_block_s").inc(t1 - t0)
        reg.histogram(f"channel/{fam}/{kind}_block_s_hist").observe(t1 - t0)
        reg.gauge(f"channel/{fam}/depth").set(depth)


@dataclass(order=True)
class _Item:
    sort_key: float
    seq: int
    data: Any = field(compare=False)
    weight: float = field(default=1.0, compare=False)


class ChannelClosed(Exception):
    pass


class Channel:
    """FIFO queue with per-item weights and pluggable load balancing.

    * ``put(data, weight=...)`` — weight drives consumer balancing.
    * ``get()`` — default FIFO; a consumer with a custom policy
      (``policy(items) -> index``) picks among queued items.
    * ``get_batch(min_items / min_weight)`` — granularity coalescing used
      by the Execution Flow Manager (elastic pipelining).
    * ``device_lock`` — see :class:`DeviceLock`.
    """

    _registry: Dict[str, "Channel"] = {}

    def __init__(self, name: str, *, capacity: int = 0,
                 offload_to_host: bool = False):
        self.name = name
        self.capacity = capacity
        self.offload_to_host = offload_to_host
        self._q: List[_Item] = []
        self._seq = 0
        self._closed = False
        self._cv = threading.Condition()
        self.device_lock = DeviceLock(f"lock[{name}]")
        # consumer-side accounting for weighted balancing
        self._consumer_load: Dict[str, float] = {}
        self.total_put = 0
        self.total_get = 0

    # -- creation ---------------------------------------------------------
    @classmethod
    def create(cls, name: str, **kw) -> "Channel":
        ch = cls(name, **kw)
        cls._registry[name] = ch
        return ch

    @classmethod
    def get_channel(cls, name: str) -> "Channel":
        return cls._registry[name]

    @classmethod
    def reset_all(cls) -> None:
        """Close every live channel, then drop the registry.  Closing
        first wakes any getter still blocked on an orphaned channel
        (ChannelClosed) — merely clearing the registry would leave it
        parked forever with nothing able to reach the channel again."""
        for ch in cls._registry.values():
            ch.close()
        cls._registry.clear()

    # -- producer ----------------------------------------------------------
    def put(self, data: Any, weight: float = 1.0) -> None:
        with self._cv:
            if self._closed:
                raise ChannelClosed(self.name)
            if self.capacity and len(self._q) >= self.capacity:
                # back-pressure path: time the wait only when we block
                tr = _trace.active()
                t0 = tr.clock() if tr is not None else 0.0
                while self.capacity and len(self._q) >= self.capacity:
                    self._cv.wait()
                if tr is not None:
                    _record_block("put", self.name, t0, tr.clock(),
                                  len(self._q))
            item = _Item(sort_key=self._seq, seq=self._seq, data=data,
                         weight=weight)
            self._seq += 1
            heapq.heappush(self._q, item)
            self.total_put += 1
            self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    # -- consumer ----------------------------------------------------------
    def get(self, *, consumer: str = "default",
            policy: Optional[Callable[[List[Any]], int]] = None,
            timeout: Optional[float] = None) -> Any:
        deadline = time.time() + timeout if timeout else None
        with self._cv:
            if not self._q:
                tr = _trace.active()
                t0 = tr.clock() if tr is not None else 0.0
                try:
                    while not self._q:
                        if self._closed:
                            raise ChannelClosed(self.name)
                        remaining = ((deadline - time.time())
                                     if deadline else None)
                        if remaining is not None and remaining <= 0:
                            raise queue.Empty()
                        self._cv.wait(timeout=remaining)
                finally:
                    # starvation on a closed/empty channel is still wait
                    # time the consumer paid — record it either way
                    if tr is not None:
                        _record_block("get", self.name, t0, tr.clock(),
                                      len(self._q))
            if policy is not None:
                datas = [it.data for it in sorted(self._q)]
                idx = policy(datas)
                chosen = sorted(self._q)[idx]
                self._q.remove(chosen)
                heapq.heapify(self._q)
            else:
                chosen = heapq.heappop(self._q)
            self.total_get += 1
            self._consumer_load[consumer] = (
                self._consumer_load.get(consumer, 0.0) + chosen.weight)
            self._cv.notify_all()
            return chosen.data

    def get_batch(self, *, min_items: int = 1,
                  consumer: str = "default",
                  timeout: Optional[float] = None) -> List[Any]:
        """Coalesce ``min_items`` items (blocking) — granularity control."""
        out = [self.get(consumer=consumer, timeout=timeout)]
        while len(out) < min_items:
            try:
                out.append(self.get(consumer=consumer, timeout=timeout))
            except ChannelClosed:
                break
        return out

    def balanced_consumer(self) -> str:
        """Least-loaded consumer so far (weighted load balancing)."""
        if not self._consumer_load:
            return "default"
        return min(self._consumer_load, key=self._consumer_load.get)

    def qsize(self) -> int:
        with self._cv:
            return len(self._q)

    @property
    def closed(self) -> bool:
        return self._closed


@dataclass
class VersionedItem:
    """Payload tagged with the producer's parameter version (off-policy
    asynchrony, §3.3 extension): staleness of a sample at consumption time
    is ``consumer_version - version``."""
    data: Any
    version: int
    seq: int


class StalenessExceeded(Exception):
    """A sample older than the staleness bound reached a strict consumer."""


class AsyncQueue:
    """Bounded, weight-versioned channel for cross-iteration pipelining.

    The queue realizes *bounded-staleness asynchrony* between a producer
    stage (generation, running with parameters at version ``v``) and a
    consumer stage (training, advancing the parameters to ``v+1, v+2, …``):

    * every ``put`` tags the payload with the producer's current parameter
      version; versions must be monotone non-decreasing;
    * capacity equals the staleness bound ``K`` (in flight ≤ K batches), so
      a producer that syncs weights after each put can never fall more than
      K versions behind the trainer — the producer *blocks* instead of
      racing ahead;
    * the consumer side tracks its own parameter version
      (:meth:`advance_consumer`); a ``get`` returning a sample with
      ``staleness > K`` either raises (``stale_policy='strict'``) or drops
      the sample and returns the next one (``stale_policy='drop'``).

    ``K = 0`` degenerates to fully synchronous on-policy execution: the
    producer blocks until the consumer has drained and caught up, and every
    consumed sample has staleness 0.
    """

    def __init__(self, name: str, *, staleness_bound: int = 1,
                 stale_policy: str = "strict"):
        assert staleness_bound >= 0, staleness_bound
        assert stale_policy in ("strict", "drop"), stale_policy
        self.name = name
        self.staleness_bound = staleness_bound
        self.stale_policy = stale_policy
        self._q: List[VersionedItem] = []
        self._seq = 0
        self._closed = False
        self._cv = threading.Condition()
        self._producer_version = -1
        self._consumer_version = 0
        self.total_put = 0
        self.total_get = 0
        self.dropped_stale = 0
        self.max_observed_staleness = 0

    # -- producer ----------------------------------------------------------
    def put(self, data: Any, version: int,
            timeout: Optional[float] = None) -> None:
        deadline = time.time() + timeout if timeout is not None else None
        with self._cv:
            if self._closed:
                raise ChannelClosed(self.name)
            if version < self._producer_version:
                raise ValueError(
                    f"{self.name}: version tags must be monotone "
                    f"({version} < {self._producer_version})")
            # back-pressure: block while accepting this item could let the
            # consumer observe staleness > K.  The in-flight count bounds
            # how far the trainer can advance before this sample is used:
            # capacity = max(K, 1) items (K=0 still needs one slot to hand
            # the sync batch over, freshness is enforced on the get side).
            cap = max(self.staleness_bound, 1)
            while len(self._q) >= cap and not self._closed:
                remaining = (deadline - time.time()) if deadline else None
                if remaining is not None and remaining <= 0:
                    raise queue.Full()
                self._cv.wait(timeout=remaining)
            if self._closed:
                raise ChannelClosed(self.name)
            self._q.append(VersionedItem(data=data, version=version,
                                         seq=self._seq))
            self._seq += 1
            self._producer_version = version
            self.total_put += 1
            self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    # -- consumer ----------------------------------------------------------
    def advance_consumer(self, version: int) -> None:
        """The trainer publishes its new parameter version after an update."""
        with self._cv:
            assert version >= self._consumer_version, (
                version, self._consumer_version)
            self._consumer_version = version
            self._cv.notify_all()

    def wait_for_version(self, min_version: int,
                         timeout: Optional[float] = None) -> bool:
        """Producer gate: block until the consumer's parameter version is
        at least ``min_version``.  Generating item ``i`` only after the
        consumer reached version ``i - K`` guarantees the staleness of
        item ``i`` at training time is at most ``K``."""
        deadline = time.time() + timeout if timeout is not None else None
        with self._cv:
            while self._consumer_version < min_version and not self._closed:
                remaining = (deadline - time.time()) if deadline else None
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(timeout=remaining)
            return self._consumer_version >= min_version

    def get(self, timeout: Optional[float] = None) -> VersionedItem:
        """Pop the oldest item; enforce the staleness bound at hand-off."""
        deadline = time.time() + timeout if timeout is not None else None
        with self._cv:
            while True:
                while not self._q:
                    if self._closed:
                        raise ChannelClosed(self.name)
                    remaining = (deadline - time.time()) if deadline else None
                    if remaining is not None and remaining <= 0:
                        raise queue.Empty()
                    self._cv.wait(timeout=remaining)
                item = self._q.pop(0)
                self._cv.notify_all()
                staleness = self._consumer_version - item.version
                if staleness > self.staleness_bound:
                    if self.stale_policy == "drop":
                        self.dropped_stale += 1
                        continue
                    raise StalenessExceeded(
                        f"{self.name}: sample v{item.version} is "
                        f"{staleness} versions stale (bound "
                        f"{self.staleness_bound})")
                self.total_get += 1
                self.max_observed_staleness = max(
                    self.max_observed_staleness, max(staleness, 0))
                return item

    def qsize(self) -> int:
        with self._cv:
            return len(self._q)

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def producer_version(self) -> int:
        return self._producer_version

    @property
    def consumer_version(self) -> int:
        return self._consumer_version


# Optional observer for DeviceLock wait/grant/release events (an object
# with .record(kind, lock_name, worker, rank)).  Armed by tests through
# set_lock_observer(analysis.LockOrderRecorder()) to validate the static
# concurrency model against the real interleaving; None in production.
_lock_observer: Optional[Any] = None


def set_lock_observer(observer: Optional[Any]) -> Optional[Any]:
    """Install (or clear, with None) the global DeviceLock observer.
    Returns the previous observer so callers can restore it."""
    global _lock_observer
    prev = _lock_observer
    _lock_observer = observer
    return prev


def _notify_lock(kind: str, lock: str, worker: str, rank: int) -> None:
    obs = _lock_observer
    if obs is not None:
        obs.record(kind, lock, worker, rank)


class DeviceLock:
    """Distributed device lock with data-dependency acquisition priority.

    Workers register a *priority rank* derived from the workflow graph's
    topological order (parents/producers rank lower = acquire first).
    ``acquire(worker)`` blocks until the lock is free AND no lower-rank
    worker is waiting — children can only grab devices after their
    producers released them, which avoids both contention and deadlock
    (paper §3.3).  onload/offload hooks fire automatically; the lock skips
    hooks when the two workers are placed on disjoint devices (placement
    information from the Controller).
    """

    def __init__(self, name: str):
        self.name = name
        self._cv = threading.Condition()
        self._holder: Optional[str] = None
        self._waiting: Dict[str, int] = {}
        self._rank: Dict[str, int] = {}
        self._devices: Dict[str, Tuple[int, ...]] = {}
        self.acquisitions = 0
        self.switches = 0  # onload/offload pairs actually performed
        self._last_holder: Optional[str] = None

    def set_priority(self, worker: str, rank: int,
                     devices: Tuple[int, ...] = ()) -> None:
        with self._cv:
            self._rank[worker] = rank
            self._devices[worker] = tuple(devices)

    def _shares_devices(self, a: Optional[str], b: str) -> bool:
        if a is None:
            return False
        da, db = set(self._devices.get(a, ())), set(self._devices.get(b, ()))
        if not da or not db:
            return True  # unknown placement -> be safe, switch
        return bool(da & db)

    def acquire(self, worker: str, *, onload: Optional[Callable] = None,
                timeout: Optional[float] = None) -> bool:
        deadline = time.time() + timeout if timeout else None
        with self._cv:
            self._waiting[worker] = self._rank.get(worker, 0)
            _notify_lock("wait", self.name, worker, self._waiting[worker])
            try:
                while True:
                    lowest = min(self._waiting.values())
                    if (self._holder is None
                            and self._waiting[worker] == lowest):
                        break
                    remaining = (deadline - time.time()) if deadline else None
                    if remaining is not None and remaining <= 0:
                        _notify_lock("leave", self.name, worker,
                                     self._waiting[worker])
                        return False
                    self._cv.wait(timeout=remaining)
                self._holder = worker
                self.acquisitions += 1
                _notify_lock("grant", self.name, worker,
                             self._rank.get(worker, 0))
                needs_switch = (
                    self._last_holder != worker
                    and self._shares_devices(self._last_holder, worker)
                )
            finally:
                self._waiting.pop(worker, None)
        # hooks run outside the lock's critical section
        if needs_switch and onload is not None:
            onload()
            with self._cv:
                self.switches += 1
        return True

    def release(self, worker: str, *, offload: Optional[Callable] = None,
                next_shares_devices: bool = True) -> None:
        if offload is not None and next_shares_devices:
            offload()
        with self._cv:
            assert self._holder == worker, (self._holder, worker)
            self._last_holder = worker
            self._holder = None
            _notify_lock("release", self.name, worker,
                         self._rank.get(worker, 0))
            self._cv.notify_all()

    def __enter__(self):  # bare context-manager use (tests)
        self.acquire("anonymous")
        return self

    def __exit__(self, *exc):
        self.release("anonymous")
