"""Worker abstraction + WorkerGroup SPMD dispatch (paper §3.2).

A Worker encapsulates one RL component (rollout, inference, actor train,
simulator, reward...).  The base class provides:

  * ``send/recv`` — adaptive point-to-point comm via the global Router;
  * ``onload/offload`` — resource management hooks; the default
    implementation moves the tensor leaves of the worker's registered
    state trees between its device and host memory (the CPU↔GPU swap of
    the paper).  Both accept a ``keys`` subset so a context switch can
    move the optimizer state separately from the parameters (the
    ContextSwitcher exploits this);
  * ``bind_devices`` — plan-driven placement: the controller rebinds a
    worker to the device slice its ExecutionPlan assigns, and registered
    state follows the worker onto the slice's device;
  * built-in per-call timing, feeding the profiler/scheduler.

``WorkerGroup`` launches N worker processes (threads here; Ray actors in
the paper) and dispatches public method calls to all or a subset of them,
returning asynchronous :class:`FutureHandle` s whose ``wait()`` is the
synchronization barrier of the programming model (Fig. 5b).

Counterpart of the JAX package's ``core/worker.py``.  A worker holds a
:class:`torch.device` where the JAX worker holds a mesh: the cluster ids
of its slice fold onto the local cards as the JAX package's
``launch/mesh.py`` folds them onto local devices (``id % device_count``),
so on one card every id lands on ``cuda:0``.  The platform (the card, or
the CPU when the caller passes ``device="cpu"``) is resolved when the
worker first needs a device, and without CUDA a worker given no device
raises then.  State trees may hold dicts, lists, tuples, NamedTuples
(an AdamW state) and None.
"""
from __future__ import annotations

import threading
import time
import traceback
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.comm.primitives import global_router, leaf_nbytes
from repro_torch.comm.resharding import empty_like_tree
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.utils.treeutil import pytree_flatten, pytree_map


class WorkerFailure(RuntimeError):
    """Typed worker-death signal: carries the worker name, the original
    exception and (when raised from the executor) the pipeline step /
    chunk index at which the task died — so failure detection is
    testable instead of string-matching thread tracebacks."""

    def __init__(self, worker: str, exc: BaseException, tb: str,
                 step: Optional[int] = None):
        at = f" at step {step}" if step is not None else ""
        super().__init__(f"worker {worker} failed{at}: {exc!r}\n{tb}")
        self.worker = worker
        self.original = exc
        self.step = step


@dataclass
class TimerRecord:
    fn: str
    start: float
    elapsed: float
    meta: Dict[str, Any] = field(default_factory=dict)


class Worker:
    """Base RL component. Subclasses implement task methods that read from
    in-channels and write to out-channels (see repro_torch.rl.workers)."""

    def __init__(self, name: str, *, devices: Sequence[int] = (),
                 process_index: int = 0, device: DeviceLike = None):
        self.name = name
        self.devices = tuple(devices)
        self.process_index = process_index
        # the platform the cluster ids fold onto: None = the card
        self.platform = device
        self.router = global_router()
        self.router.register(name, devices=list(devices))
        self._state: Dict[str, Any] = {}  # registered device state
        self._host_state: Dict[str, Any] = {}
        self._offloaded: set = set()  # keys currently living on the host
        self._state_lock = threading.RLock()
        self.timers: List[TimerRecord] = []
        self._timer_lock = threading.Lock()

    # ------------------------------------------------------------------
    # communication (paper: send/recv primitives)
    # ------------------------------------------------------------------
    def send(self, obj: Any, dst: str, async_op: bool = True):
        return self.router.send(self.name, dst, obj, async_op=async_op)

    def recv(self, src: str, timeout: Optional[float] = None) -> Any:
        return self.router.recv(self.name, src, timeout=timeout)

    # ------------------------------------------------------------------
    # placement (plan-driven binding)
    # ------------------------------------------------------------------
    def mesh_of(self, devices: Sequence[int]
                ) -> Optional[Tuple[torch.device, ...]]:
        """The distinct local devices backing the cluster device slice
        ``devices``, in slice order; None for an empty slice.  Cluster
        ids fold onto the local cards round-robin (``id % device_count``);
        on the CPU every id is the CPU."""
        if not devices:
            return None
        base = resolve_device(self.platform)
        if base.type != "cuda":
            return (base,)
        count = torch.cuda.device_count()
        picked: List[torch.device] = []
        for g in devices:
            d = torch.device("cuda", int(g) % count)
            if d not in picked:
                picked.append(d)
        return tuple(picked)

    @property
    def device_mesh(self) -> Optional[Tuple[torch.device, ...]]:
        """The local devices backing this worker's slice (``mesh_of``)."""
        return self.mesh_of(self.devices)

    @property
    def device(self) -> torch.device:
        """Where this worker's state and work live: the first device of
        its slice, or the platform's own device when it owns none."""
        mesh = self.device_mesh
        return mesh[0] if mesh else resolve_device(self.platform)

    def sync_destination(self, tree: Any, key: str = "params") -> Any:
        """The tensors a weight sync of ``tree`` writes into: this
        worker's own resident ``key`` state when it has the same leaves
        (shapes, types, device), else fresh tensors on the worker's
        device.  The dst side of ``comm.resharding.timed_weight_sync``."""
        device = self.device
        with self._state_lock:
            own = (self._state.get(key)
                   if key not in self._offloaded else None)
        if own is not None and _same_layout(own, tree, device):
            return own
        return empty_like_tree(tree, device)

    def bind_devices(self, devices: Sequence[int]) -> None:
        """Rebind this worker to a new device slice (plan-driven
        placement).  Refreshes the router registration (placement-aware
        backend choice must see the new devices) and moves resident state
        to the slice's device when that changes."""
        devices = tuple(devices)
        if devices == self.devices:
            return
        with self._state_lock:
            resident = [k for k, tree in self._state.items()
                        if tree is not None and k not in self._offloaded]
            old = self.device if resident else None
            self.devices = devices
            self.router.register(self.name, devices=list(devices))
            if not resident or self.device == old:
                return
            for k in resident:
                self._state[k] = self._place(self._state[k])

    def _place(self, tree: Any) -> Any:
        device = self.device
        return pytree_map(
            lambda x: x.to(device) if isinstance(x, torch.Tensor) else x,
            tree)

    # ------------------------------------------------------------------
    # resource management (paper: onload/offload for context switching)
    # ------------------------------------------------------------------
    def register_state(self, key: str, tree: Any) -> None:
        self._state[key] = tree

    def get_state(self, key: str) -> Any:
        with self._state_lock:
            if key in self._offloaded:
                self.onload(keys=(key,))
            return self._state[key]

    def set_state(self, key: str, tree: Any) -> None:
        # a fresh write supersedes any offloaded copy of this key —
        # otherwise the next onload() would clobber it with stale state
        # (e.g. weight sync into an offloaded rollout/inference worker)
        with self._state_lock:
            self._state[key] = tree
            self._host_state.pop(key, None)
            self._offloaded.discard(key)

    def state_bytes(self) -> int:
        """Bytes of the registered state that lives on the device now
        (offloaded keys count nothing)."""
        return sum(leaf_nbytes(l) for tree in self._state.values()
                   for l in pytree_flatten(tree)[0])

    @property
    def offloaded(self) -> bool:
        """True when any registered key currently lives on the host."""
        return bool(self._offloaded)

    def offloaded_keys(self) -> Tuple[str, ...]:
        return tuple(sorted(self._offloaded))

    def offload(self, keys: Optional[Sequence[str]] = None) -> Tuple[str, ...]:
        """Move registered device state to host memory (frees the card
        once nothing else holds the tensors).

        ``keys`` selects a subset — e.g. the optimizer state separately
        from the params during a context switch.  The copies to the host
        are blocking.  Returns the keys that actually moved."""
        moved = []
        with self._state_lock:
            ks = list(keys) if keys is not None else list(self._state)
            for k in ks:
                tree = self._state.get(k)
                if k in self._offloaded or tree is None:
                    continue
                self._host_state[k] = pytree_map(
                    lambda x: x.detach().to("cpu", copy=True)
                    if isinstance(x, torch.Tensor) else x, tree)
                self._state[k] = None
                self._offloaded.add(k)
                moved.append(k)
        return tuple(moved)

    def onload(self, keys: Optional[Sequence[str]] = None) -> Tuple[str, ...]:
        """Restore host state onto THIS WORKER'S device; returns the keys
        moved.  State that sat offloaded across a ``bind_devices`` rebind
        lands on the new slice's device."""
        moved = []
        with self._state_lock:
            ks = list(keys) if keys is not None else list(self._offloaded)
            for k in ks:
                if k not in self._offloaded:
                    continue
                tree = self._host_state.pop(k)
                self._state[k] = self._place(tree)
                self._offloaded.discard(k)
                moved.append(k)
        return tuple(moved)

    def release_state(self) -> None:
        """Drop every tensor this worker holds (registered state and its
        host copies): a torn-down worker must not keep its memory while a
        recovery builds its successor."""
        with self._state_lock:
            for k in self._state:
                self._state[k] = None
            self._host_state.clear()
            self._offloaded.clear()

    # ------------------------------------------------------------------
    def _timed(self, fn_name: str, fn: Callable, *args, **kw):
        t0 = time.perf_counter()
        try:
            out = fn(*args, **kw)
            return out
        finally:
            el = time.perf_counter() - t0
            with self._timer_lock:
                self.timers.append(TimerRecord(fn=fn_name, start=t0, elapsed=el))

    def timer_values(self, fn: Optional[str] = None) -> List[float]:
        with self._timer_lock:
            return [t.elapsed for t in self.timers if fn is None or t.fn == fn]

    def shutdown(self) -> None:
        self.router.deregister(self.name)


class FutureHandle:
    """Async result of a WorkerGroup dispatch; ``wait()`` = barrier."""

    def __init__(self, futures: List[Future], group: "WorkerGroup",
                 fn_name: str):
        self._futures = futures
        self._group = group
        self._fn = fn_name
        self._t0 = time.perf_counter()

    def wait(self, timeout: Optional[float] = None) -> List[Any]:
        out = []
        for f in self._futures:
            out.append(f.result(timeout=timeout))
        return out

    def done(self) -> bool:
        return all(f.done() for f in self._futures)

    # worker-group-level timer (paper §4 Performance Profiling): reduced
    # over processes with a chosen reduction
    def timing(self, reduce: str = "max") -> float:
        self.wait()
        vals = []
        for w in self._group.workers:
            ts = w.timer_values(self._fn)
            if ts:
                vals.append(ts[-1])
        if not vals:
            return 0.0
        return {"max": max, "min": min,
                "mean": lambda v: sum(v) / len(v)}[reduce](vals)


class WorkerGroup:
    """All processes of one worker, dispatched collectively (paper §3.2)."""

    def __init__(self, workers: List[Worker]):
        assert workers
        self.workers = workers
        self.name = workers[0].name.rsplit("/", 1)[0]
        self._pool = ThreadPoolExecutor(
            max_workers=len(workers),
            thread_name_prefix=f"wg-{self.name}")
        self._failure_handlers: List[Callable[[WorkerFailure], None]] = []

    @classmethod
    def launch(cls, worker_cls, cluster, *, count: int = 1,
               devices_per_worker: Optional[List[Sequence[int]]] = None,
               **worker_kw) -> "WorkerGroup":
        """SPMD launch on a cluster; placement may be decided by the
        scheduler or specified manually (paper §4 device allocation)."""
        workers = []
        for i in range(count):
            devs = (devices_per_worker[i]
                    if devices_per_worker is not None else
                    cluster.allocate(worker_cls.__name__, 1))
            w = worker_cls(
                name=f"{worker_cls.__name__}/{i}",
                devices=devs, process_index=i, **worker_kw)
            workers.append(w)
        return cls(workers)

    def on_failure(self, handler: Callable[[WorkerFailure], None]) -> None:
        self._failure_handlers.append(handler)

    def _wrap(self, w: Worker, fn_name: str, args, kw):
        """Failure handler wrapper (paper §4 failure monitoring): catches
        exceptions, reports, and re-raises so the controller can kill the
        whole workflow instead of hanging on timeouts."""
        def run():
            try:
                fn = getattr(w, fn_name)
                return w._timed(fn_name, fn, *args, **kw)
            except BaseException as e:  # noqa: BLE001
                failure = WorkerFailure(w.name, e, traceback.format_exc())
                for h in self._failure_handlers:
                    h(failure)
                raise failure from e
        return run

    def call(self, fn_name: str, *args, subset: Optional[List[int]] = None,
             per_worker_args: Optional[List[tuple]] = None,
             **kw) -> FutureHandle:
        targets = (self.workers if subset is None
                   else [self.workers[i] for i in subset])
        futures = []
        for i, w in enumerate(targets):
            a = per_worker_args[i] if per_worker_args is not None else args
            futures.append(self._pool.submit(self._wrap(w, fn_name, a, kw)))
        return FutureHandle(futures, self, fn_name)

    def __getattr__(self, item: str):
        # dispatch public worker methods: group.generate(...) etc.
        if item.startswith("_"):
            raise AttributeError(item)
        probe = getattr(type(self.workers[0]), item, None)
        if probe is None or not callable(probe):
            raise AttributeError(item)

        def dispatch(*args, **kw):
            return self.call(item, *args, **kw)

        return dispatch

    def offload_all(self) -> None:
        for w in self.workers:
            w.offload()

    def onload_all(self) -> None:
        for w in self.workers:
            w.onload()

    def shutdown(self) -> None:
        for w in self.workers:
            w.shutdown()
        self._pool.shutdown(wait=False)


def _same_layout(a: Any, b: Any, device: torch.device) -> bool:
    """True when trees ``a`` and ``b`` have the same structure and their
    tensor leaves the same shapes and types, ``a``'s on ``device``."""
    al, ad = pytree_flatten(a)
    bl, bd = pytree_flatten(b)
    if ad != bd or len(al) != len(bl):
        return False
    for x, y in zip(al, bl):
        if isinstance(x, torch.Tensor) != isinstance(y, torch.Tensor):
            return False
        if isinstance(x, torch.Tensor) and (
                x.shape != y.shape or x.dtype != y.dtype
                or x.device != device):
            return False
    return True
