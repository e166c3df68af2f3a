"""Execution Flow Manager: M2Flow transformation of a logical task stream.

Given the schedule chosen by the scheduler, this module re-chunks worker
tasks to the scheduled data granularity (elastic pipelining, §3.3) and
drives the real workers through channels:

  * ``split``  — a task over batch B becomes B/m sub-tasks of size m,
    letting downstream workers start earlier;
  * ``coalesce`` — sub-results are re-assembled when a consumer needs a
    coarser granularity (e.g. the trainer's global batch for the update);
  * temporal stages run under the channel's device lock so context
    switching is automatic and deadlock-free.

This is the *real* executor (threads + JAX on this host); the discrete-
event Simulator mirrors its behaviour at production scale.

A copy of the JAX package's ``core/pipeline.py``; only its imports
differ.
"""
from __future__ import annotations

import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.channel import AsyncQueue, Channel, ChannelClosed
from repro_torch.core.scheduler import Async, Leaf, Pipelined, Temporal, leaves
from repro_torch.core.worker import WorkerFailure
from repro_torch.obs import trace as _trace


# Bound on every executor-internal join: a worker thread that has not
# finished within this window is wedged, and we want a typed error, not
# a silent hang (or a daemon thread leaking across recoveries).
JOIN_TIMEOUT = 120.0

# thread-name prefixes the executor owns (leak detection scans these)
_THREAD_PREFIXES = ("pipe-prod", "pipe-cons", "cycle-member-",
                    "async-producer", "ctx-prefetch")


class ThreadLeakError(RuntimeError):
    """An executor thread outlived its join window — a wedged producer/
    consumer/cycle-member (or one leaked across a recovery teardown)."""

    def __init__(self, names: Sequence[str], context: str):
        self.thread_names = list(names)
        super().__init__(
            f"{context}: thread(s) {sorted(self.thread_names)} still "
            f"alive after {JOIN_TIMEOUT:.0f}s join timeout")


def _join_all(threads: Sequence[threading.Thread],
              timeout: float = JOIN_TIMEOUT) -> List[threading.Thread]:
    """Join every thread within one shared ``timeout`` budget; returns
    the ones still alive (empty = clean join)."""
    deadline = time.monotonic() + timeout
    for th in threads:
        th.join(timeout=max(deadline - time.monotonic(), 0.0))
    return [th for th in threads if th.is_alive()]


def assert_no_leaked_threads(grace: float = 1.0) -> None:
    """Post-teardown hygiene check (WorkflowRunner.teardown): no
    executor-owned thread may survive the run.  Each suspect gets a
    short grace join (it may be mid-exit); anything still alive raises
    :class:`ThreadLeakError`."""
    suspects = [th for th in threading.enumerate()
                if th.is_alive()
                and any(th.name.startswith(p) for p in _THREAD_PREFIXES)]
    for th in suspects:
        th.join(timeout=grace)
    leaked = [th.name for th in suspects if th.is_alive()]
    if leaked:
        raise ThreadLeakError(leaked, "teardown leaked executor threads")


def leading_leaves(sched) -> List[Leaf]:
    """The leaves that run FIRST under a schedule node — the set a
    context switch must onload at a Temporal cut.  Nested temporal
    stages deeper in the tree onload at their own cuts (onloading the
    whole subtree at once would make sibling temporal stages
    co-resident, peaking memory at the sum of their working sets);
    spatial (Pipelined/Async) sides sit on disjoint devices, so both
    sides' leading stages count."""
    if isinstance(sched, Leaf):
        return [sched]
    if isinstance(sched, Temporal):
        return leading_leaves(sched.s)
    return leading_leaves(sched.s) + leading_leaves(sched.t)


def split_batch(batch: Dict[str, np.ndarray], m: int) -> List[Dict[str, np.ndarray]]:
    """Split a dict-of-arrays batch into chunks of size m along dim 0."""
    B = next(iter(batch.values())).shape[0]
    assert B % m == 0, (B, m)
    out = []
    for i in range(0, B, m):
        out.append({k: v[i:i + m] for k, v in batch.items()})
    return out


def _is_integral_counter(x: Any) -> bool:
    """An int-typed scalar (Python int, np.integer, or 0-d integer
    array) — the only values it is safe to SUM across chunks.  Float
    scalars are typically means/ratios/losses where summing corrupts the
    statistic, and bools are flags; both keep last-chunk semantics."""
    if isinstance(x, (bool, np.bool_)):
        return False
    if isinstance(x, (int, np.integer)):
        return True
    return (isinstance(x, np.ndarray) and x.ndim == 0
            and np.issubdtype(x.dtype, np.integer))


def coalesce(chunks: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Re-assemble chunk results.  Batch arrays concatenate along dim 0;
    integral scalar counters (e.g. a simulator's ``successes``) are
    SUMMED across chunks, since each chunk counted only its own share;
    everything else (metrics dicts, float statistics, flags, strings)
    keeps the last chunk's value."""
    out: Dict[str, Any] = {}
    for k in chunks[0].keys():
        vals = [c[k] for c in chunks]
        first = vals[0]
        if isinstance(first, np.ndarray) and first.ndim >= 1:
            out[k] = np.concatenate(vals, axis=0)
        elif _is_integral_counter(first):
            out[k] = sum(vals) if len(vals) > 1 else first
        else:
            out[k] = vals[-1]
    return out


@dataclass
class StagePlan:
    """One executable stage: a worker task at a data granularity."""
    worker: str
    fn: str
    granularity: int
    devices: int
    shares_devices_with_next: bool = False


# ---------------------------------------------------------------------------
# Collapsed-cycle execution (paper §3.4: the embodied sim<->generation
# loop is ONE schedulable node; the executor realizes it as a closed loop)
# ---------------------------------------------------------------------------
_CYCLE_BOOKKEEPING = ("cycle_step", "env_ids", "rollout_round")


def stack_cycle_steps(step_outs: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Default trajectory assembly: per-step arrays stack to (T, ...);
    integral scalar counters (e.g. the simulator's ``successes``) sum
    across steps; everything else keeps the last step's value.  Loop
    bookkeeping keys are dropped."""
    out: Dict[str, Any] = {}
    for k in step_outs[0].keys():
        if k in _CYCLE_BOOKKEEPING:
            continue
        vals = [s[k] for s in step_outs if k in s]
        if len(vals) != len(step_outs):
            continue
        first = vals[0]
        if isinstance(first, np.ndarray) and first.ndim >= 1:
            out[k] = np.stack(vals)  # (T, N, ...)
        elif _is_integral_counter(first):
            out[k] = sum(vals) if len(vals) > 1 else first
        else:
            out[k] = vals[-1]
    return out


def merge_cycle_chunks(chunk_results: Sequence[Dict[str, Any]]
                       ) -> Dict[str, Any]:
    """Re-join per-chunk trajectories from the hybrid realization along
    the env axis (axis 1 of the (T, N, ...) stacks)."""
    out: Dict[str, Any] = {}
    for k in chunk_results[0].keys():
        vals = [r[k] for r in chunk_results]
        first = vals[0]
        if isinstance(first, np.ndarray) and first.ndim >= 2:
            out[k] = np.concatenate(vals, axis=1)
        elif _is_integral_counter(first):
            out[k] = sum(vals) if len(vals) > 1 else first
        else:
            out[k] = vals[-1]
    return out


@dataclass
class CycleSpec:
    """Closed-loop execution recipe for one collapsed cycle node.

    The schedule's Leaf records WHERE the cycle runs (realization +
    device split); the CycleSpec says HOW one loop step flows through
    the members:

      * ``order`` — member invocation order within one step (e.g. the
        policy acts on the current obs, then the simulator steps);
      * ``steps`` — loop iterations (the rollout horizon T);
      * ``prime`` — optional member task run once before the loop to
        seed the carry (e.g. the simulator's initial observation);
      * ``chunks`` — env-axis split for the hybrid realization's
        fine-grained pipeline (2 = double-buffered obs/action queues:
        the simulator steps chunk i while generation acts on chunk i+1);
      * ``collect`` — per-step outputs -> trajectory dict
        (default :func:`stack_cycle_steps`).

    The executor injects ``cycle_step`` (the loop index) and, in hybrid
    mode, per-chunk ``env_ids`` into the carry; member tasks that need
    determinism across realizations must key their randomness on them.
    """
    order: Tuple[str, ...]
    steps: int
    prime: Optional[str] = None
    chunks: int = 2
    collect: Optional[Callable[[Sequence[Dict]], Dict]] = None


class ExecutionFlowManager:
    """Runs a Schedule tree over real workers.

    workers: name -> object exposing the task fn(chunk)->chunk interface
             plus onload/offload (repro_torch.core.worker.Worker API).
    """

    def __init__(self, workers: Dict[str, Any],
                 task_fns: Dict[str, Callable[[Any, Dict], Dict]],
                 switcher: Optional[Any] = None,
                 members: Optional[Dict[str, Tuple[str, ...]]] = None,
                 cycle_specs: Optional[Dict[str, CycleSpec]] = None,
                 heartbeat: Optional[Any] = None,
                 on_failure: Optional[Callable[[WorkerFailure],
                                               None]] = None):
        self.workers = workers
        self.task_fns = task_fns
        # failure surfacing (paper §4): every task death becomes a typed
        # WorkerFailure reported to `on_failure` (the controller) before
        # it propagates; `heartbeat` (core.faults.HeartbeatMonitor) gets
        # a beat around every task call so silence is detectable
        self.heartbeat = heartbeat
        self.on_failure = on_failure
        # managed Temporal transitions (core.switching.ContextSwitcher):
        # per-key offload, prefetch-onload overlap, measured cost feedback
        self.switcher = switcher
        # collapsed-cycle support: node name -> member workers (from the
        # plan) and node name -> CycleSpec (from the workflow runner)
        self.members = members or {}
        self.cycle_specs = cycle_specs or {}
        # what each executed cycle leaf ACTUALLY ran: (node, mode,
        # member_devices, chunks) — plan-honoring tests read this
        self.cycle_log: List[Tuple[str, str, Optional[Tuple[int, ...]],
                                   int]] = []
        self.timeline: List[Tuple[str, float, float, int]] = []
        self._tl_lock = threading.Lock()

    def _record(self, worker: str, t0: float, t1: float, chunk: int) -> None:
        with self._tl_lock:
            self.timeline.append((worker, t0, t1, chunk))

    # ------------------------------------------------------------------
    def run(self, sched, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        t0 = time.perf_counter()
        out = self._run(sched, batch)
        self.total_time = time.perf_counter() - t0
        return out

    def _apply(self, worker_name: str, chunk: Dict, idx: int) -> Dict:
        w = self.workers[worker_name]
        fn = self.task_fns[worker_name]
        try:
            if getattr(w, "offloaded", False):
                w.onload()
            if self.heartbeat is not None:
                self.heartbeat.beat(worker_name)
            t0 = time.perf_counter()
            out = fn(w, chunk)
            if self.heartbeat is not None:
                self.heartbeat.beat(worker_name)
        except WorkerFailure as f:
            if f.step is None and idx >= 0:
                f.step = idx
            if self.on_failure is not None:
                self.on_failure(f)
            raise
        except BaseException as e:  # noqa: BLE001
            f = WorkerFailure(worker_name, e, traceback.format_exc(),
                              step=idx if idx >= 0 else None)
            if self.on_failure is not None:
                self.on_failure(f)
            raise f from e
        t1 = time.perf_counter()
        self._record(worker_name, t0, t1, idx)
        tr = _trace.active()
        if tr is not None:
            # the executor's task choke point: every worker invocation in
            # every realization passes through here, so this one span is
            # the whole busy timeline (timestamps reused from _record)
            tr.add(worker_name, "task", t0, t1, worker=worker_name,
                   chunk=idx, devices=list(getattr(w, "devices", ())))
        return out

    def _run(self, sched, batch: Dict) -> Dict:
        if isinstance(sched, Leaf):
            if len(self.members.get(sched.worker, ())) > 1:
                return self._run_cycle(sched, batch)
            return self._apply(sched.worker, batch, -1)

        if isinstance(sched, Temporal):
            # prefetch-onload incoming workers whose placement does NOT
            # conflict with the running stage — overlapped with the
            # current stage's tail (nested trees can have disjoint sides)
            pre = None
            incoming = self._expand_cycle_members(
                lf.worker for lf in leading_leaves(sched.t))
            if self.switcher is not None:
                s_devs = self._devices_of(sched.s)
                safe = []
                for name in incoming:
                    w = self.workers.get(name)
                    if (w is not None and getattr(w, "offloaded", False)
                            and set(getattr(w, "devices", ())
                                    ).isdisjoint(s_devs)):
                        safe.append(name)
                if safe:
                    pre = self.switcher.prefetch(safe)
            mid = self._run(sched.s, batch)
            # context switch at the cut: s's device-sharing workers
            # offload first (freeing the shared devices), then t's
            # LEADING stage onloads (deeper stages switch at their own
            # cuts)
            t_devs = self._devices_of(sched.t)
            outgoing = [
                name for name in self._expand_cycle_members(
                    lf.worker for lf in leaves(sched.s))
                if (w := self.workers.get(name)) is not None
                and not set(getattr(w, "devices", ())).isdisjoint(t_devs)]
            if self.switcher is not None:
                if pre is not None:
                    pre.join(timeout=JOIN_TIMEOUT)
                    if pre.is_alive():
                        raise ThreadLeakError(
                            [pre.name], "context-prefetch wedged")
                self.switcher.switch(outgoing, incoming)
            else:
                for name in outgoing:
                    self.workers[name].offload()
            return self._run(sched.t, mid)

        if isinstance(sched, Pipelined):
            m = sched.granularity
            arrs = [v for v in batch.values()
                    if isinstance(v, np.ndarray) and v.ndim >= 1]
            B = arrs[0].shape[0] if arrs else m
            if batch.get("_cycle_traj") or B <= m:
                # single-chunk pipeline — or a cycle trajectory, whose
                # leading axis is TIME, not batch items, so the env-axis
                # chunk contract does not apply: the two sides simply run
                # back-to-back on their disjoint devices
                return self._run(sched.t, self._run(sched.s, batch))
            chunks = split_batch(batch, m)
            # anonymous per-run channel: construct directly — create()
            # would pin it in the global registry forever
            ch = Channel(f"pipe-{id(sched)}-{time.time_ns()}")
            results: List[Optional[Dict]] = [None] * len(chunks)
            err: List[BaseException] = []

            def producer():
                i = -1
                tr = _trace.active()
                try:
                    for i, c in enumerate(chunks):
                        if tr is not None:
                            with tr.span("produce", "pipe", chunk=i):
                                out = self._run(sched.s, c)
                        else:
                            out = self._run(sched.s, c)
                        ch.put((i, out))
                except BaseException as e:  # noqa: BLE001
                    # surface producer-side failures: a silently dead
                    # producer yields an empty coalesce downstream, which
                    # shows up as a confusing KeyError far from the cause
                    if isinstance(e, WorkerFailure) and e.step is None:
                        e.step = i  # the chunk the side died on
                    err.append(e)
                finally:
                    ch.close()

            def consumer():
                i = -1
                tr = _trace.active()
                try:
                    while True:
                        try:
                            i, c = ch.get()
                        except ChannelClosed:
                            break
                        if tr is not None:
                            with tr.span("consume", "pipe", chunk=i):
                                results[i] = self._run(sched.t, c)
                        else:
                            results[i] = self._run(sched.t, c)
                except BaseException as e:  # noqa: BLE001
                    if isinstance(e, WorkerFailure) and e.step is None:
                        e.step = i
                    err.append(e)

            tp = threading.Thread(target=producer, daemon=True,
                                  name=f"pipe-prod-{id(sched)}")
            tc = threading.Thread(target=consumer, daemon=True,
                                  name=f"pipe-cons-{id(sched)}")
            tp.start(); tc.start()
            leaked = _join_all([tp, tc])
            if leaked:
                # wake whichever side is parked on the channel, then give
                # it a moment to unwind before declaring the leak
                ch.close()
                leaked = _join_all(leaked, timeout=5.0)
            if err:
                raise err[0]
            if leaked:
                raise ThreadLeakError([th.name for th in leaked],
                                      "Pipelined stage wedged")
            done = [r for r in results if r is not None]
            return coalesce(done) if done else {}

        if isinstance(sched, Async):
            # A single `run(batch)` call covers ONE iteration of an async
            # plan: producer side then consumer side on their own device
            # shares.  The cross-iteration overlap (producer racing ahead
            # under stale weights) is driven by AsyncPipelineDriver, which
            # owns the iteration loop and the weight-version bookkeeping.
            mid = self._run(sched.s, batch)
            return self._run(sched.t, mid)

        raise TypeError(type(sched))

    # ------------------------------------------------------------------
    # collapsed-cycle leaves: closed-loop execution of the members
    # ------------------------------------------------------------------
    def _run_cycle(self, leaf: Leaf, batch: Dict) -> Dict:
        ms = self.members[leaf.worker]
        spec = self.cycle_specs.get(leaf.worker)
        if spec is None:
            raise KeyError(
                f"no CycleSpec registered for collapsed cycle node "
                f"{leaf.worker!r} (members {ms}); the workflow runner "
                f"must pass cycle_specs to Controller.execute")
        # HONOR the realization the scheduler recorded on the Leaf —
        # the executor must not re-derive (and possibly contradict) it
        mode = leaf.cycle_mode or "collocated"
        chunks = 1
        if mode == "hybrid":
            B = self._cycle_batch_size(batch)
            # the chunk count is part of the recorded realization (the
            # scheduler priced it); spec.chunks is the fallback for
            # hand-built plans
            chunks = max(leaf.cycle_chunks or spec.chunks, 1)
            while chunks > 1 and B % chunks:
                chunks -= 1
            if chunks == 1:
                # no divisible chunking exists: the pipeline degenerates
                # to full-batch alternation — log what actually runs
                mode = "collocated"
        self.cycle_log.append(
            (leaf.worker, mode, leaf.member_devices, chunks))
        out = (self._run_cycle_hybrid(spec, batch, chunks)
               if mode == "hybrid"
               else self._run_cycle_collocated(spec, batch))
        # trajectories are step-major (T, N, ...): mark them so a
        # downstream Pipelined stage never mistakes the time axis for
        # the env-chunk axis
        out["_cycle_traj"] = True
        return out

    @staticmethod
    def _cycle_batch_size(batch: Dict) -> int:
        for v in batch.values():
            if isinstance(v, np.ndarray) and v.ndim >= 1:
                return v.shape[0]
        raise ValueError("cycle batch has no array to infer env count from")

    def _run_cycle_collocated(self, spec: CycleSpec, batch: Dict) -> Dict:
        """Members alternate on the shared devices, one full-batch loop
        step at a time."""
        carry = dict(batch)
        if spec.prime is not None:
            carry = self._apply(spec.prime, carry, -1)
        step_outs: List[Dict] = []
        for t in range(spec.steps):
            carry["cycle_step"] = t
            for m in spec.order:
                carry = self._apply(m, carry, t)
            step_outs.append(dict(carry))
        return (spec.collect or stack_cycle_steps)(step_outs)

    def _run_cycle_hybrid(self, spec: CycleSpec, batch: Dict,
                          chunks: int) -> Dict:
        """Members on disjoint device shares, fine-grained-pipelined over
        env chunks: while the last member (the simulator) steps chunk i,
        the first member (generation) acts on chunk i+1.  Ring of
        channels, one thread per member; at most ``chunks`` carries are
        ever in flight (the double-buffering bound), and each thread
        consumes (step, chunk) pairs in a fixed order, so trajectories
        are bit-identical to the collocated realization when member
        tasks key their randomness on (cycle_step, env_ids)."""
        B = self._cycle_batch_size(batch)
        base_ids = np.asarray(batch.get("env_ids", np.arange(B)))
        subs: List[Dict] = []
        for c in range(chunks):
            lo, hi = c * B // chunks, (c + 1) * B // chunks
            sub = {k: (v[lo:hi] if isinstance(v, np.ndarray)
                       and v.ndim >= 1 else v)
                   for k, v in batch.items()}
            sub["env_ids"] = base_ids[lo:hi]
            subs.append(sub)

        k = len(spec.order)
        # direct construction (not Channel.create): these per-iteration
        # rings are anonymous; registering them would leak an entry in
        # the global Channel registry every training iteration
        rings = [Channel(f"cycle-{i}-{time.time_ns()}")
                 for i in range(k)]
        outs: List[List[Optional[Dict]]] = [
            [None] * spec.steps for _ in range(chunks)]
        err: List[BaseException] = []

        def close_all():
            for ch in rings:
                ch.close()

        def member_loop(idx: int):
            name = spec.order[idx]
            inq, outq = rings[idx], rings[(idx + 1) % k]
            last = idx == k - 1
            try:
                for t in range(spec.steps):
                    for c in range(chunks):
                        carry = inq.get()
                        carry["cycle_step"] = t
                        carry = self._apply(name, carry, t * chunks + c)
                        if last:
                            outs[c][t] = dict(carry)
                            if t < spec.steps - 1:
                                outq.put(carry)
                        else:
                            outq.put(carry)
            except ChannelClosed:
                pass
            except BaseException as e:  # noqa: BLE001
                err.append(e)
                close_all()

        # seed the ring: prime each chunk (initial observation), then
        # feed the first member
        try:
            for c, sub in enumerate(subs):
                carry = (self._apply(spec.prime, sub, -1 - c)
                         if spec.prime is not None else dict(sub))
                rings[0].put(carry)
        except BaseException:
            close_all()
            raise
        threads = [threading.Thread(target=member_loop, args=(i,),
                                    daemon=True,
                                    name=f"cycle-member-{spec.order[i]}")
                   for i in range(k)]
        for th in threads:
            th.start()
        leaked = _join_all(threads)
        close_all()
        if leaked:
            # closing the ring wakes members parked on a get; a member
            # still alive after that is genuinely wedged
            leaked = _join_all(leaked, timeout=5.0)
        if err:
            raise err[0]
        if leaked:
            raise ThreadLeakError([th.name for th in leaked],
                                  "hybrid cycle ring wedged")
        chunk_results = [(spec.collect or stack_cycle_steps)(o)
                         for o in outs]
        return merge_cycle_chunks(chunk_results)

    def _expand_cycle_members(self, names) -> List[str]:
        """Schedule leaves name collapsed cycles by their synthetic node
        name; the REAL workers at a Temporal cut are the members — the
        switcher must see them or cycle members would silently escape
        offload/onload discipline."""
        out: List[str] = []
        for n in names:
            out.extend(self.members.get(n, (n,)))
        return out

    def _devices_of(self, sched) -> set:
        out = set()
        for name in self._expand_cycle_members(
                lf.worker for lf in leaves(sched)):
            w = self.workers.get(name)
            if w is not None:
                out |= set(getattr(w, "devices", ()))
        return out


class AsyncPipelineDriver:
    """Cross-iteration executor for bounded-staleness off-policy training.

    Generation keeps producing rollouts under parameter version ``v`` while
    the trainer advances to ``v+1, v+2, …`` — the producer is gated so that
    no sample is ever consumed more than ``staleness_bound`` (K) versions
    stale:

      * before generating item ``i`` the producer blocks until the
        consumer has published version ``i - K`` (K = 0 → fully sync);
      * ``sync_fn(version)`` then pulls the freshest weights into the
        generation-side workers and the payload is version-tagged on the
        bounded :class:`AsyncQueue` (capacity = K).  If ``sync_fn``
        returns an int, that becomes the tag — letting the caller stamp
        the version of the weights it ACTUALLY pulled (the trainer may
        have advanced between the gate and the sync, and tags must match
        the weights the rollout was generated with);
      * the consumer validates the bound on every ``get`` (strict policy),
        trains, publishes ``version + 1``, and the cycle continues.

    ``produce_fn(i, version) -> payload`` runs the generation-side stages;
    ``consume_fn(item: VersionedItem) -> result`` runs the training-side
    stages (including any staleness importance correction).
    """

    def __init__(self, *, produce_fn: Callable[[int, int], Any],
                 consume_fn: Callable[[Any], Any],
                 sync_fn: Optional[Callable[[int], None]] = None,
                 staleness_bound: int = 1,
                 name: str = "async-pipe"):
        self.produce_fn = produce_fn
        self.consume_fn = consume_fn
        self.sync_fn = sync_fn
        self.staleness_bound = staleness_bound
        self.queue = AsyncQueue(name, staleness_bound=staleness_bound,
                                stale_policy="strict")
        self.results: List[Any] = []
        self._producer_err: List[BaseException] = []

    @property
    def version(self) -> int:
        return self.queue.consumer_version

    def run(self, iterations: int) -> List[Any]:
        """Run the full horizon; returns per-iteration consumer results."""
        K = self.staleness_bound

        def producer():
            try:
                for i in range(iterations):
                    # staleness gate: weights for item i are at least v i-K
                    if not self.queue.wait_for_version(i - K):
                        # queue closed (consumer died): don't waste a full
                        # generation pass on a payload whose put can only
                        # raise ChannelClosed
                        break
                    v = self.queue.consumer_version
                    if self.sync_fn is not None:
                        synced = self.sync_fn(v)
                        if isinstance(synced, int):
                            v = max(v, synced)
                    payload = self.produce_fn(i, v)
                    self.queue.put(payload, version=v)
            except BaseException as e:  # noqa: BLE001
                self._producer_err.append(e)
            finally:
                self.queue.close()

        th = threading.Thread(target=producer, daemon=True,
                              name=f"async-producer-{id(self)}")
        th.start()
        try:
            for _ in range(iterations):
                try:
                    item = self.queue.get()
                except ChannelClosed:
                    break
                self.results.append(self.consume_fn(item))
                self.queue.advance_consumer(self.queue.consumer_version + 1)
        finally:
            self.queue.close()
            th.join(timeout=JOIN_TIMEOUT)
        # surface the root cause first: a producer that died explains a
        # wedged queue far better than the leak it caused
        if self._producer_err:
            raise self._producer_err[0]
        if th.is_alive():
            raise ThreadLeakError([th.name], "async producer wedged")
        return self.results
