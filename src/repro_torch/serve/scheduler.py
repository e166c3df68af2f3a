"""Continuous-batching scheduler: admission queue + per-step join/evict.

Iteration-level scheduling (Orca/vLLM): the decode batch is re-formed at
*every* step.  A finished request frees its pages and its slot
immediately; the head of the admission queue joins as soon as a slot and
enough pages for its prompt (+ one decode page) are available.  This is
the mechanism that removes the long-tail stall of static batching
(paper Fig. 2): devices never idle behind the slowest response as long
as the queue is non-empty.

With a :class:`~repro_torch.serve.paging.PrefixCache` attached, admission also
resolves prefix sharing (SGLang RadixAttention idiom): the new request
adopts the longest chain of cached full pages (refcount bumped, so a
shared page outlives any single owner), plans a copy-on-write extension
of a cached partial page when profitable, and indexes its own prompt
region so later arrivals — GRPO siblings behind it in the queue, or the
next turn of a multi-turn episode — share *its* prefill.  When the pool
runs dry, admission and page growth evict cold trie leaves (LRU) before
giving up or preempting.

The scheduler is pure host-side bookkeeping — the engine owns the device
compute and asks the scheduler which requests occupy which slots.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.serve.paging import PageAllocator, PrefixCache, PrefixNode

QUEUED = "queued"
RUNNING = "running"
FINISHED = "finished"


class KVPageCost:
    """Per-request page cost of the paged-KV layout: every cached token
    occupies one row, so a request holding ``n`` tokens needs
    ``ceil(n / page_size)`` pool pages."""

    def __init__(self, page_size: int):
        self.page_size = page_size

    def request_pages(self, num_tokens: int) -> int:
        return -(-num_tokens // self.page_size)


class NullPageCost:
    """Constant-size cache layouts (recurrent state): a request's cache
    footprint is its slot, not a token-proportional page count — the
    admission budget degenerates to slot availability and decode-time
    page growth never happens."""

    def request_pages(self, num_tokens: int) -> int:
        return 0


@dataclass
class Request:
    """One generation request moving through the engine."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    seed: int = 0
    # -- lifecycle --------------------------------------------------------
    state: str = QUEUED
    slot: int = -1
    pages: List[int] = field(default_factory=list)
    # number of tokens already written into the KV cache (prompt progress
    # during chunk-less prefill, then prompt + generated during decode)
    num_cached: int = 0
    generated: List[int] = field(default_factory=list)
    logprobs: List[float] = field(default_factory=list)
    hit_eos: bool = False
    # -- prefix sharing ----------------------------------------------------
    # tokens at the front of the prompt whose KV lives in pages adopted
    # from the prefix cache (full pages + COW rows); the engine
    # fast-forwards ``num_cached`` through this region as the shared
    # pages' computed watermarks allow
    shared_len: int = 0
    # trie nodes backing the adopted full pages (parallel to the first
    # len(shared_nodes) entries of ``pages``); used to wait on an active
    # writer instead of recomputing its rows
    shared_nodes: List[PrefixNode] = field(default_factory=list)
    # planned copy-on-write: (src_page, dst_page, rows).  The source page
    # holds an extra pin (refcount) until the engine performs the device
    # copy — or until release, if the request dies first.
    pending_cow: Optional[Tuple[int, int, int]] = None
    # weight version the request was admitted under, and the newest
    # version that produced any of its tokens (in-flight sync may advance
    # it; the staleness correction uses the conservative admitted tag)
    weight_version: int = 0
    last_weight_version: int = 0
    # -- timing (feeds the profiler's measured tail_factor) ---------------
    submit_time: float = 0.0
    start_time: float = 0.0
    finish_time: float = 0.0

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def total_len(self) -> int:
        return self.prompt_len + len(self.generated)

    @property
    def in_prefill(self) -> bool:
        return self.num_cached < self.prompt_len

    def service_time(self) -> float:
        return self.finish_time - self.start_time


@dataclass
class SchedulerStats:
    admitted: int = 0
    finished: int = 0
    evicted_pages: int = 0
    peak_active: int = 0
    steps: int = 0
    preempted: int = 0
    # -- prefix sharing / chunked prefill ----------------------------------
    prefix_hit_tokens: int = 0       # prompt tokens skipped via shared KV
    prefix_shared_pages: int = 0     # full pages adopted at admission
    cow_pages: int = 0               # copy-on-write page extensions
    chunk_deferred_tokens: int = 0   # prefill tokens pushed past a step


class ContinuousScheduler:
    """Admission queue + running set over ``max_batch`` decode slots."""

    def __init__(self, *, max_batch: int, allocator: PageAllocator,
                 max_seq_len: int,
                 prefix_cache: Optional[PrefixCache] = None,
                 cost_model=None, preempt_keeps_progress: bool = False):
        self.max_batch = max_batch
        self.allocator = allocator
        self.max_seq_len = max_seq_len
        self.prefix_cache = prefix_cache
        # the cache layout's per-request cost model: how many pool pages a
        # request holding n tokens needs.  Defaults to the paged-KV model
        # so existing direct constructions keep their semantics.
        self.cost_model = (cost_model if cost_model is not None
                           else KVPageCost(allocator.page_size))
        # state-cache layouts snapshot a preempted request's recurrent
        # state instead of recomputing: its cached progress survives
        self.preempt_keeps_progress = preempt_keeps_progress
        self.waiting: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}  # slot -> request
        self._free_slots: List[int] = list(range(max_batch - 1, -1, -1))
        self._rid = itertools.count()
        self.stats = SchedulerStats()
        self.finished: List[Request] = []

    # -- submission --------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int,
               *, seed: int = 0, weight_version: int = 0) -> Request:
        assert len(prompt) >= 1, "empty prompt: nothing to condition on"
        assert len(prompt) + max_new_tokens <= self.max_seq_len, (
            len(prompt), max_new_tokens, self.max_seq_len)
        req = Request(rid=next(self._rid), prompt=list(prompt),
                      max_new_tokens=max_new_tokens, seed=seed,
                      weight_version=weight_version,
                      last_weight_version=weight_version,
                      submit_time=time.perf_counter())
        self.waiting.append(req)
        return req

    # -- per-step batch formation -----------------------------------------
    def admit(self, *, weight_version: Optional[int] = None) -> List[Request]:
        """FIFO-backfill free slots while the page budget allows.

        A request is admitted only if pages for its *whole* prompt plus
        one decode page are available — admission never deadlocks
        mid-prefill.  Pages covering a cached prefix are adopted (incref)
        rather than allocated; the remainder comes from the free list,
        topped up by LRU trie eviction when the pool runs dry.  Returns
        the newly-admitted requests (already slotted).
        """
        joined: List[Request] = []
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            shared_nodes: List[PrefixNode] = []
            cow: Optional[Tuple[int, int]] = None  # (src_page, rows)
            if self.prefix_cache is not None:
                match = self.prefix_cache.lookup(req.prompt)
                shared_nodes = match.nodes
                # a partial-page extension is only worth copying when the
                # source rows are actually computed; an in-flight writer's
                # unfilled tail would copy garbage
                if (match.partial is not None and match.partial_rows > 0
                        and self.allocator.computed_rows(match.partial.page)
                        >= match.partial_rows):
                    cow = (match.partial.page, match.partial_rows)
            shared_pages = [n.page for n in shared_nodes]
            # pin the adopted pages (and the COW source) before any
            # eviction below can free them out from under us
            self.allocator.incref(shared_pages)
            if cow is not None:
                self.allocator.incref([cow[0]])
            # total_len, not prompt_len: a preempted request re-enters with
            # generated tokens that must be re-cached (recompute on resume)
            need = self.cost_model.request_pages(req.total_len + 1)
            need_new = need - len(shared_pages)
            if (not self.allocator.can_allocate(need_new)
                    and self.prefix_cache is not None):
                self.prefix_cache.evict(
                    need_new - self.allocator.num_free, self.allocator)
            if not self.allocator.can_allocate(need_new):
                # admission stalls: roll back the pins, FIFO head keeps
                # its turn (free() is a decref — the cache still holds
                # its own reference, so nothing is physically freed)
                self.allocator.free(shared_pages)
                if cow is not None:
                    self.allocator.free([cow[0]])
                break
            self.waiting.popleft()
            req.pages = shared_pages + self.allocator.allocate(need_new)
            req.shared_nodes = shared_nodes
            req.shared_len = len(shared_pages) * self.allocator.page_size
            if cow is not None:
                req.pending_cow = (cow[0], req.pages[len(shared_pages)],
                                   cow[1])
                req.shared_len += cow[1]
                self.stats.cow_pages += 1
            self.stats.prefix_shared_pages += len(shared_pages)
            if self.prefix_cache is not None:
                # index this request's own prompt region (it is the
                # writer) so queued siblings share its prefill
                self.prefix_cache.insert(
                    req.prompt, req.pages, self.allocator,
                    start=len(shared_pages) * self.allocator.page_size,
                    writer=req.rid)
            req.slot = self._free_slots.pop()
            req.state = RUNNING
            if req.start_time == 0.0:  # keep the first admission time
                req.start_time = time.perf_counter()
            # a resumed (preempted) request keeps its original admission
            # tag — its earlier tokens were produced under that version
            if weight_version is not None and not req.generated:
                req.weight_version = weight_version
                req.last_weight_version = weight_version
            self.running[req.slot] = req
            self.stats.admitted += 1
            joined.append(req)
        self.stats.peak_active = max(self.stats.peak_active,
                                     len(self.running))
        return joined

    def ensure_page_for(self, req: Request) -> None:
        """Grow the block table so position ``num_cached`` is backed.
        Under a constant-size (state) cost model this is a no-op: the
        layout never asks for more pages than admission granted."""
        if len(req.pages) >= self.cost_model.request_pages(
                req.num_cached + 1):
            return
        if (not self.allocator.can_allocate(1)
                and self.prefix_cache is not None):
            self.prefix_cache.evict(1, self.allocator)
        req.pages.extend(self.allocator.allocate(1))

    def _release_pages(self, req: Request) -> None:
        """Drop every reference the request holds: its page table, an
        un-performed COW pin, and its writer role in the trie.  free()
        decrefs — pages also referenced by the cache or by sharers
        survive."""
        if self.prefix_cache is not None:
            self.prefix_cache.release_writer(req.rid)
        if req.pending_cow is not None:
            self.allocator.free([req.pending_cow[0]])
            req.pending_cow = None
        self.allocator.free(req.pages)
        self.stats.evicted_pages += len(req.pages)
        req.pages = []
        req.shared_nodes = []
        req.shared_len = 0

    def preempt(self, req: Request) -> None:
        """Kick a running request back to the HEAD of the admission queue,
        freeing its slot and decref'ing all its pages (vLLM-style
        recompute preemption): its generated tokens are kept and its KV
        cache is rebuilt — or re-adopted from the prefix cache — when it
        is re-admitted."""
        assert req.state == RUNNING, req.state
        self._release_pages(req)
        del self.running[req.slot]
        self._free_slots.append(req.slot)
        req.slot = -1
        if not self.preempt_keeps_progress:
            req.num_cached = 0  # recompute on resume (paged-KV layouts)
        req.state = QUEUED
        self.waiting.appendleft(req)
        self.stats.preempted += 1

    def finish(self, req: Request, *, index_in_cache: bool = True) -> None:
        """Evict: decref the pages and free the slot immediately (the
        join half of join/evict happens on the next :meth:`admit`).

        When ``index_in_cache`` is set and a prefix cache is attached,
        the full sequence (prompt + generated) is indexed first, so a
        follow-up turn that re-feeds this conversation re-uses the KV.
        The engine clears the flag when the request's KV spans a weight
        swap — stale rows must not be served to new requests.
        """
        assert req.state == RUNNING, req.state
        req.state = FINISHED
        req.finish_time = time.perf_counter()
        if self.prefix_cache is not None and index_in_cache:
            toks = req.prompt + req.generated
            if req.generated:
                # the final sampled token's KV row is never written (the
                # decode step that would scatter it never runs), so it
                # must not be indexed: a follower adopting it would serve
                # a row of zeros — and it may lie past the block table
                toks = toks[:-1]
            self.prefix_cache.insert(toks, req.pages, self.allocator)
        self._release_pages(req)
        del self.running[req.slot]
        self._free_slots.append(req.slot)
        req.slot = -1
        self.stats.finished += 1
        self.finished.append(req)

    # -- views -------------------------------------------------------------
    @property
    def num_active(self) -> int:
        return len(self.running)

    @property
    def has_work(self) -> bool:
        return bool(self.running or self.waiting)

    def active_requests(self) -> List[Request]:
        return [self.running[s] for s in sorted(self.running)]
