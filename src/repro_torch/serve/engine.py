"""Rollout/serving engines: the static batch engine and paged continuous
batching.

:class:`Engine` is the fixed-shape engine: the prompt decoded into a
dense KV ring (or state) a position at a time, then ``max_new_tokens``
rounds of sample-and-decode with a per-sequence ``done`` mask; every arch
kind runs on it, also those no paged layout covers (VLM,
encoder-decoder, windowed attention).  It also carries the embodied
cycle's closed-loop action path (:meth:`Engine.act`).
:class:`PagedEngine` is continuous batching over a device cache whose
layout follows the architecture (:mod:`repro_torch.serve.layouts`): the
decode batch is re-formed every step (finished requests immediately free
their pages or slots, queued prompts backfill), attention reads a paged
KV cache through per-request block tables (the Hopper paged-attention
kernel on the card) and an SSM or hybrid stack keeps a constant-size
state per slot, and trainer weight updates apply *in flight* at step
boundaries with per-request version tags preserved for the staleness
correction.

Both return per-token *behaviour logprobs* so the trainer can form
importance ratios without a separate inference pass.

Counterpart of the JAX package's ``serve/engine.py``, with its tracing
and metrics hooks on the paged engine (the step span and page counters,
``weight-swap``, ``preempt``, the COW and prefix counters); with no
tracer or registry armed each costs one ``None`` check.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.models.layers import NEG_INF
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace
from repro_torch.serve import layouts as layouts_mod
from repro_torch.serve.paging import (
    OutOfPages,
    PageAllocator,
    PrefixCache,
    pad_block_table,
)
from repro_torch.serve.sampling import request_noise, sample_tokens_fused
from repro_torch.serve.scheduler import RUNNING, ContinuousScheduler, Request


class GenerationResult(NamedTuple):
    tokens: torch.Tensor  # (B, S_total) prompt + generated (PAD after EOS)
    logprobs: torch.Tensor  # (B, S_total) behaviour logprob per token (0 on prompt)
    lengths: torch.Tensor  # (B,) total valid length
    done: torch.Tensor  # (B,) bool — hit EOS before max tokens
    # weight version each request was admitted under
    weight_versions: Optional[np.ndarray] = None


class Engine:
    """The static batch engine for one model config.

    :meth:`generate` follows the JAX engine's ``_generate_impl`` step for
    step: a decode state of ``S + max_new_tokens`` positions, the
    left-padded prompt decoded into it (``models.model.prefill``: pads
    are decoded like any token, ``prompt_lens`` is not read), then
    ``max_new_tokens`` rounds of: sample every row from the last logits
    (``sample_tokens_fused``, the fused sampling kernel on the card, once
    a round for the batch), PAD and logprob 0 where a row is done, write
    at position ``S + i``, decode that token.  Like the JAX engine it
    passes no ``extra``: a VLM or encoder-decoder decodes against zero
    cross caches.  The decode state is f32, as the JAX engine's default.

    The Gumbel noise of a round comes from :attr:`noise_fn` ``(seeds,
    positions, V)``, by default :func:`~repro_torch.serve.sampling.
    request_noise` with row ``b`` seeded ``(seed + b) & 0x7FFFFFFF`` at the
    absolute position of the drawn token: the paged layouts' convention,
    so a test may hand it another framework's draws.  (The JAX engine
    splits one threefry key a round instead.)

    ``device`` defaults to the card; without CUDA the caller must pass
    ``device="cpu"``, which runs the kernels' plain versions."""

    def __init__(self, cfg: ModelConfig, *, max_new_tokens: int = 32,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, eos_token: int = 2,
                 pad_token: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos = eos_token
        self.pad = pad_token
        self.noise_fn = request_noise

    @torch.no_grad()
    def generate(self, params, prompt_tokens, prompt_lens=None,
                 seed: Optional[int] = None) -> GenerationResult:
        """prompt_tokens: (B, S) int left-padded prompts; returns
        (B, S + max_new_tokens) tokens (PAD after EOS), behaviour
        logprobs (0 on the prompt), ``lengths`` (S plus the generated
        tokens that are not PAD) and ``done``, as CPU tensors.
        ``prompt_lens`` is accepted and ignored, as in the JAX engine."""
        cfg, dev = self.cfg, self.device
        prompts = torch.as_tensor(np.asarray(prompt_tokens),
                                  dtype=torch.long).to(dev)
        B, S = prompts.shape
        N = self.max_new_tokens
        seeds = (int(seed or 0) + torch.arange(B, device=dev)) & 0x7FFFFFFF
        state = M.init_decode_state(cfg, B, S + N, device=dev)
        logits, state = M.prefill(params, cfg, prompts, state)
        last = logits[:, 0]
        toks = torch.cat([prompts, torch.full((B, N), self.pad,
                                              dtype=torch.long, device=dev)],
                         dim=1)
        lps = torch.zeros((B, S + N), dtype=torch.float32, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        for i in range(N):
            pos = S + i
            gumbel = None
            if self.temperature > 0.0:
                gumbel = torch.as_tensor(
                    self.noise_fn(seeds, torch.full_like(seeds, pos),
                                  last.shape[-1]),
                    dtype=torch.float32, device=dev)
            tok, lp = sample_tokens_fused(
                gumbel, last, temperature=self.temperature, top_k=self.top_k,
                top_p=self.top_p, vocab_size=cfg.vocab_size)
            tok = torch.where(done, self.pad, tok.long())
            toks[:, pos] = tok
            lps[:, pos] = torch.where(done, 0.0, lp)
            done = done | (tok == self.eos)
            logits, state = M.decode_step(params, cfg, tok[:, None], state,
                                          pos)
            last = logits[:, 0]
        lengths = S + (toks[:, S:] != self.pad).sum(dim=1)
        return GenerationResult(
            tokens=toks.to(torch.int32).cpu(), logprobs=lps.cpu(),
            lengths=lengths.to(torch.int32).cpu(), done=done.cpu())

    @torch.no_grad()
    def act(self, params, prompt_tokens, noise, *, action_lo: int,
            action_hi: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """One closed-loop policy step: a single forward over
        ``prompt_tokens`` (B, S), the last position's logits in f32
        masked to the action-token window ``[action_lo, action_hi)``, and
        one Gumbel-max draw a row, ``argmax(logits + noise)``: what
        ``jax.random.categorical`` draws from its own Gumbel noise.

        ``noise``: the (B, V) Gumbel(0, 1) draws (V the padded vocab), or
        a callable that maps V to them; a row's noise must depend on that
        row's env alone for the draw not to depend on how the env batch
        is chunked.  Returns (action_tokens (B,) int32, behaviour
        logprobs (B,) f32), both on the engine's device."""
        tokens = torch.as_tensor(np.asarray(prompt_tokens), dtype=torch.long,
                                 device=self.device)
        logits, _ = M.forward(params, self.cfg, tokens)
        last = logits[:, -1].float()
        V = last.shape[-1]
        idx = torch.arange(V, device=last.device)
        last = torch.where((idx >= action_lo) & (idx < action_hi), last,
                           NEG_INF)
        g = noise(V) if callable(noise) else noise
        toks = torch.argmax(last + g.to(last.device, torch.float32), dim=-1)
        lse = torch.logsumexp(last, dim=-1)
        lps = last.gather(-1, toks[:, None])[:, 0] - lse
        return toks.to(torch.int32), lps


class PagedEngine:
    """Continuous-batching rollout engine with a paged KV cache.

    The engine advances *all* active requests by one token per
    :meth:`step` — mixed prefill/decode (Orca-style iteration-level
    scheduling): a request still consuming its prompt is teacher-forced,
    one past it feeds back its sampled token.  The step runs over
    ``max_batch`` fixed slots (inactive slots write to the reserved trash
    page and are ignored on the host).

    Weight sync: :meth:`update_weights` enqueues a versioned update that
    is applied at the next step boundary *without draining the engine* —
    running requests keep their pages and simply continue under the new
    weights; each request records the version it was admitted under
    (``weight_version``, what the staleness correction references) and
    the newest version that produced any of its tokens
    (``last_weight_version``).

    Sampling is per-request deterministic: the noise of token ``i`` of
    request ``r`` depends only on ``(r.seed, i)``
    (:func:`repro_torch.serve.sampling.request_noise`), so results do not
    depend on how requests were batched together.

    ``device`` defaults to the card; without CUDA the caller must pass
    ``device="cpu"``, which runs the kernels' plain versions.
    """

    def __init__(self, cfg: ModelConfig, *, max_batch: int = 8,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 max_new_tokens: int = 32, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, eos_token: int = 2,
                 pad_token: int = 0, prefix_sharing: bool = True,
                 prefill_chunk: int = 32, dtype=torch.float32,
                 device: DeviceLike = None):
        layout_cls = layouts_mod.layout_class(cfg)
        if layout_cls is None:
            raise NotImplementedError(
                "PagedEngine does not window the paged cache yet"
                if cfg.sliding_window else
                f"PagedEngine has no cache layout for kind={cfg.kind}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_batch = max_batch
        self.page_size = page_size
        self.max_seq_len = max_seq_len or cfg.max_seq_len
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos = eos_token
        self.pad = pad_token
        # per-step prompt-token budget for chunked prefill (0 = legacy
        # token-by-token prefill through the decode step)
        self.prefill_chunk = (int(prefill_chunk)
                              if layout_cls.supports_chunked_prefill else 0)
        if layout_cls.uses_pages:
            self.max_blocks = -(-self.max_seq_len // page_size)
            # default pool: every slot holds a full sequence (+ trash page)
            if num_pages is None:
                num_pages = max_batch * self.max_blocks + 1
            # the pool must at least hold ONE full sequence, or the oldest
            # request could never finish even with everyone else preempted
            if num_pages - 1 < self.max_blocks:
                raise ValueError(f"num_pages={num_pages} cannot hold one "
                                 f"sequence of {self.max_blocks} pages")
        else:
            # constant-size layouts keep the allocator as an inert stub
            # (page_size still parameterizes host bookkeeping); requests
            # cost zero pages, so the pool size is irrelevant
            self.max_blocks = 1
            if num_pages is None:
                num_pages = 2
        self.allocator = PageAllocator(num_pages=num_pages,
                                       page_size=page_size)
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(page_size)
            if prefix_sharing and layout_cls.supports_partial_cow else None)
        self.layout = layout_cls(
            cfg, max_batch=max_batch, page_size=page_size,
            num_pages=num_pages, max_blocks=self.max_blocks,
            max_seq_len=self.max_seq_len, temperature=temperature,
            top_k=top_k, top_p=top_p, dtype=dtype, device=self.device,
            prefix_cache=self.prefix_cache, prefix_sharing=prefix_sharing)
        self.scheduler = ContinuousScheduler(
            max_batch=max_batch, allocator=self.allocator,
            max_seq_len=self.max_seq_len, prefix_cache=self.prefix_cache,
            cost_model=self.layout.cost_model(),
            preempt_keeps_progress=self.layout.preempt_keeps_progress)
        # -- weights + in-flight sync --------------------------------------
        self.params: Any = None
        self.weight_version: int = 0
        self._pending: deque = deque()  # (version, params), newest wins
        self._sync_lock = threading.Lock()
        self.weight_swaps = 0
        # -- bookkeeping ----------------------------------------------------
        # bounded: records feed the profiler's tail fit; without a
        # consumer the log must not grow for the life of the worker
        self.finished_log: deque = deque(maxlen=4096)
        self.decode_steps = 0  # engine steps taken
        self.decode_batches = 0  # of which ran the fixed-shape decode batch
        self.prefill_chunks = 0  # fixed-shape prefill-chunk forwards

    @property
    def cache(self):
        """The layout's device cache (a :class:`PagedKVCache`, or a
        :class:`~repro_torch.models.model.DecodeState` for the state
        layout)."""
        return self.layout.cache

    # ------------------------------------------------------------------
    # weights
    # ------------------------------------------------------------------
    def set_params(self, params: Any, version: Optional[int] = None) -> None:
        """Apply immediately (initial load / synchronous callers)."""
        self.params = params
        if version is not None:
            self.weight_version = version

    def update_weights(self, params: Any,
                       version: Optional[int] = None) -> None:
        """Enqueue an in-flight update; applied at the next step boundary.
        Thread-safe — the trainer may call this while the engine loop is
        mid-generation."""
        with self._sync_lock:
            if version is None:
                # auto-version past any still-pending update, or two
                # back-to-back enqueues would share one tag for
                # different parameter sets
                base = self._pending[-1][0] if self._pending \
                    else self.weight_version
                version = base + 1
            self._pending.append((version, params))

    def release_params(self) -> None:
        """Apply any pending update (so its version tag holds) and drop
        the engine's reference to the weights, so that offloading the
        worker that owns them frees their memory.  The next
        :meth:`generate` or :meth:`update_weights` supplies them again."""
        self._apply_pending()
        self.params = None

    def _apply_pending(self) -> None:
        # params/weight_version are written under the lock: update_weights
        # reads weight_version to auto-assign the next version, so an
        # unlocked write could hand the same tag to two parameter sets
        with self._sync_lock:
            if not self._pending:
                return
            version, params = self._pending[-1]  # newest update wins
            skipped = len(self._pending) - 1
            self._pending.clear()
            self.params = params
            self.weight_version = version
            self.weight_swaps += 1 + skipped
        # cached prefixes were computed under the OLD weights: a request
        # admitted after the swap must not adopt stale KV.  Running
        # requests keep their pages (in-flight sync semantics); only the
        # cache's own references are dropped.
        if self.prefix_cache is not None:
            self.prefix_cache.flush(self.allocator)
        self.layout.on_weight_swap()
        tr = _trace.active()
        if tr is not None:
            tr.instant("weight-swap", "engine", version=version,
                       skipped=skipped)
            reg = _metrics.active()
            if reg is not None:
                reg.counter("engine/weight_swaps").inc(1 + skipped)

    # ------------------------------------------------------------------
    # request lifecycle
    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], *,
               max_new_tokens: Optional[int] = None,
               seed: int = 0) -> Request:
        return self.scheduler.submit(
            list(int(t) for t in prompt),
            max_new_tokens if max_new_tokens is not None
            else self.max_new_tokens,
            seed=seed, weight_version=self.weight_version)

    # ------------------------------------------------------------------
    # host-side engine loop
    # ------------------------------------------------------------------
    def step(self) -> int:
        """Admit, advance every active request, join/evict.  Returns the
        number of requests advanced (chunk-prefilled or decoded).

        Per step: pending COW copies run first, then each request (rid
        order) fast-forwards ``num_cached`` through shared pages as far
        as their computed watermarks allow, requests blocked behind an
        in-flight writer of their shared prefix sit the step out, the
        remaining prompt work is chunk-prefilled under the
        ``prefill_chunk`` token budget, and everyone at the sampling
        frontier decodes one token in the fixed-shape batch."""
        tr = _trace.active()
        reg = _metrics.active()
        t_step = time.perf_counter() if tr is not None else 0.0
        self._apply_pending()  # before the check: update_weights() alone
        # is a valid way to deliver the initial weights
        assert self.params is not None, "engine weights not initialized"
        joined = self.scheduler.admit(weight_version=self.weight_version)
        for q in joined:
            # layout-private admission work: slot reset / snapshot
            # restore / exact-prefix-match reuse (state layouts)
            skipped = self.layout.on_admit(q)
            if skipped:
                self.scheduler.stats.prefix_hit_tokens += skipped
                if reg is not None:
                    reg.counter("serve/prefix_hit_tokens").inc(skipped)
        self._perform_cow_copies()
        self._grow_pages_or_preempt()
        reqs = self.scheduler.active_requests()
        if tr is not None:
            util = (self.allocator.num_allocated
                    / max(self.allocator.num_pages, 1))
            tr.counter("engine/page_util", util)
            if reg is not None:
                reg.gauge("engine/page_util").set(util)
                if self.prefix_cache is not None:
                    reg.gauge("serve/radix_pages").set(
                        self.prefix_cache.num_pages)
        if not reqs:
            if tr is not None:
                tr.add("engine-step", "engine", t_step, time.perf_counter(),
                       advanced=0, prefill=0, decode=0, chunked=0)
            return 0
        budget = self.prefill_chunk
        chunked_tokens = 0
        chunk_only = 0  # advanced by chunk but not yet at the frontier
        deferred = 0
        decode_reqs: List[Request] = []
        waiting: List[Request] = []
        for r in sorted(reqs, key=lambda q: q.rid):
            skipped = self._fast_forward(r)
            if skipped and reg is not None:
                reg.counter("serve/prefix_hit_tokens").inc(skipped)
            if self._waiting_on_writer(r):
                # the shared page under our cursor is still being filled
                # by its writer; wait instead of duplicating its prefill
                waiting.append(r)
                continue
            if self.prefill_chunk > 0 and r.num_cached < r.total_len - 1:
                need = r.total_len - 1 - r.num_cached
                grant = min(need, budget)
                if grant > 0:
                    self._prefill_chunk_step(r, grant)
                    budget -= grant
                    chunked_tokens += grant
                    # a chunk may complete up to a watermark another
                    # sharer extended meanwhile
                    self._fast_forward(r)
                if r.num_cached < r.total_len - 1:
                    deferred += r.total_len - 1 - r.num_cached
                    chunk_only += 1 if grant > 0 else 0
                    continue  # still mid-prompt: no frontier this step
            decode_reqs.append(r)
        if not decode_reqs and chunked_tokens == 0 and waiting:
            # safety valve: never let the whole step idle on writers
            decode_reqs = waiting
        if decode_reqs:
            B = self.max_batch
            tokens = np.zeros((B,), np.int32)
            positions = np.zeros((B,), np.int32)
            tables = np.zeros((B, self.max_blocks), np.int32)  # trash page
            seeds = np.zeros((B,), np.int32)
            active = np.zeros((B,), bool)
            for r in decode_reqs:
                pos = r.num_cached
                if pos < r.prompt_len:
                    tokens[r.slot] = r.prompt[pos]
                else:
                    tokens[r.slot] = r.generated[pos - r.prompt_len]
                positions[r.slot] = pos
                if r.pages:
                    tables[r.slot] = pad_block_table(r.pages,
                                                     self.max_blocks)
                seeds[r.slot] = r.seed
                active[r.slot] = True
            tok, lp = self.layout.step(self.params, tokens, positions,
                                       tables, seeds, active)
            self.decode_batches += 1
            tok_np, lp_np = tok.cpu().numpy(), lp.cpu().numpy()
            for r in decode_reqs:
                pos = r.num_cached
                r.num_cached += 1
                r.last_weight_version = self.weight_version
                if r.pages:
                    page = self.page_size
                    self.allocator.note_computed(r.pages[pos // page],
                                                 pos % page + 1)
                self.layout.note_progress(r)
                # sample only at the frontier: during prompt prefill AND
                # during post-preemption replay of already-generated
                # tokens the step is teacher-forced and its sampled token
                # is discarded
                if pos == r.total_len - 1 and pos >= r.prompt_len - 1:
                    t = int(tok_np[r.slot])
                    r.generated.append(t)
                    r.logprobs.append(float(lp_np[r.slot]))
                    if t == self.eos or len(r.generated) >= r.max_new_tokens:
                        r.hit_eos = t == self.eos
                        # only index KV produced wholly under the current
                        # weights — spans of a mid-flight swap are stale
                        idx = r.weight_version == self.weight_version
                        self.layout.on_finish(r, index_in_cache=idx)
                        self.scheduler.finish(r, index_in_cache=idx)
        if deferred:
            self.scheduler.stats.chunk_deferred_tokens += deferred
            if reg is not None:
                reg.counter("serve/prefill_chunk_deferred").inc(deferred)
        self.decode_steps += 1
        self.scheduler.stats.steps += 1
        advanced = len(decode_reqs) + chunk_only
        if tr is not None:
            # num_cached already advanced: a slot still inside its prompt
            # was a prefill (teacher-forced) step, the rest decoded
            prefill = sum(1 for r in decode_reqs
                          if r.num_cached < r.prompt_len)
            tr.add("engine-step", "engine", t_step, time.perf_counter(),
                   advanced=advanced, prefill=prefill,
                   decode=len(decode_reqs) - prefill,
                   chunked=chunked_tokens)
        return advanced

    # ------------------------------------------------------------------
    # prefix sharing + chunked prefill plumbing
    # ------------------------------------------------------------------
    def _fast_forward(self, r: Request) -> int:
        """Advance ``num_cached`` through the shared-prefix region as far
        as the adopted pages' computed watermarks allow (never past the
        sampling frontier).  Returns the number of positions skipped —
        prompt tokens this request will never prefill."""
        if r.shared_len <= r.num_cached:
            return 0
        page = self.page_size
        ceiling = min(r.shared_len, r.total_len - 1)
        skipped = 0
        while r.num_cached < ceiling:
            pidx = r.num_cached // page
            avail = pidx * page + self.allocator.computed_rows(
                r.pages[pidx])
            if avail <= r.num_cached:
                break
            new = min(avail, ceiling)
            skipped += new - r.num_cached
            r.num_cached = new
        if skipped:
            self.scheduler.stats.prefix_hit_tokens += skipped
        return skipped

    def _waiting_on_writer(self, r: Request) -> bool:
        """True when the shared page under the request's cursor is still
        being prefilled by another running request (the trie writer)."""
        if r.num_cached >= min(r.shared_len, r.total_len - 1):
            return False
        pidx = r.num_cached // self.page_size
        if pidx >= len(r.shared_nodes):
            return False  # COW tail: those rows are ours to compute
        writer = r.shared_nodes[pidx].writer
        return writer is not None and writer != r.rid

    def _perform_cow_copies(self) -> None:
        """Run the device copies the scheduler planned at admission: the
        computed rows of a shared partial page land in the request's
        private page, the watermark follows, and the pinned source is
        released (decref)."""
        for r in self.scheduler.active_requests():
            if r.pending_cow is None:
                continue
            src, dst, rows = r.pending_cow
            self.layout.cow(src, dst)
            self.allocator.note_computed(dst, rows)
            self.allocator.free([src])  # release the admission pin
            r.pending_cow = None
            reg = _metrics.active()
            if reg is not None:
                reg.counter("serve/cow_pages").inc()

    def _prefill_chunk_step(self, r: Request, grant: int) -> None:
        """Cache ``grant`` positions of request ``r`` starting at
        ``num_cached`` in one forward (prompt tokens, or generated tokens
        during post-preemption replay) and advance the watermarks so
        sharers can fast-forward behind us."""
        start = r.num_cached
        end = start + grant
        C = self.prefill_chunk
        toks = np.zeros((C,), np.int32)
        poss = np.zeros((C,), np.int32)
        for i, pos in enumerate(range(start, end)):
            toks[i] = (r.prompt[pos] if pos < r.prompt_len
                       else r.generated[pos - r.prompt_len])
            poss[i] = pos
        self.layout.prefill_chunk_step(self.params, toks, poss, grant, r)
        self.prefill_chunks += 1
        r.num_cached = end
        r.last_weight_version = self.weight_version
        if r.pages:
            page = self.page_size
            for pidx in range(start // page, (end - 1) // page + 1):
                self.allocator.note_computed(
                    r.pages[pidx], min(end - pidx * page, page))
        self.layout.note_progress(r)

    def release_prefix_cache(self) -> int:
        """Drop every cache-held page reference.  Running requests keep
        theirs.  Returns the number of trie nodes dropped."""
        if self.prefix_cache is None:
            return 0
        return self.prefix_cache.flush(self.allocator)

    def _grow_pages_or_preempt(self) -> None:
        """Back every active request's next slot with a page.  When the
        pool runs dry, preempt the YOUNGEST active request (freeing all
        its pages; it re-queues at the head and recomputes on resume) so
        the oldest requests always make progress."""
        for r in sorted(self.scheduler.active_requests(),
                        key=lambda r: r.rid):
            if r.state != RUNNING:  # preempted earlier in this loop
                continue
            while True:
                try:
                    self.scheduler.ensure_page_for(r)
                    break
                except OutOfPages:
                    victims = [v for v in self.scheduler.active_requests()
                               if v.rid > r.rid]
                    victim = max(victims, key=lambda v: v.rid) if victims \
                        else r  # r itself is youngest: it yields
                    self.preempt_request(victim)
                    if victim is r:
                        break

    def preempt_request(self, victim: Request) -> None:
        """Preempt one running request: the layout forgets its cache
        state, then the scheduler requeues it at the head."""
        self.layout.on_preempt(victim)
        self.scheduler.preempt(victim)
        tr = _trace.active()
        if tr is not None:
            tr.instant("preempt", "engine", rid=victim.rid)
            reg = _metrics.active()
            if reg is not None:
                reg.counter("engine/preemptions").inc()

    def run(self) -> List[Request]:
        """Drive until the queue and the running set are both empty."""
        while self.scheduler.has_work:
            self.step()
        done, self.scheduler.finished = self.scheduler.finished, []
        self.finished_log.extend(done)
        return done

    # ------------------------------------------------------------------
    # batch front end
    # ------------------------------------------------------------------
    def generate(self, params, prompt_tokens, prompt_lens=None,
                 seed: int = 0) -> GenerationResult:
        """prompt_tokens: (B, S) int; returns the legacy layout padded to
        ``S + max_new_tokens``.  Request ``i`` is seeded
        ``(seed + i) & 0x7FFFFFFF``."""
        if params is not None:
            self.set_params(params, self.weight_version)
        prompts = np.asarray(prompt_tokens)
        B, S = prompts.shape
        reqs = [self.submit(prompts[i], seed=(int(seed) + i) & 0x7FFFFFFF)
                for i in range(B)]
        self.run()
        return self._collect(reqs, S)

    def _collect(self, reqs: List[Request], S: int) -> GenerationResult:
        B = len(reqs)
        total = S + self.max_new_tokens
        tokens = np.full((B, total), self.pad, np.int32)
        logprobs = np.zeros((B, total), np.float32)
        lengths = np.zeros((B,), np.int32)
        done = np.zeros((B,), bool)
        versions = np.zeros((B,), np.int32)
        for i, r in enumerate(reqs):
            tokens[i, :S] = r.prompt
            n = len(r.generated)
            tokens[i, S:S + n] = r.generated
            logprobs[i, S:S + n] = r.logprobs
            lengths[i] = S + n
            done[i] = r.hit_eos
            versions[i] = r.weight_version
        return GenerationResult(
            tokens=torch.from_numpy(tokens),
            logprobs=torch.from_numpy(logprobs),
            lengths=torch.from_numpy(lengths), done=torch.from_numpy(done),
            weight_versions=versions)

    # ------------------------------------------------------------------
    # measurement
    # ------------------------------------------------------------------
    def pop_request_records(self) -> List[Tuple[int, float]]:
        """(generated_tokens, service_seconds) per finished request;
        clears the log."""
        recs = [(len(r.generated), r.service_time())
                for r in self.finished_log]
        self.finished_log.clear()
        return recs
