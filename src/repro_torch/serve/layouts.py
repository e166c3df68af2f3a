"""Cache layouts behind the serve-tier interface: the paged-KV layout of
dense attention stacks, its MoE variant, and the constant-size state
cache of SSM and hybrid stacks.

The continuous-batching engine (:class:`repro_torch.serve.engine.PagedEngine`)
is host-side scheduling over a device cache whose shape depends on the
architecture.  :class:`PagedKVLayout` is the vLLM layout: a (L, P, page,
KV, hd) page pool addressed through per-request block tables.  Pages grow
with every decoded token, preemption recomputes, and the radix prefix
trie can share full pages and copy-on-write partial ones.
:class:`StateCacheLayout` keeps one constant-size recurrent state per
request slot: preemption snapshots it, and prefix reuse is an exact
full-prompt match.

Counterpart of the JAX package's ``serve/layouts.py``.  Where JAX donates
the page pools to a jitted step, the port updates them in place with
``index_put_``.  Decode attention and sampling go through
:mod:`repro_torch.kernels.ops`: the Hopper kernels on the card, their
plain versions on the CPU.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DENSE, HYBRID, MOE, SSM, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import model as M
from repro_torch.models.attention import (
    KVCache,
    additive_mask,
    qkv_project,
    sdpa,
)
from repro_torch.models.layers import apply_rope, embed, mlp, rmsnorm, unembed
from repro_torch.models.model import layer_params
from repro_torch.models.moe import moe_decode_exact
from repro_torch.models.ssm import SSMState
from repro_torch.serve.paging import (
    TRASH_PAGE,
    PagedKVCache,
    PrefixCache,
    init_paged_cache,
    pad_block_table,
)
from repro_torch.serve.sampling import request_noise, sample_tokens_fused
from repro_torch.serve.scheduler import KVPageCost, NullPageCost, Request
from repro_torch.utils.treeutil import to_device


class LayoutError(TypeError):
    """A cache layout was constructed with a combination it cannot serve
    (e.g. a state-cache layout with a partial-page COW prefix trie)."""


class CacheLayout:
    """Device-cache strategy for one model architecture.

    Subclasses own the step/prefill compute and the cache buffers; the
    engine owns the host loop and calls through this interface.  The
    class attributes are the *policy* the engine and scheduler read:

    - ``uses_pages``: requests consume pool pages (block tables, page
      watermarks, COW) vs a constant-size per-slot cache.
    - ``supports_partial_cow``: a radix
      :class:`~repro_torch.serve.paging.PrefixCache` (full-page adoption +
      partial-page copy-on-write) may be attached.
    - ``preempt_keeps_progress``: preemption snapshots per-request cache
      state, so ``num_cached`` survives requeueing.

    ``noise_fn(seeds, positions, V)`` gives the (B, V) Gumbel noise of the
    decode batch (default :func:`~repro_torch.serve.sampling.request_noise`).
    It is a test seam: a test may set it to hand the port another
    framework's noise.
    """

    name = "abstract"
    uses_pages = True
    supports_partial_cow = True
    supports_chunked_prefill = True
    preempt_keeps_progress = False

    def __init__(self, cfg: ModelConfig, *, max_batch: int, page_size: int,
                 num_pages: int, max_blocks: int, max_seq_len: int,
                 temperature: float, top_k: int, top_p: float, dtype,
                 device: DeviceLike = None,
                 prefix_cache: Optional[PrefixCache] = None,
                 prefix_sharing: bool = True):
        self.cfg = cfg
        self.max_batch = max_batch
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_blocks = max_blocks
        self.max_seq_len = max_seq_len
        self.prefix_sharing = prefix_sharing
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.dtype = dtype
        self.device = resolve_device(device)
        self.noise_fn = request_noise

    # -- scheduler integration ---------------------------------------------
    def cost_model(self):
        return (KVPageCost(self.page_size) if self.uses_pages
                else NullPageCost())

    # -- compute (implemented by subclasses) -------------------------------
    def step(self, params, tokens, positions, tables, seeds, active):
        """Advance every slot one token; returns (tokens, logprobs)."""
        raise NotImplementedError

    def prefill_chunk_step(self, params, tokens, positions, n_valid,
                           req: Request) -> None:
        """Cache ``n_valid`` positions of one request in a single call."""
        raise NotImplementedError

    def cow(self, src: int, dst: int) -> None:
        """Copy-on-write a whole page (paged-KV layouts only)."""
        raise NotImplementedError

    # -- lifecycle hooks (default: no-ops) ---------------------------------
    def on_admit(self, req: Request) -> int:
        """Called for each newly-admitted request; returns the number of
        prompt positions satisfied from a layout-private cache."""
        return 0

    def on_preempt(self, req: Request) -> None:
        """Called just before the scheduler requeues a running request."""

    def on_finish(self, req: Request, *, index_in_cache: bool) -> None:
        """Called just before the scheduler evicts a finished request."""

    def on_weight_swap(self) -> None:
        """Called after an in-flight weight update lands."""

    def note_progress(self, req: Request) -> None:
        """Called after ``req.num_cached`` advances (decode or chunk)."""

    def rebind(self, device: DeviceLike,
               memo: Optional[Dict[int, torch.Tensor]] = None) -> None:
        """Re-place the layout's device buffers on ``device``, dropping
        the old storage, and allocate there from now on.  A subclass
        moves its buffers after this (``memo`` as ``to_device``'s)."""
        self.device = resolve_device(device)

    # -- shared sampling tail ----------------------------------------------
    def _sample_batch(self, logits, seeds, positions):
        """Per-request deterministic sampling: the noise of the token at
        ``position`` of a request seeded ``seed`` depends on nothing else,
        so draws are invariant to batching, chunking and preemption."""
        gumbel = None
        if self.temperature > 0.0:
            gumbel = torch.as_tensor(
                self.noise_fn(seeds, positions, logits.shape[-1]),
                dtype=torch.float32, device=logits.device)
        return sample_tokens_fused(
            gumbel, logits, temperature=self.temperature, top_k=self.top_k,
            top_p=self.top_p, vocab_size=self.cfg.vocab_size)

    def _to_device(self, a: Any, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)


# ===========================================================================
# Paged KV (dense attention stacks)
# ===========================================================================
class PagedKVLayout(CacheLayout):
    """vLLM-style paged KV pool + block tables; dense attention stacks."""

    name = "paged-kv"
    uses_pages = True
    supports_partial_cow = True
    preempt_keeps_progress = False

    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__(cfg, **kw)
        self.cache: PagedKVCache = init_paged_cache(
            cfg.num_layers, self.num_pages, self.page_size,
            cfg.num_kv_heads, cfg.resolved_head_dim, self.dtype, self.device)

    # -- per-layer FFN hook (an MoE subclass overrides it) ------------------
    def _ffn(self, lp, h):
        return mlp(lp["mlp"], h)

    # -- compute -------------------------------------------------------------
    @torch.no_grad()
    def _step_impl(self, params, tokens, positions, block_tables, seeds):
        """One token for every slot.  tokens/positions/seeds (max_batch,)
        int64, block_tables (max_batch, max_blocks) int32, cache
        (L, P, page, KV, hd)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens[:, None])  # (B, 1, d)
        posb = positions[:, None]
        page = self.page_size
        page_idx = block_tables.long().gather(
            1, (positions // page)[:, None])[:, 0]
        offset = positions % page
        ctx = (positions + 1).to(torch.int32)  # valid tokens after the write
        for i in range(cfg.num_layers):
            lp = layer_params(params["layers"], i)
            kl, vl = self.cache.k[i], self.cache.v[i]  # (P, page, KV, hd)
            h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
            q, k, v = qkv_project(lp["attn"], cfg, h)  # (B, 1, H|KV, hd)
            q = apply_rope(q, posb, cfg.rope_theta)
            k = apply_rope(k, posb, cfg.rope_theta)
            # scatter this step's K/V into each request's current page
            # (inactive slots all target the trash page: duplicate
            # indices there are harmless, nothing reads it unmasked)
            kl.index_put_((page_idx, offset), k[:, 0].to(kl.dtype))
            vl.index_put_((page_idx, offset), v[:, 0].to(vl.dtype))
            out = kops.paged_attention(
                q[:, 0], kl, vl, block_tables, ctx)[:, None]
            x = x + torch.einsum("bshk,hkd->bsd", out, lp["attn"]["wo"])
            x = x + self._ffn(lp, rmsnorm(lp["ln2"], x, cfg.norm_eps))
        x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        logits = unembed(params["embed"], x)[:, 0]  # (B, V)
        return self._sample_batch(logits, seeds, positions)

    @torch.no_grad()
    def _prefill_impl(self, params, tokens, positions, block_table,
                      n_valid: int) -> None:
        """Write KV for up to ``prefill_chunk`` prompt positions of ONE
        request in a single forward.  No logits come back: every chunked
        position is strictly before the sampling frontier, which always
        goes through :meth:`_step_impl`.  tokens/positions (C,) int64,
        block_table (max_blocks,) int64."""
        cfg = self.cfg
        C = tokens.shape[0]
        page = self.page_size
        S = self.max_blocks * page
        valid = torch.arange(C, device=self.device) < n_valid
        x = embed(params["embed"], tokens[None, :])  # (1, C, d)
        posb = positions[None, :]
        # padded rows scatter into the trash page, like inactive slots
        page_idx = torch.where(valid, block_table[positions // page],
                               TRASH_PAGE)
        offset = positions % page
        kpos = torch.arange(S, device=self.device)
        # causal over the request's own logical context: everything at or
        # before a row's position is already cached (earlier steps) or is
        # written by this very chunk's scatter before the gather below
        mask = additive_mask(kpos[None, :] <= positions[:, None])[None, None]
        for i in range(cfg.num_layers):
            lp = layer_params(params["layers"], i)
            kl, vl = self.cache.k[i], self.cache.v[i]
            h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
            q, k, v = qkv_project(lp["attn"], cfg, h)  # (1, C, H|KV, hd)
            q = apply_rope(q, posb, cfg.rope_theta)
            k = apply_rope(k, posb, cfg.rope_theta)
            kl.index_put_((page_idx, offset), k[0].to(kl.dtype))
            vl.index_put_((page_idx, offset), v[0].to(vl.dtype))
            kc = kl[block_table].reshape(1, S, *kl.shape[2:])
            vc = vl[block_table].reshape(1, S, *vl.shape[2:])
            out = sdpa(q, kc, vc, mask)  # (1, C, H, hd)
            x = x + torch.einsum("bshk,hkd->bsd", out, lp["attn"]["wo"])
            x = x + self._ffn(lp, rmsnorm(lp["ln2"], x, cfg.norm_eps))

    # -- host-facing API ----------------------------------------------------
    def step(self, params, tokens, positions, tables, seeds, active):
        return self._step_impl(
            params, self._to_device(tokens), self._to_device(positions),
            self._to_device(tables, torch.int32), self._to_device(seeds))

    def prefill_chunk_step(self, params, tokens, positions, n_valid,
                           req: Request) -> None:
        table = self._to_device(pad_block_table(req.pages, self.max_blocks))
        self._prefill_impl(params, self._to_device(tokens),
                           self._to_device(positions), table, int(n_valid))

    @staticmethod
    @torch.no_grad()
    def _cow_impl(k_pages, v_pages, src: int, dst: int) -> None:
        """Copy page ``src`` into page ``dst`` on every layer, in place —
        the copy-on-write that lets a request extend a shared partial page
        privately.  The whole page is copied: rows past the destination's
        computed watermark are never read before the owner overwrites
        them."""
        k_pages[:, dst] = k_pages[:, src]
        v_pages[:, dst] = v_pages[:, src]

    def cow(self, src: int, dst: int) -> None:
        self._cow_impl(self.cache.k, self.cache.v, src, dst)

    def rebind(self, device: DeviceLike,
               memo: Optional[Dict[int, torch.Tensor]] = None) -> None:
        super().rebind(device)
        self.cache = to_device(self.cache, self.device, memo)


class MoEPagedKVLayout(PagedKVLayout):
    """Paged KV pool with the FFN half routed through the exact top-k
    expert combine.  Capacity dispatch (the training path) depends on the
    batch (a token's drops depend on who else is in the decode batch),
    which would break the scheduling-invariance contract, so serving
    always uses the drop-free per-token combine, ``ops.moe_decode``: the
    grouped per-expert kernels on the card, once per layer in every decode
    step and every prefill chunk."""

    name = "paged-kv-moe"

    def _ffn(self, lp, h):
        return moe_decode_exact(lp["moe"], self.cfg, h)


# ===========================================================================
# Constant-size state cache (SSM / hybrid stacks)
# ===========================================================================
def _batch_axes(cfg: ModelConfig) -> M.DecodeState:
    """Tree (matching DecodeState) of each leaf's slot/batch axis."""
    if cfg.kind == SSM:
        return M.DecodeState(ssm=SSMState(ssm=1, conv=1))
    if cfg.kind == HYBRID:
        return M.DecodeState(ssm=SSMState(ssm=2, conv=2),
                             shared_kv=KVCache(k=1, v=1, positions=1))
    raise LayoutError(
        f"state cache layout has no slot axes for kind={cfg.kind}")


def _tmap(fn, tree, *rest):
    """``fn`` over the tensor leaves of matching DecodeState trees (named
    tuples, () for an unused member)."""
    if isinstance(tree, tuple):
        return type(tree)(*(_tmap(fn, *kids) for kids in zip(tree, *rest)))
    return fn(tree, *rest)


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for kid in tree for x in _leaves(kid)]
    return [tree]


class StateCacheLayout(CacheLayout):
    """Constant-size recurrent state per request slot (SSM / hybrid).

    The cache is the model's own stacked :class:`~repro_torch.models.model.
    DecodeState` over ``max_batch`` slots: Mamba2 SSD state + conv window
    per layer, plus the shared-attention KV ring for hybrid stacks.
    Decode needs no page growth (``NullPageCost``), preemption snapshots
    the victim's slot state (progress survives requeueing), and prefix
    reuse is an exact full-prompt match against an LRU snapshot cache:
    SSD state at position ``i`` depends on every token before it, so
    adopting part of a cached prefix is meaningless.  Partial-page COW is
    structurally impossible: constructing this layout with a radix
    :class:`PrefixCache` raises :class:`LayoutError`.

    Where JAX's arrays are immutable, a slice of the cache here is a view
    that the next step overwrites in place: every snapshot (preemption,
    the exact-prompt cache, the zero row) is a ``clone``.  One engine step
    runs ``decode_step`` over all slots with per-slot positions, so each
    SSM layer's state update (K7 on the card) runs once per step for the
    whole batch; inactive slots keep their state bit for bit.
    """

    name = "state"
    uses_pages = False
    supports_partial_cow = False
    # a recurrent step is sequential whether it happens in a per-request
    # chunk or the decode batch, and the decode batch runs every slot's
    # step in one call: chunked prefill would only slow the state cache
    supports_chunked_prefill = False
    preempt_keeps_progress = True

    def __init__(self, cfg: ModelConfig, **kw):
        if kw.get("prefix_cache") is not None:
            raise LayoutError(
                "state cache layouts cannot take a partial-page COW "
                "prefix cache: recurrent state is position-dependent, so "
                "prefix reuse is exact-full-prompt-match only")
        super().__init__(cfg, **kw)
        self._axes = _batch_axes(cfg)
        self.cache: M.DecodeState = M.init_decode_state(
            cfg, self.max_batch, self.max_seq_len, self.dtype, self.device)
        # one zeroed slot row, used to reset a slot for a fresh request
        self._zero_row = self._take_slot(self.cache, 0)
        # rid -> slot-state snapshot taken at preemption
        self._suspended: Dict[int, Any] = {}
        # exact-full-prompt snapshot cache: tuple(tokens) -> state that
        # has consumed tokens[:-1]; LRU-bounded, flushed on weight swap
        self.exact_prefix_capacity = 32 if self.prefix_sharing else 0
        self._exact: "OrderedDict[Tuple[int, ...], Any]" = OrderedDict()
        self.exact_prefix_hits = 0

    # -- slot plumbing -------------------------------------------------------
    def _take_slot(self, state, slot: int):
        """A copy of one slot's row of every leaf (never a view)."""
        return _tmap(lambda x, a: x.select(a, slot).clone(), state,
                     self._axes)

    def _put_slot(self, row, slot: int) -> None:
        _tmap(lambda x, r, a: x.select(a, slot).copy_(r), self.cache, row,
              self._axes)

    def snapshot_bytes(self) -> int:
        """Device bytes held by the preemption and exact-prompt
        snapshots."""
        rows = list(self._suspended.values()) + list(self._exact.values())
        return sum(t.numel() * t.element_size()
                   for row in rows for t in _leaves(row))

    # -- compute -------------------------------------------------------------
    @torch.no_grad()
    def _step_impl(self, params, tokens, positions, seeds, active):
        """One token for every slot; tokens/positions/seeds (max_batch,)
        int64, active (max_batch,) bool."""
        logits, new = M.decode_step(params, self.cfg, tokens[:, None],
                                    self.cache, positions)

        def keep(old, n, a):
            # inactive slots (no request, or one sitting the step out)
            # keep their state: the analogue of the trash page
            shape = [1] * old.dim()
            shape[a] = -1
            old.copy_(torch.where(active.view(shape), n, old))

        _tmap(keep, self.cache, new, self._axes)
        return self._sample_batch(logits[:, 0], seeds, positions)

    def step(self, params, tokens, positions, tables, seeds, active):
        return self._step_impl(
            params, self._to_device(tokens), self._to_device(positions),
            self._to_device(seeds), self._to_device(active, torch.bool))

    # -- lifecycle -----------------------------------------------------------
    def _store_exact(self, key: Tuple[int, ...], slot: int) -> None:
        if not self.exact_prefix_capacity:
            return
        self._exact[key] = self._take_slot(self.cache, slot)
        self._exact.move_to_end(key)
        while len(self._exact) > self.exact_prefix_capacity:
            self._exact.popitem(last=False)

    def on_admit(self, req: Request) -> int:
        snap = self._suspended.pop(req.rid, None)
        if snap is not None:
            # resumed after preemption: restore the snapshot; num_cached
            # survived requeueing, so decode continues at the frontier
            self._put_slot(snap, req.slot)
            return 0
        if req.generated or req.num_cached:
            # a mid-flight request without a snapshot cannot happen (the
            # scheduler only requeues via preempt); a fresh slot it is
            self._put_slot(self._zero_row, req.slot)
            req.num_cached = 0
            return 0
        key = tuple(req.prompt)
        hit = self._exact.get(key)
        if hit is not None:
            self._exact.move_to_end(key)
            self._put_slot(hit, req.slot)
            req.num_cached = req.prompt_len - 1
            self.exact_prefix_hits += 1
            return req.num_cached
        self._put_slot(self._zero_row, req.slot)
        return 0

    def on_preempt(self, req: Request) -> None:
        self._suspended[req.rid] = self._take_slot(self.cache, req.slot)

    def on_finish(self, req: Request, *, index_in_cache: bool) -> None:
        self._suspended.pop(req.rid, None)
        if index_in_cache and req.generated:
            # at finish the slot state has consumed prompt+generated[:-1]
            # (the final sampled token is never fed back), exactly the
            # invariant the exact-match cache stores
            self._store_exact(tuple(req.prompt + req.generated), req.slot)

    def on_weight_swap(self) -> None:
        # snapshots of running requests survive (in-flight semantics);
        # the exact-prefix cache holds old-weight state for future
        # requests and must drop, mirroring the radix-trie flush
        self._exact.clear()

    def rebind(self, device: DeviceLike,
               memo: Optional[Dict[int, torch.Tensor]] = None) -> None:
        """The cache, the zero row and every snapshot follow."""
        super().rebind(device)

        def move(tree):
            return to_device(tree, self.device, memo)

        self.cache = move(self.cache)
        self._zero_row = move(self._zero_row)
        self._suspended = {k: move(v) for k, v in self._suspended.items()}
        self._exact = OrderedDict((k, move(v)) for k, v in self._exact.items())

    def note_progress(self, req: Request) -> None:
        if (not req.generated and self.exact_prefix_capacity
                and req.num_cached == req.prompt_len - 1):
            key = tuple(req.prompt)
            if key not in self._exact:
                self._store_exact(key, req.slot)


# ===========================================================================
# Registry
# ===========================================================================
_LAYOUTS = {DENSE: PagedKVLayout, MOE: MoEPagedKVLayout}


def layout_class(cfg: ModelConfig):
    """The layout class serving ``cfg``, or None when uncovered (the port
    covers dense and MoE stacks without a sliding window, and SSM and
    hybrid stacks with or without one)."""
    if cfg.kind in (SSM, HYBRID):
        return StateCacheLayout
    if cfg.sliding_window:
        return None
    return _LAYOUTS.get(cfg.kind)


def covers(cfg: ModelConfig) -> bool:
    """True when the paged engine has a cache layout for ``cfg``."""
    return layout_class(cfg) is not None
