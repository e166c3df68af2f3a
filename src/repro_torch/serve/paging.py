"""Paged KV-cache: fixed-size blocks, per-request block tables, free-list,
ref-counted sharing, and a radix prefix index.

The production insight (vLLM's PagedAttention, HybridFlow's rollout tier)
is that a generation engine should never reserve ``max_seq_len`` of
contiguous KV memory per request: response lengths are long-tailed
(paper Fig. 2), so contiguous allocation strands most of the cache behind
the few longest responses.  Instead the cache is a pool of fixed-size
*pages*; each request owns a *block table* (list of page ids) that grows
one page at a time and is returned to the free list the moment the
request finishes — which is what lets a continuous-batching scheduler
backfill new prompts mid-stage.

On top of the pool this module layers *prefix sharing* (vLLM
automatic-prefix-caching / SGLang RadixAttention idiom): pages are
ref-counted, and a radix trie indexes computed pages by the token ids
they hold.  A new request whose prompt matches a cached chain adopts
those pages (incref) instead of re-prefilling them; a partially-matched
page is adopted copy-on-write; the trie holds one reference per indexed
page so finished requests leave their prefixes warm, and LRU leaf
eviction reclaims cache-only pages when the pool runs dry.

Three layers live here:

* :class:`PageAllocator` — host-side free-list + refcount bookkeeping
  (pure Python, runs in the scheduler loop).  It also
  tracks a per-page *computed watermark*: how many rows of the page hold
  valid KV, which is what lets a follower request fast-forward past a
  shared prefix another request is still prefilling.
* :class:`PrefixCache` — the radix trie over token-id page blocks.
* :class:`PagedKVCache` — the device-side page pool, one K and one V
  array of shape ``(layers, num_pages, page_size, kv_heads, head_dim)``.
  Page 0 is reserved as a *trash page*: inactive decode slots point their
  block tables at it so the fixed-shape step can scatter
  unconditionally without corrupting live requests.

The host half is a copy of the JAX package's ``serve/paging.py``; the
device half holds torch tensors.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

# page id 0 is never handed out: it absorbs writes from inactive slots
TRASH_PAGE = 0


class OutOfPages(Exception):
    """The free list is exhausted — the scheduler must stop admitting."""


class PageAccountingError(Exception):
    """Page refcount bookkeeping went negative: a double free, or a free
    of a page that was never allocated.  Raised instead of silently
    re-entering the free list (which would hand one page to two
    requests and corrupt both KV streams)."""


@dataclass
class PageAllocator:
    """Free-list allocator over ``num_pages`` fixed-size ref-counted pages.

    Page ids are ints in ``[1, num_pages)`` (0 is the trash page).  The
    free list is LIFO so recently-freed (cache-warm) pages are reused
    first.  :meth:`allocate` hands out pages at refcount 1; sharers
    (prefix-cache hits, the trie's own index reference) call
    :meth:`incref`; :meth:`free` decrements and only returns a page to
    the free list when its count reaches zero.
    """

    num_pages: int
    page_size: int
    _free: List[int] = field(default_factory=list)
    _refs: Dict[int, int] = field(default_factory=dict)
    # rows of each live page holding valid (computed) KV — the watermark
    # a follower request may fast-forward through without recomputing
    _computed: Dict[int, int] = field(default_factory=dict)
    # monotonic: total pages ever handed out by allocate() (NOT incref);
    # the prefix-sharing accounting tests assert on this
    pages_allocated_total: int = 0

    def __post_init__(self):
        assert self.num_pages >= 2, "need >= 1 usable page + trash page"
        assert self.page_size >= 1
        self._free = list(range(self.num_pages - 1, TRASH_PAGE, -1))

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        return len(self._refs)

    def pages_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.page_size)  # ceil

    def can_allocate(self, n: int) -> bool:
        return n <= len(self._free)

    def allocate(self, n: int = 1) -> List[int]:
        if n > len(self._free):
            raise OutOfPages(f"want {n} pages, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
            self._computed[p] = 0  # fresh page: no valid rows yet
        self.pages_allocated_total += n
        return out

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def incref(self, pages: Sequence[int]) -> None:
        """Adopt already-allocated pages (a prefix-cache hit, or the trie
        indexing a page).  Every incref must be balanced by a free()."""
        for p in pages:
            if self._refs.get(p, 0) <= 0:
                raise PageAccountingError(
                    f"incref of unallocated page {p}")
            self._refs[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; a page whose count reaches zero
        returns to the free list."""
        for p in pages:
            assert p != TRASH_PAGE and 0 < p < self.num_pages, p
            refs = self._refs.get(p, 0)
            if refs <= 0:
                raise PageAccountingError(f"double free of page {p}")
            if refs == 1:
                del self._refs[p]
                self._computed.pop(p, None)
                self._free.append(p)
            else:
                self._refs[p] = refs - 1

    # -- computed-row watermarks -------------------------------------------
    def note_computed(self, page: int, rows: int) -> None:
        """Record that the first ``rows`` rows of ``page`` hold valid KV.
        Monotone per page lifetime (reset when the page is reallocated)."""
        if self._refs.get(page, 0) > 0 and rows > self._computed.get(page, 0):
            self._computed[page] = min(rows, self.page_size)

    def computed_rows(self, page: int) -> int:
        return self._computed.get(page, 0)


# ===========================================================================
# Radix prefix index (vLLM prefix caching / SGLang RadixAttention idiom)
# ===========================================================================
class PrefixNode:
    """One page worth of tokens in the radix trie.

    ``key`` is the tuple of token ids the page's rows hold.  Internal
    nodes always cover a *full* page (``len(key) == page_size``); a node
    with fewer tokens is a partial leaf — matched copy-on-write, never
    descended through.  ``writer`` is the rid of the request currently
    prefilling this page (followers wait on it instead of duplicating
    the compute); it is cleared when the writer finishes or is
    preempted.
    """

    __slots__ = ("key", "page", "parent", "children", "last_used",
                 "writer")

    def __init__(self, key: Tuple[int, ...], page: int,
                 parent: Optional["PrefixNode"]):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], PrefixNode] = {}
        self.last_used = 0
        self.writer: Optional[int] = None

    @property
    def num_tokens(self) -> int:
        return len(self.key)


class PrefixMatch(NamedTuple):
    """Result of :meth:`PrefixCache.lookup`.

    ``nodes`` are the fully-matched full-page nodes, in chain order
    (their pages can be adopted outright).  ``partial`` is the deepest
    child sharing ``partial_rows`` leading tokens with the remaining
    prompt — a copy-on-write candidate — or None.
    """

    nodes: List[PrefixNode]
    partial: Optional[PrefixNode]
    partial_rows: int

    @property
    def full_tokens(self) -> int:
        return sum(n.num_tokens for n in self.nodes)


class PrefixCache:
    """Radix trie over token-id page blocks.

    Each node indexes exactly one page and holds one allocator reference
    on it, so indexed pages survive their writer finishing — that
    retention is what makes a GRPO group's shared prompt (or a
    deep-research episode's growing history) prefill once.  When the
    pool runs dry, :meth:`evict` walks leaves least-recently-used first
    and drops pages nobody else references.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = PrefixNode((), -1, None)
        self._clock = itertools.count(1)
        self._nodes = 0
        # rid -> nodes that request is responsible for prefilling
        self._writers: Dict[int, List[PrefixNode]] = {}
        # monotonic stats (cheap; surfaced by obs metrics)
        self.hits = 0
        self.evictions = 0

    @property
    def num_pages(self) -> int:
        """Pages currently indexed (== trie nodes == cache-held refs)."""
        return self._nodes

    # -- lookup --------------------------------------------------------------
    def lookup(self, tokens: Sequence[int]) -> PrefixMatch:
        """Longest cached prefix of ``tokens``: full-page chain plus an
        optional partial (copy-on-write) boundary node.  Touches the
        matched chain's LRU stamps."""
        now = next(self._clock)
        node = self.root
        nodes: List[PrefixNode] = []
        i = 0
        psz = self.page_size
        while len(tokens) - i >= 1:
            child = node.children.get(tuple(tokens[i:i + psz]))
            if child is None or child.num_tokens < psz:
                break
            child.last_used = now
            nodes.append(child)
            node = child
            i += psz
        # boundary: the child sharing the most leading tokens with the
        # remaining prompt donates those rows copy-on-write
        best, best_rows = None, 0
        rest = tokens[i:]
        for child in node.children.values():
            rows = 0
            for a, b in zip(child.key, rest):
                if a != b:
                    break
                rows += 1
            if rows > best_rows:
                best, best_rows = child, rows
        if best is not None:
            best.last_used = now
        if nodes or best is not None:
            self.hits += 1
        return PrefixMatch(nodes, best, best_rows)

    # -- insertion -------------------------------------------------------------
    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               allocator: PageAllocator, *, start: int = 0,
               writer: Optional[int] = None) -> List[PrefixNode]:
        """Index ``tokens[start:]`` under the chain covering
        ``tokens[:start]`` (``start`` must be page-aligned).  ``pages``
        is the owning request's full block table; each new node increfs
        its page (the cache's own reference).  Returns the nodes created
        (the ones ``writer`` is responsible for computing)."""
        psz = self.page_size
        assert start % psz == 0, start
        now = next(self._clock)
        # re-walk to the start boundary (caller matched these already)
        node = self.root
        for i in range(0, start, psz):
            node = node.children[tuple(tokens[i:i + psz])]
        created: List[PrefixNode] = []
        for i in range(start, len(tokens), psz):
            key = tuple(tokens[i:i + psz])
            existing = node.children.get(key)
            if existing is not None and existing.num_tokens == psz:
                node = existing  # already indexed (idempotent re-insert)
                continue
            if existing is not None:
                # same key already present as a partial leaf of another
                # page — keep the old one, don't shadow it
                break
            page = int(pages[i // psz])
            grown = self._regrow(node, key, page, now)
            if grown is not None:
                # the page was already indexed by a shorter partial leaf
                # (left at admission, before decode filled more rows) —
                # re-keying it in place keeps one node per page, so the
                # cache holds exactly one reference and eviction still
                # sees refcount 1 once every request lets go
                if grown.num_tokens < psz:
                    break
                node = grown
                continue
            child = PrefixNode(key, page, node)
            child.last_used = now
            child.writer = writer
            allocator.incref([child.page])
            node.children[key] = child
            created.append(child)
            self._nodes += 1
            if len(key) < psz:
                break  # partial tail is always a leaf
            node = child
        if writer is not None and created:
            self._writers.setdefault(writer, []).extend(created)
        return created

    def _regrow(self, node: PrefixNode, key: Tuple[int, ...], page: int,
                now: int) -> Optional[PrefixNode]:
        """If ``page`` is already indexed under ``node`` as a partial leaf
        whose key is a prefix of ``key`` (or an extension of it), return
        that node — re-keyed to the longer of the two — instead of letting
        the caller create a second node for the same physical page."""
        for child in node.children.values():
            if child.page != page:
                continue
            short, long_ = sorted((child.key, key), key=len)
            if long_[:len(short)] != short:
                return None  # same page, diverged content: caller creates
            if child.key != long_:
                del node.children[child.key]
                child.key = long_
                node.children[long_] = child
            child.last_used = now
            return child
        return None

    # -- writer lifecycle -----------------------------------------------------
    def release_writer(self, rid: int) -> None:
        """The prefilling request finished or was preempted: followers
        blocked on its nodes fall back to computing the rows themselves
        (or fast-forward, if the watermark already covers them)."""
        for node in self._writers.pop(rid, ()):
            if node.writer == rid:
                node.writer = None

    # -- eviction ---------------------------------------------------------------
    def evict(self, need: int, allocator: PageAllocator) -> int:
        """Free up to ``need`` cache-only pages, least-recently-used
        leaves first.  A page some request still references
        (refcount > 1) or that is still being written is never dropped.
        Returns the number of pages actually freed."""
        freed = 0
        while freed < need:
            victim = None
            for node in self._iter_leaves():
                if allocator.refcount(node.page) > 1:
                    continue  # pinned by a running request
                if node.writer is not None:
                    continue
                if victim is None or node.last_used < victim.last_used:
                    victim = node
            if victim is None:
                break
            self._remove(victim, allocator)
            freed += 1
            self.evictions += 1
        return freed

    def flush(self, allocator: PageAllocator) -> int:
        """Drop the whole index (weight swap: cached KV is stale).  Pages
        running requests still hold survive via their own references."""
        dropped = 0
        # post-order: children before parents
        stack = [(self.root, False)]
        while stack:
            node, seen = stack.pop()
            if not seen:
                stack.append((node, True))
                stack.extend((c, False) for c in node.children.values())
                continue
            if node is self.root:
                continue
            node.writer = None  # nobody waits on a detached node
            allocator.free([node.page])
            dropped += 1
        self.root = PrefixNode((), -1, None)
        self._nodes = 0
        self._writers.clear()
        return dropped

    def _iter_leaves(self):
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node is not self.root and not node.children:
                yield node
            stack.extend(node.children.values())

    def _remove(self, node: PrefixNode, allocator: PageAllocator) -> None:
        assert not node.children, "evict leaves only"
        del node.parent.children[node.key]
        allocator.free([node.page])  # the cache's own reference
        self._nodes -= 1


class PagedKVCache(NamedTuple):
    """Device-side page pool shared by every request on the engine.

    k/v: (num_layers, num_pages, page_size, kv_heads, head_dim).  The
    layouts update them in place (``index_put_``), where the JAX package
    donates the buffers to the jitted step.
    """

    k: torch.Tensor
    v: torch.Tensor

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def page_size(self) -> int:
        return self.k.shape[2]


def init_paged_cache(num_layers: int, num_pages: int, page_size: int,
                     kv_heads: int, head_dim: int, dtype=torch.float32,
                     device: DeviceLike = None) -> PagedKVCache:
    """A zeroed pool on ``device`` (the card by default)."""
    shape = (num_layers, num_pages, page_size, kv_heads, head_dim)
    device = resolve_device(device)
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                        v=torch.zeros(shape, dtype=dtype, device=device))


def pad_block_table(pages: List[int], max_blocks: int) -> List[int]:
    """Fixed-width row for the fixed-shape step; padding points at the trash
    page (reads there are masked by the context length)."""
    assert len(pages) <= max_blocks, (len(pages), max_blocks)
    return pages + [TRASH_PAGE] * (max_blocks - len(pages))
