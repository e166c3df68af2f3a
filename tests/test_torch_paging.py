"""Host-side copies in the port (page allocator, continuous-batching
scheduler, radix prefix cache), held to the contracts the JAX package's
``tests/test_serve.py`` sets for the originals."""
import pytest

from repro_torch.serve import (OutOfPages, PageAccountingError,
                               PageAllocator, PrefixCache)
from repro_torch.serve.paging import TRASH_PAGE, pad_block_table
from repro_torch.serve.scheduler import ContinuousScheduler


# ---------------------------------------------------------------------------
# page allocator
# ---------------------------------------------------------------------------
def test_allocator_never_hands_out_trash_page():
    a = PageAllocator(num_pages=8, page_size=4)
    got = a.allocate(7)
    assert TRASH_PAGE not in got
    assert sorted(got) == list(range(1, 8))


def test_allocator_free_list_reuse_and_exhaustion():
    a = PageAllocator(num_pages=6, page_size=4)
    first = a.allocate(3)
    assert a.num_free == 2
    a.free(first)
    assert a.num_free == 5
    again = a.allocate(5)
    assert set(first) <= set(again)  # freed pages are recycled
    with pytest.raises(OutOfPages):
        a.allocate(1)


def test_allocator_refcount_lifecycle_and_accounting_errors():
    a = PageAllocator(num_pages=4, page_size=2)
    (p,) = a.allocate(1)
    a.incref([p])           # a sharer adopts the page
    assert a.refcount(p) == 2
    a.free([p])             # first owner drops out
    assert a.refcount(p) == 1 and a.num_free == 2
    a.free([p])             # last reference: physically freed
    assert a.refcount(p) == 0 and a.num_free == 3
    with pytest.raises(PageAccountingError):
        a.incref([p])       # incref of an unallocated page is a bug
    with pytest.raises(PageAccountingError):
        a.free([p])         # double free: never re-enters the free list
    assert a.num_free == 3


@pytest.mark.parametrize("tokens,pages", [(1, 1), (8, 1), (9, 2), (17, 3)])
def test_pages_needed_is_ceil_div(tokens, pages):
    assert PageAllocator(num_pages=4, page_size=8).pages_needed(tokens) == \
        pages


def test_computed_watermark_is_monotone_and_reset_on_reuse():
    a = PageAllocator(num_pages=4, page_size=4)
    (p,) = a.allocate(1)
    a.note_computed(p, 3)
    a.note_computed(p, 2)   # never moves back
    a.note_computed(p, 9)   # capped at the page size
    assert a.computed_rows(p) == 4
    a.free([p])
    (q,) = a.allocate(1)
    assert q == p and a.computed_rows(q) == 0


def test_pad_block_table_pads_with_trash():
    assert pad_block_table([3, 5], 4) == [3, 5, TRASH_PAGE, TRASH_PAGE]


# ---------------------------------------------------------------------------
# continuous-batching scheduler
# ---------------------------------------------------------------------------
def _sched(max_batch=2, num_pages=9, page_size=4, max_seq=16):
    alloc = PageAllocator(num_pages=num_pages, page_size=page_size)
    return ContinuousScheduler(max_batch=max_batch, allocator=alloc,
                               max_seq_len=max_seq)


def test_scheduler_admits_fifo_up_to_slots():
    s = _sched(max_batch=2)
    r1 = s.submit([1, 2, 3], 4)
    r2 = s.submit([1, 2], 4)
    r3 = s.submit([9], 4)
    joined = s.admit()
    assert [r.rid for r in joined] == [r1.rid, r2.rid]
    assert r3.state == "queued" and s.num_active == 2


def test_scheduler_backfills_freed_slot_and_pages():
    s = _sched(max_batch=1, num_pages=3, page_size=4)
    r1 = s.submit([1, 2, 3], 2)
    r2 = s.submit([4, 5], 2)
    (a,) = s.admit()
    assert a is r1 and s.allocator.num_free == 1
    assert not s.admit()  # no slot free
    s.finish(r1)  # evict: pages back on the free list immediately
    assert s.allocator.num_free == 2 and r1.pages == []
    (b,) = s.admit()
    assert b is r2 and r2.slot == 0  # freed slot reused


def test_scheduler_blocks_admission_on_page_budget():
    # 2 slots but pages for only one prompt at a time
    s = _sched(max_batch=2, num_pages=3, page_size=2, max_seq=8)
    s.submit([1, 2, 3], 2)  # needs ceil(4/2)=2 pages
    s.submit([1, 2, 3], 2)
    assert len(s.admit()) == 1  # second must wait for pages, not slots


def test_scheduler_grows_block_table_and_preempts_to_queue_head():
    s = _sched(max_batch=2, num_pages=9, page_size=2, max_seq=16)
    r = s.submit([1, 2, 3], 8)
    other = s.submit([4], 8)
    s.admit()
    npages = len(r.pages)
    r.num_cached = npages * 2  # simulate filling every allocated slot
    s.ensure_page_for(r)
    assert len(r.pages) == npages + 1
    r.generated = [7]
    s.preempt(r)  # recompute preemption: pages dropped, head of queue
    assert r.state == "queued" and r.num_cached == 0 and r.pages == []
    assert s.waiting[0] is r and s.num_active == 1
    assert other.state == "running"


# ---------------------------------------------------------------------------
# prefix cache: radix trie over page-aligned token blocks
# ---------------------------------------------------------------------------
def test_prefix_cache_insert_lookup_roundtrip():
    a = PageAllocator(num_pages=16, page_size=4)
    c = PrefixCache(page_size=4)
    toks = list(range(10))  # 2 full pages + a 2-token partial leaf
    pages = a.allocate(3)
    c.insert(toks, pages, a)
    assert c.num_pages == 3
    # the trie holds one reference per indexed page (owner + cache)
    assert all(a.refcount(p) == 2 for p in pages)
    m = c.lookup(toks)
    assert [n.page for n in m.nodes] == pages[:2]
    assert m.partial is not None and m.partial.page == pages[2]
    assert m.partial_rows == 2
    # a prompt diverging after the full pages matches only those
    m2 = c.lookup(toks[:8] + [99, 98])
    assert [n.page for n in m2.nodes] == pages[:2]
    assert m2.partial is None and m2.partial_rows == 0


def test_prefix_cache_cow_candidate_from_full_page_head():
    a = PageAllocator(num_pages=8, page_size=4)
    c = PrefixCache(page_size=4)
    pages = a.allocate(1)
    c.insert([0, 1, 2, 3], pages, a)
    m = c.lookup([0, 1, 2, 99, 100])
    assert m.nodes == [] and m.partial is not None
    assert m.partial.page == pages[0] and m.partial_rows == 3


def test_prefix_cache_evicts_lru_leaves_first():
    a = PageAllocator(num_pages=16, page_size=2)
    c = PrefixCache(page_size=2)
    pa = a.allocate(2)
    pb = a.allocate(1)
    c.insert([0, 1, 2, 3], pa, a)
    c.insert([9, 9], pb, a)
    a.free(pa + pb)  # owners finished: only the cache's refs remain
    assert a.num_allocated == 3
    c.lookup([0, 1, 2, 3])  # touch chain A -> chain B becomes LRU
    assert c.evict(1, a) == 1
    assert c.num_pages == 2 and a.refcount(pb[0]) == 0
    # next eviction takes chain A's leaf; the parent is not a leaf yet
    assert c.evict(1, a) == 1
    assert a.refcount(pa[1]) == 0 and a.refcount(pa[0]) == 1
    # the parent became a leaf; asking for more than exists is bounded
    assert c.evict(5, a) == 1
    assert c.num_pages == 0 and a.num_allocated == 0


def test_prefix_cache_eviction_refuses_shared_and_writing_pages():
    a = PageAllocator(num_pages=8, page_size=2)
    c = PrefixCache(page_size=2)
    mine = a.allocate(1)
    c.insert([5, 6], mine, a)  # rc 2: running request + cache
    assert c.evict(1, a) == 0  # pinned by the running request
    theirs = a.allocate(1)
    c.insert([7, 8], theirs, a, writer=42)
    a.free(mine + theirs)  # both owners drop their refs
    # the page still being prefilled (writer attached) is not evictable
    assert c.evict(2, a) == 1
    assert a.refcount(theirs[0]) == 1 and a.refcount(mine[0]) == 0
    c.release_writer(42)
    assert c.evict(2, a) == 1
    assert c.num_pages == 0 and a.num_allocated == 0


def test_prefix_cache_flush_releases_everything():
    a = PageAllocator(num_pages=8, page_size=2)
    c = PrefixCache(page_size=2)
    pgs = a.allocate(3)
    c.insert([0, 1, 2, 3, 4], pgs, a, writer=7)
    a.free(pgs)
    assert a.num_allocated == 3
    assert c.flush(a) == 3
    assert c.num_pages == 0 and a.num_allocated == 0
    m = c.lookup([0, 1, 2, 3])
    assert not m.nodes and m.partial is None


def test_prefix_cache_regrows_a_partial_leaf_in_place():
    """Re-inserting a longer run of the same page keeps ONE node per
    physical page (one cache reference), so eviction still frees it."""
    a = PageAllocator(num_pages=8, page_size=4)
    c = PrefixCache(page_size=4)
    pages = a.allocate(1)
    c.insert([1, 2], pages, a)           # partial leaf at admission
    c.insert([1, 2, 3, 4], pages, a)     # decode filled the page
    assert c.num_pages == 1 and a.refcount(pages[0]) == 2
    assert [n.page for n in c.lookup([1, 2, 3, 4]).nodes] == pages
    a.free(pages)
    assert c.evict(1, a) == 1 and a.num_allocated == 0
