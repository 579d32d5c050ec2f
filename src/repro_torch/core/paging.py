"""Paged KV-cache substrate: page pool with refcounts, block tables, prefix index.

The port's own copy of ``repro.core.paging`` (numpy and ``zlib`` only), so the
serving path imports nothing of the JAX package.

The serving engine's KV memory is one flat page pool per layer —
``(npage, page_size, kv_heads, head_dim)``, the KV twin of the flat
``(nblk, 1024)`` gradient layout in ``core/flat.py`` — plus ONE block
table shared by every layer: request r's token t lives in page
``table[r, t // page_size]`` at row ``t % page_size`` of every layer's
pool. This module owns the *host-side* bookkeeping (allocation is a
scheduling decision, not a device computation):

* :class:`PagedLayout` — the static geometry (pool size, page size, block
  table width, decode-slot count). Page 0 is the reserved **null page**:
  the free list never hands it out, every empty block-table entry points
  at it, idle decode slots write their garbage k/v there — and it is never
  refcounted, so the sharing machinery can never free or alias it.
* :class:`PagePool` — LIFO free list over pages ``1..npage-1`` with
  per-page **refcounts** for copy-on-write prefix sharing: :meth:`alloc`
  hands out pages at refcount 1, :meth:`fork` adds a reference when a new
  block-table row maps an existing page, :meth:`release` drops one and
  reclaims the page at zero. Every allocation bumps the page's **epoch**,
  so a stale pointer into a freed-and-reissued page is detectable
  (:class:`PrefixIndex` validates its entries this way). The
  :meth:`check_conservation` audit also cross-checks the block tables:
  a free-list page referenced by any table row, or a refcount that does
  not equal the number of rows referencing the page, is corruption.
* :class:`BlockTables` — the ``(n_slots, max_pages)`` int32 host mirror
  that is shipped to the device each step (it changes with request churn;
  the pool itself stays on the device).
* :class:`PrefixIndex` — a chain-hash index over prompt pages: full pages
  key on (parent digest, page tokens); the final partial page registers
  its exact token content so an identical or extending prompt can map it
  too (the first write into a shared page COW-splits it). Entries are
  *weak*: they hold no reference, and a lookup whose (page, epoch) no
  longer matches the pool is dropped — the cache lives exactly as long as
  some block-table row keeps the pages alive.

DESIGN.md §8 is the contract; ``launch/scheduler.py`` drives admission,
COW, and preemption; ``models/model.py::paged_decode_step`` consumes the
arrays.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: the reserved trash page: never allocated, refcounted, or freed
NULL_PAGE = 0


class PoolExhausted(RuntimeError):
    """Raised when an allocation asks for more pages than are free."""


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static geometry of the paged KV cache.

    npage:      total pages in the pool, including the reserved null page 0
    page_size:  tokens per page (the KV-pool analogue of the flat block width)
    max_pages:  block-table width — the per-request page budget, so a request
                may hold at most ``max_pages * page_size`` tokens
    n_slots:    decode batch width (concurrent requests in flight)
    """

    npage: int
    page_size: int
    max_pages: int
    n_slots: int

    def __post_init__(self):
        if self.npage < 2:
            raise ValueError("pool needs the null page plus at least one usable page")
        if self.page_size < 1 or self.max_pages < 1 or self.n_slots < 1:
            raise ValueError(f"degenerate layout {self}")

    @property
    def usable_pages(self) -> int:
        """Allocatable pages (the null page is never handed out)."""
        return self.npage - 1

    @property
    def max_len(self) -> int:
        """Longest sequence one block-table row can address."""
        return self.max_pages * self.page_size

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` tokens."""
        return -(-int(n_tokens) // self.page_size)


class PagePool:
    """LIFO free-list allocator over pages ``1..npage-1`` with refcounts.

    LIFO keeps recently-freed (still cache-warm) pages hot. Every page is
    either on the free list or referenced by ≥1 holder; prefix sharing
    aliases one physical page into several block-table rows via
    :meth:`fork` (refcount++), and :meth:`release` drops a reference,
    reclaiming the page when the count hits zero. :meth:`free` is the
    strict exclusive path (rejects shared pages, double-frees, and
    never-allocated ids). :meth:`check_conservation` asserts the
    invariants the scheduler and fuzz tests rely on:
    ``n_free + n_allocated == usable_pages`` with no overlap, refcounts
    positive exactly on allocated pages — and, when the block tables are
    passed, no free-list page referenced by any row and every refcount
    equal to the number of rows referencing that page.
    """

    def __init__(self, layout: PagedLayout):
        self.layout = layout
        self._free: List[int] = list(range(layout.npage - 1, 0, -1))
        self._allocated: set = set()
        self._ref: Dict[int, int] = {}
        # bumped on every alloc of the page: stale pointers (a PrefixIndex
        # entry outliving its page) are detected by epoch mismatch
        self._epoch: Dict[int, int] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_allocated(self) -> int:
        return len(self._allocated)

    def refcount(self, page: int) -> int:
        """References held on ``page`` (0 when free or never allocated)."""
        return self._ref.get(page, 0)

    def epoch(self, page: int) -> int:
        """Allocation generation of ``page`` (bumped each time it is handed
        out), for validating weak pointers like PrefixIndex entries."""
        return self._epoch.get(page, 0)

    def alloc(self, k: int) -> List[int]:
        """Pop ``k`` pages off the free list (all-or-nothing, refcount 1)."""
        if k < 0:
            raise ValueError(f"cannot allocate {k} pages")
        if k > len(self._free):
            raise PoolExhausted(
                f"asked for {k} pages with {len(self._free)} free "
                f"(pool of {self.layout.usable_pages})"
            )
        pages = [self._free.pop() for _ in range(k)]
        self._allocated.update(pages)
        for p in pages:
            self._ref[p] = 1
            self._epoch[p] = self._epoch.get(p, 0) + 1
        return pages

    def fork(self, page: int) -> int:
        """Add a reference to an allocated page (a new block-table row maps
        it); returns the new refcount. The null page is never refcounted."""
        if page == NULL_PAGE:
            raise ValueError("the null page is never forked")
        if page not in self._allocated:
            raise ValueError(f"page {page} is not allocated (fork of a free page?)")
        self._ref[page] += 1
        return self._ref[page]

    def release(self, page: int) -> int:
        """Drop one reference; at zero the page returns to the free list.
        Returns the remaining refcount."""
        if page == NULL_PAGE:
            raise ValueError("the null page is never allocated or freed")
        if page not in self._allocated:
            raise ValueError(f"page {page} is not allocated (double free?)")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            del self._ref[page]
            self._allocated.remove(page)
            self._free.append(page)
            return 0
        return self._ref[page]

    def free(self, pages: Sequence[int]) -> None:
        """Exclusive free: every page must be held exactly once (shared pages
        must go through :meth:`release`); double/foreign frees raise."""
        for p in pages:
            if p == NULL_PAGE:
                raise ValueError("the null page is never allocated or freed")
            if p not in self._allocated:
                raise ValueError(f"page {p} is not allocated (double free?)")
            if self._ref.get(p, 0) != 1:
                raise ValueError(
                    f"page {p} has refcount {self._ref.get(p, 0)}; free() is "
                    "the exclusive-owner path, shared pages use release()"
                )
        for p in pages:
            del self._ref[p]
            self._allocated.remove(p)
            self._free.append(p)

    def check_conservation(self, tables: Optional["BlockTables"] = None) -> None:
        """Every usable page is free xor allocated, exactly once; refcounts
        are positive exactly on allocated pages. With ``tables``: no
        free-list page is referenced by any block-table row, and each
        allocated page's refcount equals the number of rows referencing it
        (the COW/sharing invariant the fuzz harness drives)."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("free list holds a duplicate page")
        if free & self._allocated:
            raise AssertionError(
                f"pages both free and allocated: {sorted(free & self._allocated)}"
            )
        union = free | self._allocated
        expect = set(range(1, self.layout.npage))
        if union != expect:
            raise AssertionError(
                f"page leak: missing {sorted(expect - union)}, "
                f"foreign {sorted(union - expect)}"
            )
        if set(self._ref) != self._allocated:
            raise AssertionError(
                f"refcount keys drifted from the allocated set: "
                f"extra {sorted(set(self._ref) - self._allocated)}, "
                f"missing {sorted(self._allocated - set(self._ref))}"
            )
        bad = {p: c for p, c in self._ref.items() if c < 1}
        if bad:
            raise AssertionError(f"non-positive refcounts on allocated pages: {bad}")
        if tables is not None:
            refs = tables.reference_counts()
            if NULL_PAGE in refs:
                del refs[NULL_PAGE]
            still_referenced = free & set(refs)
            if still_referenced:
                raise AssertionError(
                    f"free-list pages still referenced by block-table rows: "
                    f"{sorted(still_referenced)}"
                )
            if refs != dict(self._ref):
                drift = {
                    p: (self._ref.get(p, 0), refs.get(p, 0))
                    for p in set(refs) | set(self._ref)
                    if self._ref.get(p, 0) != refs.get(p, 0)
                }
                raise AssertionError(
                    "refcounts != block-table references (page: pool, table): "
                    f"{drift}"
                )


class BlockTables:
    """Host mirror of the device block tables: ``(n_slots, max_pages)`` int32.

    Empty entries hold :data:`NULL_PAGE`; :meth:`assign` fills a slot's row
    with its allocated pages in order, :meth:`set_entry` rewrites one entry
    (the COW-split and lazy-allocation paths), :meth:`clear` nulls it on
    eviction. ``array`` is the value shipped to the device step each
    iteration.
    """

    def __init__(self, layout: PagedLayout):
        self.layout = layout
        self._table = np.full(
            (layout.n_slots, layout.max_pages), NULL_PAGE, dtype=np.int32
        )

    def assign(self, slot: int, pages: Sequence[int]) -> None:
        if len(pages) > self.layout.max_pages:
            raise ValueError(
                f"{len(pages)} pages exceed the block-table width "
                f"{self.layout.max_pages}"
            )
        self._table[slot] = NULL_PAGE
        self._table[slot, : len(pages)] = np.asarray(pages, np.int32)

    def set_entry(self, slot: int, idx: int, page: int) -> None:
        """Point one (slot, page-index) entry at a physical page — the COW
        split (shared → private copy) and lazy decode-page allocation both
        land here."""
        self._table[slot, idx] = np.int32(page)

    def clear(self, slot: int) -> None:
        self._table[slot] = NULL_PAGE

    def row(self, slot: int) -> np.ndarray:
        return self._table[slot].copy()

    def reference_counts(self) -> Dict[int, int]:
        """{page id: number of table entries referencing it} over non-null
        entries — what PagePool.check_conservation audits refcounts against."""
        ids, counts = np.unique(self._table, return_counts=True)
        return {
            int(p): int(c) for p, c in zip(ids, counts) if int(p) != NULL_PAGE
        }

    @property
    def array(self) -> np.ndarray:
        """The current (n_slots, max_pages) int32 table (a defensive copy)."""
        return self._table.copy()


def _chunk_digest(parent: int, tokens: np.ndarray) -> int:
    """crc32 chain over page-sized token chunks: stable across processes (no
    PYTHONHASHSEED dependence), cheap, and collisions are harmless because
    every hit is verified against the exact stored token content."""
    return zlib.crc32(
        np.asarray(tokens, np.int32).tobytes(), parent & 0xFFFFFFFF
    )


@dataclasses.dataclass
class _PrefixEntry:
    page: int
    epoch: int
    tokens: Tuple[int, ...]  # exact content — digest hits are verified


class PrefixIndex:
    """Weak chain-hash index from prompt-page content to physical pages.

    Full prompt pages register under the digest chain
    ``d_i = crc32(tokens[iP:(i+1)P], d_{i-1})``; the final *partial* page
    (when the prompt is not page-aligned) registers its exact content under
    its parent digest, so a new prompt that extends a cached one can map
    the partial page too and COW-split it on first write. Entries hold NO
    pool reference: :meth:`match` validates each hit against the pool's
    (allocated, epoch) state and silently drops stale entries — the prefix
    cache lives exactly as long as some block-table row keeps its pages
    alive (the fuzz invariant "refcount == table references" stays exact).
    """

    def __init__(self, layout: PagedLayout):
        self.layout = layout
        # digest -> candidate entries: several live requests may each hold a
        # private copy of the same content (they were admitted before anyone
        # registered), and any one of them can serve as the donor — keeping
        # them all means the cache survives the earliest donor completing
        self._full: Dict[int, List[_PrefixEntry]] = {}
        # parent digest -> partial-page entries (longest-prefix match wins)
        self._partial: Dict[int, List[_PrefixEntry]] = {}

    def _valid(self, pool: PagePool, e: _PrefixEntry) -> bool:
        return (
            pool.refcount(e.page) > 0 and pool.epoch(e.page) == e.epoch
        )

    def match(
        self, pool: PagePool, prompt: np.ndarray, max_tokens: int
    ) -> Tuple[List[int], int]:
        """Longest cached prefix of ``prompt`` still live in the pool.

        Returns ``(pages, n_tokens)`` — the physical pages covering the
        first ``n_tokens`` prompt tokens (full pages, possibly plus one
        partial page), capped at ``max_tokens`` so the caller can force the
        final prompt position through prefill (its logits seed the first
        generated token). The caller forks each returned page. Stale
        entries encountered on the walk are pruned."""
        P = self.layout.page_size
        prompt = np.asarray(prompt, np.int32)
        pages: List[int] = []
        matched = 0
        parent = 0
        while matched + P <= min(len(prompt), max_tokens):
            chunk = prompt[matched:matched + P]
            d = _chunk_digest(parent, chunk)
            cands = self._full.get(d, [])
            live = [e for e in cands if self._valid(pool, e)]
            if len(live) != len(cands):
                if live:
                    self._full[d] = live
                else:
                    self._full.pop(d, None)
            want = tuple(int(t) for t in chunk)
            hit = next((e for e in live if e.tokens == want), None)
            if hit is None:
                break
            pages.append(hit.page)
            matched += P
            parent = d
        # the final partial page: longest registered content that is a
        # prefix of the remaining prompt tokens
        remaining = prompt[matched:min(len(prompt), max_tokens)]
        cands = self._partial.get(parent, [])
        live = [e for e in cands if self._valid(pool, e)]
        if len(live) != len(cands):
            self._partial[parent] = live
        best = None
        for e in live:
            n = len(e.tokens)
            if 0 < n <= len(remaining) and tuple(
                int(t) for t in remaining[:n]
            ) == e.tokens:
                if best is None or n > len(best.tokens):
                    best = e
        if best is not None:
            pages.append(best.page)
            matched += len(best.tokens)
        return pages, matched

    def register(
        self, pool: PagePool, prompt: np.ndarray, pages: Sequence[int]
    ) -> None:
        """Publish a fully-prefilled prompt's pages: one full-page entry per
        complete chunk, plus a partial entry for the tail. ``pages`` is the
        block-table row prefix covering the prompt (physical ids in logical
        order). Stale entries are pruned; live duplicates of the same page
        are not re-added (a follower that forked the donor's pages registers
        the very same ids)."""
        P = self.layout.page_size
        prompt = np.asarray(prompt, np.int32)
        parent = 0
        for i, page in enumerate(pages):
            lo = i * P
            hi = min(lo + P, len(prompt))
            tokens = tuple(int(t) for t in prompt[lo:hi])
            if page == NULL_PAGE or pool.refcount(page) == 0:
                break
            entry = _PrefixEntry(page=page, epoch=pool.epoch(page), tokens=tokens)
            if hi - lo == P:
                d = _chunk_digest(parent, prompt[lo:hi])
                bucket = self._full.setdefault(d, [])
                bucket[:] = [e for e in bucket if self._valid(pool, e)]
                if not any(
                    e.page == page and e.epoch == entry.epoch for e in bucket
                ):
                    bucket.append(entry)
                parent = d
            else:
                bucket = self._partial.setdefault(parent, [])
                bucket[:] = [
                    e for e in bucket
                    if self._valid(pool, e)
                    and not (e.page == page and e.epoch == entry.epoch)
                ] + [entry]
                break
