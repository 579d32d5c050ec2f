"""Continuous-batching scheduler over the paged KV pool (DESIGN.md §8).

The port's own copy of ``repro.launch.scheduler`` (numpy only): the
bookkeeping is host-side and identical; only the step functions it drives
(``launch/serve.py``) run PyTorch.

The scheduler owns the host-side bookkeeping: a FIFO admission queue, the
slot table, and the page pool / block tables / prefix index from
core/paging.py. Two admission policies:

* ``admission="reserve"`` — the PR-9 policy: a request is admitted only
  when a slot is free AND the pool can hand over every page it could ever
  touch (``ceil((prompt + max_new)/P)``), so an admitted request never
  hits mid-stream pool pressure. Safe, but a pool full of reservations
  for tokens that do not exist yet caps concurrency far below what the
  memory supports.
* ``admission="expected"`` (default) — admission is against the pages the
  request needs *now* (its unshared prompt pages); generation pages are
  allocated lazily as decode crosses page boundaries, and pool pressure
  is resolved by **preemption**: a victim's pages are swapped to a
  host-side store, released, and the victim re-queued at the head to
  resume later by re-mapping fresh pages. The victim policy never
  preempts the lowest-index occupied slot, so that request always runs
  to completion and frees its pages — no deadlock by construction (its
  worst-case demand is bounded by ``submit``'s checks).

**Prefix sharing (COW).** With ``share_prefix=True`` (requires
``admission="expected"``), admission consults the PrefixIndex: prompt
pages whose content is already resident are *forked* into the new row
(refcount++) instead of re-prefilled — aliasing is purely block-table
content, so the device path is untouched and bit-exact. Every write
(prefill chunk or decode token) first runs ``prepare_write``: a target
page that is still NULL is allocated lazily, and a target page with
refcount > 1 is **COW-split** — a fresh page is allocated, the engine
copies the old page's content on device, the row entry is repointed, and
the old page's refcount drops. The final prompt position is never mapped
from the index (``match`` is capped at ``prompt_len - 1``) because its
prefill logits seed the first generated token.

The engine turns the bookkeeping into dispatches: per iteration it joins
at most one prefill chunk (the longest-admitted unfinished prompt) into
the running batch and then runs ONE decode step over all slots — a single
dispatch over one cache regardless of how many requests are in flight. Slots that are idle or still prefilling ride along with a nulled
block-table row: their decode write lands in the reserved null page
(page 0) and their logits are ignored, so no masking is needed on the
device path.

Completion releases the request's pages (refcount--, freeing the
exclusive ones) and clears its slot, making room for the next admission —
requests join and leave the batch every step, which is exactly the
continuous-vs-static tokens/s win BENCH_serve measures.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.core.paging import (
    NULL_PAGE,
    BlockTables,
    PagePool,
    PagedLayout,
    PoolExhausted,
    PrefixIndex,
)


@dataclasses.dataclass
class Request:
    """One serving request: a prompt and a generation budget."""

    rid: int
    prompt: np.ndarray          # (prompt_len,) int32
    max_new: int                # tokens to generate (including the first)

    # engine bookkeeping (filled in as the request moves through the system)
    slot: int = -1
    prefill_done: int = 0       # prompt tokens already written to the cache
    shared_tokens: int = 0      # prompt tokens mapped from the prefix index
    generated: list = dataclasses.field(default_factory=list)
    registered: bool = False    # prompt pages published to the prefix index
    preemptions: int = 0
    # swap-out state: (row page-indices, physical ids at swap time, snapshot)
    swap: Optional[tuple] = None
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0        # first generated token
    t_done: float = 0.0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def prefilling(self) -> bool:
        return self.prefill_done < self.prompt_len

    @property
    def decoding(self) -> bool:
        return not self.prefilling and len(self.generated) < self.max_new


class ContinuousScheduler:
    """Slot/pool/prefix bookkeeping behind the continuous-batching engine.

    ``admission`` picks "reserve" (full up-front reservation, PR-9) or
    "expected" (immediate-need admission + lazy allocation + preemption);
    ``share_prefix`` turns on COW prefix sharing (expected admission only —
    a COW split transiently needs one extra page, which a fully-reserved
    pool cannot promise).
    """

    def __init__(
        self,
        layout: PagedLayout,
        *,
        admission: str = "expected",
        share_prefix: bool = False,
    ):
        if admission not in ("reserve", "expected"):
            raise ValueError(f"unknown admission policy {admission!r}")
        if share_prefix and admission == "reserve":
            raise ValueError(
                "share_prefix requires admission='expected': a COW split "
                "transiently needs one extra free page, which full "
                "reservation cannot guarantee"
            )
        self.layout = layout
        self.admission = admission
        self.share_prefix = share_prefix
        self.pool = PagePool(layout)
        self.tables = BlockTables(layout)
        self.prefix_index = PrefixIndex(layout)
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * layout.n_slots
        self.finished: list[Request] = []
        self.shared_tokens_total = 0
        self.preemptions = 0
        self.cow_splits = 0

    def submit(self, req: Request, now: float = 0.0) -> None:
        need = self.layout.pages_for(req.prompt_len + req.max_new)
        if need > self.layout.usable_pages:
            raise ValueError(
                f"request {req.rid} needs {need} pages; pool has "
                f"{self.layout.usable_pages} total"
            )
        if need > self.layout.max_pages:
            raise ValueError(
                f"request {req.rid} needs {need} pages; block-table rows hold "
                f"{self.layout.max_pages}"
            )
        req.t_submit = now
        self.queue.append(req)

    # -- admission ----------------------------------------------------------

    def _row_pages(self, slot: int) -> List[Tuple[int, int]]:
        """Non-null (page-index, physical id) entries of a slot's row."""
        row = self.tables.row(slot)
        return [(i, int(p)) for i, p in enumerate(row) if int(p) != NULL_PAGE]

    def _admit_fresh(self, req: Request, slot: int) -> bool:
        """Map/allocate the request's prompt pages; False when short on pages."""
        shared_pages: List[int] = []
        shared_tokens = 0
        if self.share_prefix and req.prompt_len > 1:
            # cap at prompt_len - 1: the last prompt position must go through
            # prefill so its logits seed the first generated token
            shared_pages, shared_tokens = self.prefix_index.match(
                self.pool, req.prompt, req.prompt_len - 1
            )
        prompt_pages = self.layout.pages_for(req.prompt_len)
        fresh = prompt_pages - len(shared_pages)
        if self.admission == "reserve":
            need = self.layout.pages_for(req.prompt_len + req.max_new)
        else:
            need = fresh
        if self.pool.n_free < need:
            return False
        for p in shared_pages:
            self.pool.fork(p)
        new_pages = self.pool.alloc(need)
        self.tables.assign(slot, list(shared_pages) + new_pages)
        req.slot = slot
        req.shared_tokens = shared_tokens
        req.prefill_done = shared_tokens
        self.shared_tokens_total += shared_tokens
        self.slots[slot] = req
        return True

    def _admit_resume(self, req: Request, slot: int) -> bool:
        """Re-map a preempted request: fresh pages for its swapped snapshot
        (the engine scatters the saved content back before the next step)."""
        idxs, _old_ids, _snap = req.swap
        if self.pool.n_free < len(idxs):
            return False
        new_ids = self.pool.alloc(len(idxs))
        self.tables.clear(slot)
        for i, p in zip(idxs, new_ids):
            self.tables.set_entry(slot, i, p)
        req.slot = slot
        req.swap = (idxs, new_ids, req.swap[2])
        self.slots[slot] = req
        return True

    def admit(self, now: float = 0.0) -> list[Request]:
        """Admit queued requests while a slot is free and the pool covers the
        policy's page demand. FIFO: the head of the queue blocks admission
        (no starvation by smaller requests jumping ahead); preempted
        requests re-queue at the head, so they resume first."""
        admitted = []
        while self.queue:
            req = self.queue[0]
            slot = next(
                (i for i, s in enumerate(self.slots) if s is None), None
            )
            if slot is None:
                break
            ok = (
                self._admit_resume(req, slot)
                if req.swap is not None
                else self._admit_fresh(req, slot)
            )
            if not ok:
                break
            self.queue.popleft()
            req.t_admit = now
            admitted.append(req)
        return admitted

    def rematch_prefix(self, req: Request) -> None:
        """Retry the prefix match right before a request's FIRST prefill
        chunk. A follower admitted while its donor was still prefilling saw
        an empty index at admission; by the time the engine gets to the
        follower's first chunk the donor has registered (prefill is FIFO by
        admission time), and since the follower has written nothing yet,
        swapping its fresh prompt pages for shared ones is free."""
        if not self.share_prefix or req.prefill_done != req.shared_tokens:
            return
        if req.prompt_len <= 1:
            return
        pages, n = self.prefix_index.match(
            self.pool, req.prompt, req.prompt_len - 1
        )
        if n <= req.shared_tokens:
            return
        # fork the new mapping BEFORE releasing the old one: the old row may
        # itself be the last holder keeping some matched page alive
        for p in pages:
            self.pool.fork(p)
        for _, p in self._row_pages(req.slot):
            self.pool.release(p)
        self.tables.clear(req.slot)
        # cannot exhaust: the releases above returned at least as many
        # exclusive pages as the (smaller) fresh remainder needs
        fresh = self.pool.alloc(self.layout.pages_for(req.prompt_len) - len(pages))
        self.tables.assign(req.slot, list(pages) + fresh)
        self.shared_tokens_total += n - req.shared_tokens
        req.shared_tokens = n
        req.prefill_done = n

    # -- writes: lazy allocation + COW --------------------------------------

    def prepare_write(
        self, req: Request, start: int, n_tokens: int
    ) -> List[Tuple[int, int]]:
        """Make every page covering token positions ``[start, start+n)`` of
        ``req`` privately writable. NULL entries are allocated lazily;
        entries with refcount > 1 are COW-split: a fresh page is allocated
        and the row repointed, and the returned ``(src, dst)`` pairs tell
        the engine which device-side page copies to issue BEFORE the write
        dispatch. Raises PoolExhausted when the pool cannot cover it (the
        engine resolves that with a preemption and retries)."""
        if n_tokens <= 0:
            return []
        P = self.layout.page_size
        copies: List[Tuple[int, int]] = []
        first = start // P
        last = (start + n_tokens - 1) // P
        row = self.tables.row(req.slot)
        for idx in range(first, last + 1):
            cur = int(row[idx])
            if cur == NULL_PAGE:
                (new,) = self.pool.alloc(1)
                self.tables.set_entry(req.slot, idx, new)
            elif self.pool.refcount(cur) > 1:
                (new,) = self.pool.alloc(1)
                copies.append((cur, new))
                self.tables.set_entry(req.slot, idx, new)
                self.pool.release(cur)
                self.cow_splits += 1
        return copies

    # -- preemption / swap ---------------------------------------------------

    def pick_victim(self, requester: Request) -> Optional[Request]:
        """Victim for a preemption: the request in the HIGHEST-index occupied
        slot, excluding the requester and the lowest-index occupied slot.
        The lowest occupied slot is never preempted — it always runs to
        completion, so the pool always drains and admission always resumes
        (liveness by induction). Returns None when no candidate exists
        (the engine then self-preempts the requester, unless the requester
        itself is the protected slot)."""
        occupied = [i for i, s in enumerate(self.slots) if s is not None]
        if not occupied:
            return None
        protected = occupied[0]
        for i in reversed(occupied):
            if i == protected or self.slots[i] is requester:
                continue
            return self.slots[i]
        return None

    def swap_out(self, victim: Request, snapshot=None, now: float = 0.0) -> None:
        """Release the victim's pages and slot; park its (page-index,
        physical-id, snapshot) triple for resume. The engine gathers the
        snapshot from the device BEFORE calling this (released exclusive
        pages go straight back on the free list)."""
        entries = self._row_pages(victim.slot)
        idxs = [i for i, _ in entries]
        ids = [p for _, p in entries]
        for p in ids:
            self.pool.release(p)
        self.tables.clear(victim.slot)
        self.slots[victim.slot] = None
        victim.slot = -1
        victim.swap = (idxs, ids, snapshot)
        victim.preemptions += 1
        self.preemptions += 1
        # resume FIRST: FIFO head blocks, so a preempted request can never
        # be starved by fresh arrivals
        self.queue.appendleft(victim)

    def resume_ids(self, req: Request) -> tuple:
        """(fresh ids mapped at re-admission, host snapshot) for the engine's
        scatter; clears the swap state."""
        idxs, new_ids, snapshot = req.swap
        req.swap = None
        return new_ids, snapshot

    # -- completion ----------------------------------------------------------

    def register_prefix(self, req: Request) -> None:
        """Publish a fully-prefilled prompt's pages to the prefix index (a
        later identical/extending prompt forks them instead of re-running
        prefill)."""
        if not self.share_prefix or req.registered or req.prefilling:
            return
        n = self.layout.pages_for(req.prompt_len)
        row = self.tables.row(req.slot)
        self.prefix_index.register(self.pool, req.prompt, [int(p) for p in row[:n]])
        req.registered = True

    def complete(self, req: Request, now: float = 0.0) -> None:
        """Release every page the request holds and free its slot (shared
        pages survive under their other holders' references)."""
        req.t_done = now
        for _, p in self._row_pages(req.slot):
            self.pool.release(p)
        self.tables.clear(req.slot)
        self.slots[req.slot] = None
        self.finished.append(req)

    @property
    def active(self) -> list[Request]:
        return [r for r in self.slots if r is not None]

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def decode_view(self):
        """(tokens, lengths, tables) device-ready arrays for one decode step.

        Only slots in the decode phase expose their real block-table row and
        length; idle and still-prefilling slots are nulled so their write
        lands in the trash page and their (garbage) logits cost nothing to
        ignore."""
        S = self.layout.n_slots
        toks = np.zeros((S,), np.int32)
        lengths = np.zeros((S,), np.int32)
        tables = np.full(
            (S, self.layout.max_pages), NULL_PAGE, np.int32
        )
        for s, req in enumerate(self.slots):
            if req is not None and req.decoding:
                toks[s] = req.generated[-1]
                lengths[s] = req.prompt_len + len(req.generated) - 1
                tables[s] = self.tables.row(s)
        return toks, lengths, tables


@dataclasses.dataclass
class ServeReport:
    """What BENCH_serve records for one run."""

    n_requests: int
    total_new_tokens: int
    wall_s: float
    tokens_per_s: float
    first_token_p50_ms: float
    first_token_p99_ms: float
    completion_p50_ms: float
    completion_p99_ms: float
    decode_steps: int
    prefill_chunks: int
    # prefix-sharing / preemption telemetry (zero on the plain path)
    prefill_tokens: int = 0
    shared_tokens: int = 0
    cow_splits: int = 0
    preemptions: int = 0
    swapped_pages: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _pct(xs: list, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


class ContinuousEngine:
    """Drives the paged steps from the scheduler's bookkeeping.

    ``prefill_fn(cache, tokens (1,C), start, table_row, n_valid)`` and
    ``decode_fn(cache, tokens (S,), lengths (S,), tables (S,maxp))`` both
    return ``(sampled_tokens, new_cache)`` — the engine threads one live
    cache value through every dispatch.

    The sharing/preemption machinery needs three more device hooks, all
    over fixed ``(W,)`` id vectors (W = max_pages) padded with the null
    page so one shape covers every call — padded lanes write the
    trash page by design:

    * ``copy_fn(cache, src, dst)`` — COW split: copy pages src[i] → dst[i];
    * ``gather_fn(cache, ids)`` — swap-out: snapshot pages to host;
    * ``scatter_fn(cache, ids, snap)`` — resume: write a snapshot back.

    Without them the engine still runs (reserve admission, no sharing);
    a preemption that needs a missing hook degrades to dropping the
    victim's cache content, which only the fake-model tests do.
    """

    def __init__(
        self,
        scheduler: ContinuousScheduler,
        cache,
        prefill_fn: Callable,
        decode_fn: Callable,
        *,
        chunk: int,
        eos_id: Optional[int] = None,
        clock: Callable[[], float] = time.perf_counter,
        copy_fn: Optional[Callable] = None,
        gather_fn: Optional[Callable] = None,
        scatter_fn: Optional[Callable] = None,
    ):
        self.sched = scheduler
        self.cache = cache
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.chunk = chunk
        self.eos_id = eos_id
        self.clock = clock
        self.copy_fn = copy_fn
        self.gather_fn = gather_fn
        self.scatter_fn = scatter_fn
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.prefill_tokens = 0
        self.swapped_pages = 0

    # -- page pressure -------------------------------------------------------

    def _pad_ids(self, ids: list) -> np.ndarray:
        W = self.sched.layout.max_pages
        out = np.full((W,), NULL_PAGE, np.int32)
        out[:len(ids)] = np.asarray(ids, np.int32)
        return out

    def _apply_copies(self, copies: list) -> None:
        if not copies:
            return
        if self.copy_fn is None:
            raise RuntimeError(
                "COW split required but the engine has no copy_fn "
                "(share_prefix engines must pass one)"
            )
        src = self._pad_ids([s for s, _ in copies])
        dst = self._pad_ids([d for _, d in copies])
        self.cache = self.copy_fn(self.cache, src, dst)

    def _swap_out(self, victim: Request) -> None:
        ids = [p for _, p in self.sched._row_pages(victim.slot)]
        snapshot = None
        if self.gather_fn is not None:
            snapshot = self.gather_fn(self.cache, self._pad_ids(ids))
        self.swapped_pages += len(ids)
        self.sched.swap_out(victim, snapshot, self.clock())

    def _ensure_writable(self, req: Request, start: int, n_tokens: int) -> bool:
        """prepare_write with preemption on pool pressure; returns False when
        the REQUESTER itself was self-preempted (skip its dispatch)."""
        while True:
            try:
                copies = self.sched.prepare_write(req, start, n_tokens)
            except PoolExhausted:
                victim = self.sched.pick_victim(req)
                if victim is None:
                    occupied = [
                        i for i, s in enumerate(self.sched.slots) if s is not None
                    ]
                    if occupied and self.sched.slots[occupied[0]] is req:
                        # the protected slot itself cannot be satisfied: the
                        # pool is genuinely too small for one request, which
                        # submit() rejects — this is unreachable by contract
                        raise
                    self._swap_out(req)
                    return False
                self._swap_out(victim)
                continue
            self._apply_copies(copies)
            return True

    def _resume_if_swapped(self, req: Request) -> None:
        if req.swap is None or req.slot < 0:
            return
        new_ids, snapshot = self.sched.resume_ids(req)
        if snapshot is not None and self.scatter_fn is not None:
            self.cache = self.scatter_fn(
                self.cache, self._pad_ids(new_ids), snapshot
            )

    # -- dispatches ----------------------------------------------------------

    def _prefill_one(self) -> None:
        """One chunk of the longest-admitted request still prefilling."""
        cands = [r for r in self.sched.active if r.prefilling]
        if not cands:
            return
        req = min(cands, key=lambda r: r.t_admit)
        self.sched.rematch_prefix(req)
        start = req.prefill_done
        nv = min(self.chunk, req.prompt_len - start)
        if not self._ensure_writable(req, start, nv):
            return
        toks = np.zeros((1, self.chunk), np.int32)
        toks[0, :nv] = req.prompt[start:start + nv]
        row = self.sched.tables.row(req.slot)
        tok, self.cache = self.prefill_fn(
            self.cache, toks, np.int32(start), row.astype(np.int32),
            np.int32(nv),
        )
        self.prefill_chunks += 1
        self.prefill_tokens += nv
        req.prefill_done = start + nv
        if not req.prefilling:
            self.sched.register_prefix(req)
            req.generated.append(int(tok))
            req.t_first = self.clock()
            self._maybe_complete(req)

    def _decode_all(self) -> None:
        # every decoding slot writes its last token's k/v at position
        # lengths[s] = prompt_len + n_generated - 1: make that page private
        # (lazy-alloc or COW) before the batched dispatch
        for req in list(self.sched.active):
            # a request visited earlier in this loop may have preempted this
            # one (slot cleared) — skip it, it re-queued for resume
            if req is not None and req.decoding and req.slot >= 0:
                pos = req.prompt_len + len(req.generated) - 1
                self._ensure_writable(req, pos, 1)
        toks, lengths, tables = self.sched.decode_view()
        if not int((lengths > 0).sum()):
            return
        out, self.cache = self.decode_fn(self.cache, toks, lengths, tables)
        self.decode_steps += 1
        out = np.asarray(out)
        now = self.clock()
        for s, req in enumerate(list(self.sched.slots)):
            if req is not None and req.decoding and lengths[s] > 0:
                req.generated.append(int(out[s]))
                self._maybe_complete(req, now)

    def _maybe_complete(self, req: Request, now: Optional[float] = None) -> None:
        done = len(req.generated) >= req.max_new or (
            self.eos_id is not None and req.generated[-1] == self.eos_id
        )
        if done:
            self.sched.complete(req, now if now is not None else self.clock())

    def run(self, requests: list[Request]) -> ServeReport:
        """Serve every request to completion; return the latency report."""
        t0 = self.clock()
        for req in requests:
            self.sched.submit(req, t0)
        while self.sched.busy:
            for req in self.sched.admit(self.clock()):
                self._resume_if_swapped(req)
            self._prefill_one()
            self._decode_all()
        wall = self.clock() - t0
        done = self.sched.finished
        total = sum(len(r.generated) for r in done)
        first = [(r.t_first - r.t_submit) * 1e3 for r in done]
        comp = [(r.t_done - r.t_submit) * 1e3 for r in done]
        return ServeReport(
            n_requests=len(done),
            total_new_tokens=total,
            wall_s=wall,
            tokens_per_s=total / wall if wall > 0 else 0.0,
            first_token_p50_ms=_pct(first, 50),
            first_token_p99_ms=_pct(first, 99),
            completion_p50_ms=_pct(comp, 50),
            completion_p99_ms=_pct(comp, 99),
            decode_steps=self.decode_steps,
            prefill_chunks=self.prefill_chunks,
            prefill_tokens=self.prefill_tokens,
            shared_tokens=self.sched.shared_tokens_total,
            cow_splits=self.sched.cow_splits,
            preemptions=self.sched.preemptions,
            swapped_pages=self.swapped_pages,
        )
