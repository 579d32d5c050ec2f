"""The port's page pool, block tables, prefix index and continuous-batching
scheduler (``repro_torch.core.paging``, ``repro_torch.launch.scheduler``)
against the reference's (``repro.core.paging``, ``repro.launch.scheduler``).

Both are numpy bookkeeping, so the contract is identity: the same op and
request sequences give identical tables, refcounts, epochs, free lists,
prefix-index hits, decode views, page copies and swaps, and ``ServeReport``
counters. The pool is driven by the reference's fuzz (random alloc / fork /
COW-split / release / row-clear / free / abuse sequences), the scheduler by
the reference's workloads (completion, FIFO, reservation, oversubscription
with preemption, prefix sharing with COW splits) over a fake model whose
tokens are a function of its inputs.
"""

import numpy as np
import pytest

from _torch_parity import one_torch_thread  # noqa: F401
import repro.core.paging as jpaging
import repro.launch.scheduler as jsched
import repro_torch.core.paging as tpaging
import repro_torch.launch.scheduler as tsched

PACKAGES = {"reference": (jpaging, jsched), "port": (tpaging, tsched)}


def _pool_state(pool, tbl, layout):
    return (tbl.array.tolist(), list(pool._free), sorted(pool._allocated),
            [pool.refcount(p) for p in range(layout.npage)],
            [pool.epoch(p) for p in range(layout.npage)])


def _fuzz_trace(paging, seed: int, n_ops: int = 120) -> list:
    """The reference's pool fuzz (tests/test_paging_fuzz.py) on one package,
    recording the state after every op; the rng's draws depend on that
    state, so two packages give one trace only if they agree throughout."""
    rng = np.random.default_rng(seed)
    layout = paging.PagedLayout(npage=int(rng.integers(4, 14)), page_size=4,
                                max_pages=int(rng.integers(2, 6)),
                                n_slots=int(rng.integers(1, 5)))
    pool, tbl = paging.PagePool(layout), paging.BlockTables(layout)
    trace = []
    for _ in range(n_ops):
        arr = tbl.array
        mapped = [(s, i, int(arr[s, i])) for s in range(layout.n_slots)
                  for i in range(layout.max_pages) if arr[s, i] != paging.NULL_PAGE]
        empty = [(s, i) for s in range(layout.n_slots) for i in range(layout.max_pages)
                 if arr[s, i] == paging.NULL_PAGE]
        op = rng.choice(["alloc", "fork", "cow", "release", "clear_row", "free", "abuse"])
        if op == "alloc" and empty:
            s, i = empty[rng.integers(len(empty))]
            try:
                (p,) = pool.alloc(1)
                tbl.set_entry(s, i, p)
            except paging.PoolExhausted:
                trace.append("exhausted")
        elif op == "fork" and mapped and empty:
            _, _, p = mapped[rng.integers(len(mapped))]
            s2, i2 = empty[rng.integers(len(empty))]
            trace.append(pool.fork(p))
            tbl.set_entry(s2, i2, p)
        elif op == "cow" and mapped:
            shared = [(s, i, p) for s, i, p in mapped if pool.refcount(p) > 1]
            if shared and pool.n_free > 0:
                s, i, p = shared[rng.integers(len(shared))]
                (new,) = pool.alloc(1)
                tbl.set_entry(s, i, new)
                trace.append(pool.release(p))
        elif op == "release" and mapped:
            s, i, p = mapped[rng.integers(len(mapped))]
            tbl.set_entry(s, i, paging.NULL_PAGE)
            trace.append(pool.release(p))
        elif op == "clear_row" and mapped:
            s = int(rng.integers(layout.n_slots))
            for _, _, p in [m for m in mapped if m[0] == s]:
                pool.release(p)
            tbl.clear(s)
        elif op == "free" and mapped:
            excl = [(s, i, p) for s, i, p in mapped if pool.refcount(p) == 1]
            if excl:
                s, i, p = excl[rng.integers(len(excl))]
                tbl.set_entry(s, i, paging.NULL_PAGE)
                pool.free([p])
        elif op == "abuse":
            for bad in (lambda: pool.fork(paging.NULL_PAGE),
                        lambda: pool.free([paging.NULL_PAGE]),
                        lambda: pool.alloc(pool.n_free + 1)):
                with pytest.raises((ValueError, paging.PoolExhausted)) as err:
                    bad()
                trace.append(str(err.value))
        pool.check_conservation(tbl)
        trace.append((str(op), _pool_state(pool, tbl, layout)))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 2**31 - 1, 12345])
def test_pool_fuzz_traces_match_reference(seed):
    want = _fuzz_trace(jpaging, seed)
    got = _fuzz_trace(tpaging, seed)
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"seed {seed}: op {k} differs"


def test_pool_errors_and_audit_match_reference():
    """Double free, the null page, exhaustion (all-or-nothing) and the
    cross-checked audit raise the reference's errors."""
    for paging in (jpaging, tpaging):
        layout = paging.PagedLayout(npage=5, page_size=4, max_pages=4, n_slots=2)
        pool, tbl = paging.PagePool(layout), paging.BlockTables(layout)
        pages = pool.alloc(2)
        pool.free(pages)
        with pytest.raises(ValueError, match="double free"):
            pool.free(pages)
        with pytest.raises(ValueError, match="null page"):
            pool.free([paging.NULL_PAGE])
        with pytest.raises(paging.PoolExhausted):
            pool.alloc(5)
        pool.check_conservation()
        pages = pool.alloc(2)
        tbl.assign(0, pages)
        pool.release(pages[1])
        with pytest.raises(AssertionError, match="still referenced"):
            pool.check_conservation(tbl)
        tbl.set_entry(0, 1, paging.NULL_PAGE)
        pool.fork(pages[0])
        with pytest.raises(AssertionError, match="refcounts"):
            pool.check_conservation(tbl)
        with pytest.raises(ValueError, match="degenerate"):
            paging.PagedLayout(npage=4, page_size=0, max_pages=1, n_slots=1)


@pytest.mark.parametrize("seed", [3, 11])
def test_prefix_index_matches_reference(seed):
    """Random prompts built from shared stems register and match the same
    pages and token counts in both packages, stale entries dropped alike."""
    rng = np.random.default_rng(seed)
    stems = [rng.integers(0, 50, size=int(n)) for n in rng.integers(3, 20, size=4)]
    out = {}
    for name, (paging, _) in PACKAGES.items():
        layout = paging.PagedLayout(npage=40, page_size=4, max_pages=8, n_slots=4)
        pool, index = paging.PagePool(layout), paging.PrefixIndex(layout)
        r = np.random.default_rng(seed + 1)
        log, live = [], []
        for _ in range(30):
            stem = stems[r.integers(len(stems))]
            prompt = np.concatenate([stem, r.integers(0, 50, size=int(r.integers(0, 6)))])
            pages, n = index.match(pool, prompt, len(prompt) - 1)
            log.append((pages, n))
            fresh = pool.alloc(layout.pages_for(len(prompt)) - len(pages))
            for p in pages:
                pool.fork(p)
            row = list(pages) + fresh
            index.register(pool, prompt, row)
            live.append(row)
            if len(live) > 3 or r.random() < 0.3:
                for p in live.pop(int(r.integers(len(live)))):
                    pool.release(p)
        log.append(paging._chunk_digest(7, np.arange(5)))
        out[name] = log
    assert out["port"] == out["reference"]


class _FakeModel:
    """Deterministic fake steps: tokens are functions of the inputs, so two
    engines that feed identical inputs emit identical streams; every call and
    its arguments are logged."""

    def __init__(self):
        self.log = []

    def prefill(self, cache, toks, start, row, nv):
        self.log.append(("prefill", toks.tolist(), int(start), row.tolist(), int(nv)))
        return np.int32((int(toks.sum()) + int(start)) % 97), cache

    def decode(self, cache, toks, lengths, tables):
        self.log.append(("decode", toks.tolist(), lengths.tolist(), tables.tolist()))
        return ((toks + 3 * lengths) % 89).astype(np.int32), cache

    def copy(self, cache, src, dst):
        self.log.append(("copy", src.tolist(), dst.tolist()))
        return cache

    def gather(self, cache, ids):
        self.log.append(("gather", ids.tolist()))
        return ids.copy()

    def scatter(self, cache, ids, snap):
        self.log.append(("scatter", ids.tolist(), snap.tolist()))
        return cache


def _prompts(spec, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 97, size=p).astype(np.int32), g) for p, g in spec]


PREFIX = np.arange(14, dtype=np.int32) * 5 % 97
SCENARIOS = {
    "completion": dict(layout=(17, 4, 4, 2), reqs=_prompts([(6, 3), (9, 2), (3, 5), (5, 1),
                                                            (8, 4)])),
    "fifo": dict(layout=(9, 4, 8, 2), reqs=_prompts([(16, 8)] + [(3, 2)] * 6, seed=1)),
    "reserve": dict(layout=(5, 4, 4, 2), reqs=_prompts([(9, 2), (9, 2), (3, 1)], seed=2),
                    admission="reserve"),
    "oversubscribed": dict(layout=(9, 4, 8, 3),
                           reqs=[(np.arange(6, dtype=np.int32) + i, 18) for i in range(5)]),
    "prefix_cow": dict(layout=(17, 4, 7, 2), share_prefix=True,
                       reqs=[(PREFIX, 12), (_prompts([(10, 2)], seed=3)[0][0], 2),
                             (np.concatenate([PREFIX, [11, 13]]).astype(np.int32), 3)]),
    "prefix_pressure": dict(layout=(12, 4, 8, 3), share_prefix=True,
                            reqs=[(np.concatenate([PREFIX[:8], t]).astype(np.int32), g)
                                  for t, g in _prompts([(5, 9), (2, 12), (7, 6), (1, 10)],
                                                       seed=4)]),
}


def _serve(scheduler_mod, paging, scenario):
    npage, P, maxp, slots = scenario["layout"]
    layout = paging.PagedLayout(npage=npage, page_size=P, max_pages=maxp, n_slots=slots)
    sched = scheduler_mod.ContinuousScheduler(
        layout, admission=scenario.get("admission", "expected"),
        share_prefix=scenario.get("share_prefix", False))
    fake = _FakeModel()
    ticks = iter(range(10**6))
    eng = scheduler_mod.ContinuousEngine(
        sched, 0, fake.prefill, fake.decode, chunk=4, clock=lambda: float(next(ticks)),
        copy_fn=fake.copy, gather_fn=fake.gather, scatter_fn=fake.scatter)
    reqs = [scheduler_mod.Request(rid=i, prompt=p.copy(), max_new=g)
            for i, (p, g) in enumerate(scenario["reqs"])]
    report = eng.run(reqs)
    sched.pool.check_conservation(sched.tables)
    per_req = [(r.rid, r.generated, r.shared_tokens, r.preemptions, r.t_submit, r.t_admit,
                r.t_first, r.t_done) for r in reqs]
    return report.to_dict(), per_req, fake.log, _pool_state(sched.pool, sched.tables, layout)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_runs_match_reference(name):
    """Every dispatch the engine issues (prefill chunks, decode views, COW
    copies, swap-outs and resumes), every request's stream and timestamps
    (a shared tick clock) and the final pool state are identical."""
    want = _serve(jsched, jpaging, SCENARIOS[name])
    got = _serve(tsched, tpaging, SCENARIOS[name])
    assert got[0] == want[0], "ServeReport"
    assert got[1] == want[1], "requests"
    assert got[2] == want[2], "dispatches"
    assert got[3] == want[3], "pool"
    report = got[0]
    if name == "oversubscribed":
        assert report["preemptions"] > 0 and report["swapped_pages"] > 0
    if name == "prefix_cow":
        assert report["shared_tokens"] == 14 and report["cow_splits"] >= 1


def test_scheduler_rejections_match_reference():
    for paging, sched_mod in PACKAGES.values():
        layout = paging.PagedLayout(npage=5, page_size=4, max_pages=8, n_slots=1)
        sched = sched_mod.ContinuousScheduler(layout)
        with pytest.raises(ValueError, match="pool has"):
            sched.submit(sched_mod.Request(rid=0, prompt=np.arange(30, dtype=np.int32),
                                           max_new=8))
        with pytest.raises(ValueError, match="expected"):
            sched_mod.ContinuousScheduler(layout, admission="reserve", share_prefix=True)
        with pytest.raises(ValueError, match="unknown admission"):
            sched_mod.ContinuousScheduler(layout, admission="greedy")
