"""The flat-PP wire split at the ranks (``launch/participation.py``).

* ``FlatEngine.encode_rows`` on any split of the rows, concatenated in row
  order, then ``decode_mean``, equals ``FlatEngine.aggregate`` bit for bit
  for the randk, permk and qsgd samplers (nibble and int8 levels), and with
  a robust rule; RandK offsets regenerated from the seeds equal the
  kernel's plain version's;
* the seeds a payload carries are the engine's per-row seeds (permk: the
  one shared seed on every row), and a rank with no row encodes empty
  tensors of the wire's dtypes;
* a rank's own RandK offsets with the rest regenerated decode to the same
  mean, and the carry table's refresh on a rank's rows equals those rows of
  the whole table's;
* ``cohort_plan`` puts each carry client on its h row's rank wherever a
  group is free there, and keeps the identity on one rank.
"""

import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro_torch import prng
from repro_torch.core import ServerAggregator
from repro_torch.core import flat as flat_engine
from repro_torch.launch.participation import cohort_plan

N_ROWS, NBLK, B = 4, 6, 64


def _engine(sampler: str, s: int = 7):
    shapes = {"a": torch.empty((NBLK * B - 5,), device="meta")}
    return flat_engine.make_engine(shapes, kb=4, block=B, backend="ref", sampler=sampler,
                                   s=s, device="cpu")


def _bufs(seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn((N_ROWS, NBLK, B), generator=g)


def _split_payload(eng, key, bufs, splits, drop_offsets: bool) -> dict:
    parts = [eng.encode_rows(key, bufs[rows], rows, N_ROWS) for rows in splits]
    order = [j for rows in splits for j in rows]
    inv = torch.as_tensor(np.argsort(order))
    out = {}
    for name in parts[0]:
        if drop_offsets and name == "offsets":
            continue
        out[name] = torch.cat([p[name] for p in parts])[inv]
    return out  # without offsets, decode_mean regenerates them from the seeds


CASES = [("randk", 7), ("permk", 7), ("qsgd", 7), ("qsgd", 15)]
SPLITS = [[[0, 1, 2, 3]], [[0, 1], [2, 3]], [[3, 0], [], [2, 1]]]


@pytest.mark.parametrize("sampler,s", CASES)
@pytest.mark.parametrize("splits", SPLITS, ids=["one", "halves", "scattered"])
def test_split_wire_decodes_to_the_engine_aggregate(sampler, s, splits):
    eng = _engine(sampler, s)
    key = prng.PRNGKey(3)
    bufs = _bufs()
    want = eng.aggregate(key, bufs, N_ROWS)
    got = eng.decode_mean(_split_payload(eng, key, bufs, splits, drop_offsets=True), N_ROWS)
    assert torch.equal(got, want)


@pytest.mark.parametrize("sampler,s", [("randk", 7), ("qsgd", 7)])
def test_split_wire_robust_rule_equals_the_engine(sampler, s):
    eng = _engine(sampler, s)
    key = prng.PRNGKey(5)
    bufs = _bufs(1)
    agg = ServerAggregator("trimmed_mean", f=1)
    want = eng.aggregate(key, bufs, N_ROWS, agg)
    got = eng.decode_mean(_split_payload(eng, key, bufs, [[1, 3], [0, 2]], False),
                          N_ROWS, agg)
    assert torch.equal(got, want)


@pytest.mark.parametrize("own", [[2, 0], [1], []], ids=["two", "one", "none"])
def test_own_offsets_and_regenerated_rest_decode_to_the_engine_aggregate(own):
    """A rank passes the offsets its kernel drew for its own rows; the other
    rows' offsets come from their seeds: the mean and the robust rule equal
    the engine's, bit for bit."""
    eng = _engine("randk")
    key = prng.PRNGKey(11)
    bufs = _bufs(3)
    pay = _split_payload(eng, key, bufs, [[0, 1, 2, 3]], drop_offsets=False)
    pay["offsets"] = pay["offsets"][own]
    assert torch.equal(eng.decode_mean(pay, N_ROWS, rows=own), eng.aggregate(key, bufs, N_ROWS))
    agg = ServerAggregator("trimmed_mean", f=1)
    assert torch.equal(eng.decode_mean(pay, N_ROWS, agg, rows=own),
                       eng.aggregate(key, bufs, N_ROWS, agg))


def test_carry_refresh_of_a_rank_equals_its_rows_of_the_whole_table():
    """``_pp_carry_refresh`` on a rank's rows (``offset``) with the
    gradients of the positions it owns equals those rows of the whole
    table's refresh, a repeated client and a dropped one included."""
    from repro_torch.core import FaultSpec
    from repro_torch.core.marina import _pp_carry_refresh

    g = torch.Generator().manual_seed(4)
    h = {"w": torch.randn((4, 3), generator=g)}
    sel = [3, 1, 3, 2]
    grads = {"w": torch.randn((4, 3), generator=g)}
    for faults in (None, FaultSpec(attack="drop", ids=(3,))):
        whole = _pp_carry_refresh(h, sel, grads, faults, 4)
        for lo in (0, 2):
            mine = [i for i, c in enumerate(sel) if lo <= c < lo + 2]
            part = _pp_carry_refresh({"w": h["w"][lo:lo + 2]}, sel,
                                     {"w": grads["w"][mine]}, faults, 4,
                                     positions=mine, offset=lo)
            assert torch.equal(part["w"], whole["w"][lo:lo + 2])


def test_payload_seeds_and_empty_rows():
    key = prng.PRNGKey(9)
    bufs = _bufs(2)
    eng = _engine("randk")
    pay = eng.encode_rows(key, bufs[[2, 0]], [2, 0], N_ROWS)
    seeds = eng.worker_seeds(key, N_ROWS)
    assert pay["seeds"].dtype == torch.int32
    assert (pay["seeds"].numpy().view(np.uint32) == seeds[[2, 0]]).all()
    # the offsets the receiver regenerates are the ones the kernel drew
    regen = flat_engine.seeded_offsets(int(seeds[2]), NBLK, B, eng.kb, device="cpu")
    assert torch.equal(pay["offsets"][0], regen)
    pk = _engine("permk").encode_rows(key, bufs[[1]], [1], N_ROWS)
    assert pk["values"].shape == (1, NBLK, B // N_ROWS)
    assert int(pk["seeds"][0]) & 0xFFFFFFFF == prng.key_to_seed(key)
    for sampler, s, names in (("randk", 7, {"values": torch.float32, "seeds": torch.int32,
                                            "offsets": torch.int32}),
                              ("permk", 7, {"values": torch.float32, "seeds": torch.int32}),
                              ("qsgd", 7, {"words": torch.int32, "norms": torch.float32}),
                              ("qsgd", 15, {"levels": torch.int8, "norms": torch.float32})):
        e = _engine(sampler, s)
        full = e.encode_rows(key, bufs[:1], [0], N_ROWS)
        empty = e.encode_rows(key, bufs[:0], [], N_ROWS)
        assert {k: v.dtype for k, v in empty.items()} == names
        for k in names:
            assert empty[k].shape == (0,) + tuple(full[k].shape[1:]), (sampler, k)


def test_encode_refuses_samplers_without_a_split_wire():
    with pytest.raises(ValueError, match="split wire"):
        _engine("natural").encode_rows(prng.PRNGKey(0), _bufs()[:1], [0], N_ROWS)


@pytest.mark.parametrize("sel,carry,want", [
    # 4 workers on 2 ranks, r = 2: group 0 on rank 0, group 1 on rank 1
    ([1, 3], True, ([0, 1], [0, 1], [0, 1])),
    ([2, 0], True, ([1, 0], [1, 0], [1, 0])),       # swapped onto the owners
    ([1, 0], True, ([0, 1], [0, 1], [0, 0])),       # uneven: position 1 moves
    ([2, 0], False, ([0, 1], [0, 1], [0, 1])),      # no carry: the identity
])
def test_cohort_plan_puts_carry_clients_on_their_owners(sel, carry, want):
    assert cohort_plan(sel, n=4, r=2, world=2, cohort_compute=True, carry=carry) == want


def test_cohort_plan_one_rank_and_masked():
    assert cohort_plan([3, 1], n=4, r=2, world=1, cohort_compute=True,
                       carry=True) == ([0, 1], [0, 0], [0, 0])
    # masked fallback: each row forms on its client's own rank
    assert cohort_plan([3, 0, 2], n=6, r=3, world=3, cohort_compute=False,
                       carry=False) == ([0, 1, 2], [1, 0, 1], [1, 0, 1])
    # r = 1 spanning both ranks: the group's home is its last rank
    assert cohort_plan([0], n=4, r=1, world=2, cohort_compute=True,
                       carry=True) == ([0], [1], [0])
