"""The port's checkpoint store against ``repro.checkpoint``: one file format.

* The reference's six ``tests/test_checkpoint.py`` cases (exact round trip,
  a flipped byte, a truncated file, a forged digest, a file without a
  digest, a missing leaf), each on a file the port wrote and on one the
  reference wrote, always loaded by the port: a corrupt file raises
  :class:`CheckpointCorruptionError` (neither ``KeyError`` nor
  ``ValueError``), a missing leaf ``KeyError``, a wrong shape
  ``ValueError``.
* A MARINA carry-mode state with a bf16 leaf written by either package
  loads into the other's state bit for bit (the port's ``step`` an int);
  for every state class (MARINA / VR / PP / GD's ``MarinaState``, DIANA,
  VR-DIANA, DCGD, EC-SGD, deadline MARINA) both packages write the same
  keys, the same entries byte for byte and the same digest.
* ``core.tree_util.tree_flatten_with_path`` names leaves exactly as
  ``jax.tree_util.tree_flatten_with_path`` does.
"""

import dataclasses
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, to_np  # noqa: F401
from repro import checkpoint as jck
from repro.checkpoint import store as jstore
from repro.core import async_rounds as jasync
from repro.core import baselines as jbase
from repro.core import marina as jmarina
from repro_torch.checkpoint import (
    CheckpointCorruptionError,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
from repro_torch.checkpoint import store
from repro_torch.convert import params_from_jax
from repro_torch.core import async_rounds, baselines, marina
from repro_torch.core.tree_util import tree_flatten_with_path, tree_leaves


def _jtree():
    return {"w": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
            "b": jnp.ones((5,), jnp.bfloat16) * 1.5,
            "step": jnp.asarray(7, jnp.int32)}


def _ttree():
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": torch.ones(5, dtype=torch.bfloat16) * 1.5,
            "step": torch.tensor(7, dtype=torch.int32)}


def _save(writer: str, d: str, step: int) -> str:
    if writer == "port":
        return save_checkpoint(d, step, _ttree())
    return jck.save_checkpoint(d, step, _jtree())


def _zeros_like(tree):
    return {k: torch.zeros_like(v) for k, v in tree.items()}


def _stored_arrays(writer: str, with_digest: bool, forge: bool = False) -> dict:
    """The encoded arrays a writer stores for the tree, plus its digest."""
    if writer == "port":
        flat, _ = tree_flatten_with_path(_ttree())
        arrays = {}
        for p, leaf in flat:
            tag = store._tag(leaf)
            arrays[store._path_str(p) + (f"::{tag}" if tag else "")] = store._encode(leaf)
        crc = 0
        for k in sorted(arrays):
            crc = store._digest_update(crc, k, arrays[k])
    else:
        flat, _ = jax.tree_util.tree_flatten_with_path(_jtree())
        arrays = {}
        for p, leaf in flat:
            arr, tag = jstore._encode(np.asarray(leaf))
            arrays[jstore._path_str(p) + (f"::{tag}" if tag else "")] = arr
        crc = jstore._digest(arrays)
    if with_digest:
        arrays["__checksum__"] = np.uint32(crc ^ 0x1 if forge else crc)
    return arrays


WRITERS = ["port", "reference"]


@pytest.mark.parametrize("writer", WRITERS)
def test_roundtrip_exact(tmp_path, writer):
    d = str(tmp_path)
    _save(writer, d, 3)
    assert latest_step(d) == 3
    out = load_checkpoint(d, 3, _zeros_like(_ttree()))
    for a, b in zip(tree_leaves(_ttree()), tree_leaves(out)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("writer", WRITERS)
def test_corrupt_byte_raises(tmp_path, writer):
    d = str(tmp_path)
    path = _save(writer, d, 1)
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with pytest.raises(CheckpointCorruptionError, match="corrupt") as exc:
        load_checkpoint(d, 1, _ttree())
    assert not isinstance(exc.value, (KeyError, ValueError))


@pytest.mark.parametrize("writer", WRITERS)
def test_truncated_file_raises(tmp_path, writer):
    d = str(tmp_path)
    path = _save(writer, d, 1)
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[: len(blob) // 3])
    with pytest.raises(CheckpointCorruptionError, match="corrupt"):
        load_checkpoint(d, 1, _ttree())


@pytest.mark.parametrize("writer", WRITERS)
def test_digest_mismatch_raises(tmp_path, writer):
    """An intact zip layer whose stored digest disagrees with the content."""
    d = str(tmp_path)
    np.savez(os.path.join(d, "ckpt_00000002.npz"),
             **_stored_arrays(writer, with_digest=True, forge=True))
    with pytest.raises(CheckpointCorruptionError, match="checksum mismatch"):
        load_checkpoint(d, 2, _ttree())


@pytest.mark.parametrize("writer", WRITERS)
def test_pre_checksum_checkpoint_still_loads(tmp_path, writer):
    d = str(tmp_path)
    np.savez(os.path.join(d, "ckpt_00000005.npz"),
             **_stored_arrays(writer, with_digest=False))
    out = load_checkpoint(d, 5, _zeros_like(_ttree()))
    assert torch.equal(out["w"], _ttree()["w"])
    assert torch.equal(out["b"], _ttree()["b"])


@pytest.mark.parametrize("writer", WRITERS)
def test_missing_leaf_stays_keyerror(tmp_path, writer):
    """A leaf the caller expects but the file lacks stays a KeyError (the
    trainer's fallback tiers dispatch on it); a wrong shape is a
    ValueError."""
    d = str(tmp_path)
    if writer == "port":
        save_checkpoint(d, 4, {"w": torch.zeros(2)})
    else:
        jck.save_checkpoint(d, 4, {"w": jnp.zeros((2,))})
    with pytest.raises(KeyError):
        load_checkpoint(d, 4, {"w": torch.zeros(2), "extra": torch.zeros(())})
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(d, 4, {"w": torch.zeros(3)})


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def _np_tree(rng, n=None):
    """A small parameter tree of numpy leaves: f32, bf16, a nested list."""
    lead = () if n is None else (n,)
    import ml_dtypes

    return {"embed": rng.standard_normal(lead + (6, 4)).astype(np.float32),
            "norm": rng.standard_normal(lead + (4,)).astype(ml_dtypes.bfloat16),
            "segments": [[{"w": rng.standard_normal(lead + (2, 4, 4)).astype(np.float32)}]]}


def _carry_state_np(seed: int):
    """A MARINA carry-mode state's fields as numpy: params with a bf16 leaf,
    the packed (nblk, B) estimator, the step, the worker-stacked carry."""
    rng = np.random.default_rng(seed)
    return dict(params=_np_tree(rng), g=rng.standard_normal((3, 128)).astype(np.float32),
                step=5, h=_np_tree(rng, n=2))


def _jax_state(fields):
    f = dict(fields)
    f["step"] = jnp.asarray(f["step"], jnp.int32)
    return jmarina.MarinaState(**jax.tree.map(jnp.asarray, f))


def _port_state(fields):
    f = dict(fields)
    step = f.pop("step")
    return marina.MarinaState(step=step, **params_from_jax(f, device="cpu"))


def _assert_bit_equal(jtree, ttree):
    jl = jax.tree.leaves(jtree)
    tl = [leaf for _, leaf in tree_flatten_with_path(ttree)[0]]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        if isinstance(b, int):
            assert b == int(a)
            continue
        assert b.shape == a.shape
        np.testing.assert_array_equal(to_np(b), to_np(a))


def test_reference_marina_carry_state_loads_bit_for_bit(tmp_path):
    d = str(tmp_path)
    js = _jax_state(_carry_state_np(0))
    jck.save_checkpoint(d, 9, js)
    like = _port_state(_carry_state_np(1))
    out = load_checkpoint(d, 9, like)
    assert isinstance(out, marina.MarinaState) and out.step == 5
    assert out.params["norm"].dtype == torch.bfloat16
    _assert_bit_equal(js, out)


def test_port_marina_carry_state_loads_into_the_reference_bit_for_bit(tmp_path):
    d = str(tmp_path)
    ts = _port_state(_carry_state_np(0))
    save_checkpoint(d, 9, ts)
    out = jck.load_checkpoint(d, 9, _jax_state(_carry_state_np(1)))
    assert int(out.step) == 5 and out.params["norm"].dtype == jnp.bfloat16
    _assert_bit_equal(out, ts)


#: every state class of both packages (the reference registers each with
#: ``register_dataclass``): (port class, reference class)
STATE_CLASSES = {
    "marina": (marina.MarinaState, jmarina.MarinaState),
    "diana": (baselines.DianaState, jbase.DianaState),
    "vr_diana": (baselines.VRDianaState, jbase.VRDianaState),
    "dcgd": (baselines.DCGDState, jbase.DCGDState),
    "ec_sgd": (baselines.ECSGDState, jbase.ECSGDState),
    "deadline_marina": (async_rounds.AsyncMarinaState, jasync.AsyncMarinaState),
}


def _state_fields(cls, rng) -> dict:
    """One value per field: the step an int, the deadline round's
    bookkeeping int32 rows, every other field a tree."""
    out = {}
    for f in dataclasses.fields(cls):
        if f.name == "step":
            out[f.name] = 3
        elif f.name in ("tag", "arrive", "born"):
            out[f.name] = rng.integers(-1, 5, (2,)).astype(np.int32)
        else:
            out[f.name] = _np_tree(rng)
    return out


@pytest.mark.parametrize("name", sorted(STATE_CLASSES) + ["marina_h_none"])
def test_every_state_class_writes_the_same_file(tmp_path, name):
    tcls, jcls = STATE_CLASSES[name.removesuffix("_h_none")]
    assert [f.name for f in dataclasses.fields(tcls)] == [
        f.name for f in dataclasses.fields(jcls)]
    fields = _state_fields(tcls, np.random.default_rng(7))
    if name == "marina_h_none":
        fields["h"] = None
    jf = {k: (None if v is None else jax.tree.map(jnp.asarray, v))
          for k, v in fields.items()}
    jf["step"] = jnp.asarray(3, jnp.int32)
    tf = {k: (v if k == "step" or v is None else params_from_jax(v, device="cpu"))
          for k, v in fields.items()}
    jstate, tstate = jcls(**jf), tcls(**tf)
    jpaths = [jstore._path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(jstate)[0]]
    tpaths = [store._path_str(p) for p, _ in tree_flatten_with_path(tstate)[0]]
    assert tpaths == jpaths
    jp = jck.save_checkpoint(str(tmp_path / "j"), 1, jstate)
    tp = save_checkpoint(str(tmp_path / "t"), 1, tstate)
    with zipfile.ZipFile(jp) as zj, zipfile.ZipFile(tp) as zt:
        assert sorted(zt.namelist()) == sorted(zj.namelist())
        for entry in zj.namelist():  # the digest among them
            assert zt.read(entry) == zj.read(entry), entry
    back = load_checkpoint(str(tmp_path / "j"), 1, tstate)
    assert type(back) is tcls and back.step == 3
    _assert_bit_equal(jstate, back)


def test_tree_flatten_with_path_matches_jax():
    from typing import NamedTuple

    class Pair(NamedTuple):
        a: object
        b: object

    rng = np.random.default_rng(0)
    tree = {"z": [rng.standard_normal(2), (rng.standard_normal(1), None)],
            "a": Pair(rng.standard_normal(3), {"k": rng.standard_normal(1)}),
            "m": jmarina.MarinaState(params=rng.standard_normal(2), g=None,
                                     step=rng.standard_normal(()), h=None)}
    jflat, _ = jax.tree_util.tree_flatten_with_path(tree)
    tstate = marina.MarinaState(params=tree["m"].params, g=None, step=tree["m"].step)
    tflat, treedef = tree_flatten_with_path({**tree, "m": tstate})
    assert [tuple(type(e).__name__ for e in p) for p, _ in tflat] == [
        tuple(type(e).__name__ for e in p) for p, _ in jflat]
    assert [jstore._path_str(p) for p, _ in tflat] == [
        jstore._path_str(p) for p, _ in jflat]
    for (_, a), (_, b) in zip(tflat, jflat):
        assert a is b
    back = treedef.unflatten([leaf for _, leaf in tflat])
    assert isinstance(back["m"], marina.MarinaState) and back["m"].g is None
    assert isinstance(back["a"], Pair) and back["z"][1][1] is None
