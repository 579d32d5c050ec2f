"""npz checkpoints of the port's trees in the reference's file format
(``repro.checkpoint.store``): a file either package writes, the other reads.

* ``ckpt_{step:08d}.npz`` in the directory, written to a temporary file
  there and renamed into place.
* One ``.npy`` entry per leaf, keyed by its path joined with ``//`` (dict
  keys, sequence indices, NamedTuple and dataclass field names, as
  ``jax.tree_util.tree_flatten_with_path`` names them:
  :func:`repro_torch.core.tree_util.tree_flatten_with_path`). A bf16 or
  float8 leaf is stored as its bit-view (uint16 / uint8) under
  ``key::bfloat16`` (``::float8_e4m3fn``, ``::float8_e5m2``).
* ``__checksum__``: CRC-32 over the sorted (key, ``dtype.str``, shape,
  bytes) of the stored arrays. :func:`load_checkpoint` verifies it where the
  file has one (files written before the digest still load) and raises
  :class:`CheckpointCorruptionError` on a bad archive or a mismatch.
* A Python ``int`` leaf (the port's optimizer ``step``; an int32 scalar
  array in the reference) is stored as int32 and loads back as an ``int``.

Leaves go to and come from the file one at a time, in the digest's key
order, so the host holds one leaf at a time, not the tree (a full-width
Qwen1.5-0.5B carry state is ~11 GB).
"""

from __future__ import annotations

import os
import re
import tempfile
import zipfile
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.core.tree_util import tree_flatten_with_path

PyTree = Any

_SEP = "//"
_CHECKSUM_KEY = "__checksum__"

#: stored bit-view of each dtype numpy cannot hold without ml_dtypes:
#: tag → (torch dtype, torch view dtype, numpy view dtype as stored)
_BITCAST = {
    "bfloat16": (torch.bfloat16, torch.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8),
}
_TAG_OF = {dt: tag for tag, (dt, _, _) in _BITCAST.items()}


class CheckpointCorruptionError(RuntimeError):
    """The checkpoint file is corrupt (bad archive, or digest mismatch).

    Deliberately not a :class:`KeyError` / :class:`ValueError`: the
    trainer's format fallbacks catch a ``KeyError`` to try older checkpoint
    layouts, and a corrupt file must fail loudly instead.
    """


def _path_str(path) -> str:
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p.name))
    return _SEP.join(parts)


def _digest_update(crc: int, key: str, arr: np.ndarray) -> int:
    """One entry of the digest: key, ``dtype.str``, shape, then the bytes.
    The shape is ``np.ascontiguousarray``'s, as in the reference: a scalar
    digests as ``(1,)``."""
    arr = np.ascontiguousarray(arr)
    for part in (key, arr.dtype.str, str(arr.shape)):
        crc = zlib.crc32(part.encode(), crc)
    return zlib.crc32(memoryview(arr.reshape(-1)).cast("B"), crc)


def _tag(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return _TAG_OF.get(leaf.dtype, "")
    return ""


def _encode(leaf) -> np.ndarray:
    """A leaf → the host array stored for it (bit-views for tagged dtypes)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        tag = _TAG_OF.get(t.dtype)
        if tag:
            _, tview, npview = _BITCAST[tag]
            return t.view(tview).numpy().view(npview)
        return t.numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _write_entry(zf: zipfile.ZipFile, key: str, arr: np.ndarray) -> None:
    """One ``.npy`` entry, byte for byte what ``np.savez`` writes."""
    arr = np.require(arr, requirements="C")
    with zf.open(key + ".npy", "w", force_zip64=True) as f:
        np.lib.format.write_array_header_1_0(
            f, np.lib.format.header_data_from_array_1_0(arr))
        f.write(memoryview(arr.reshape(-1)).cast("B"))


def save_checkpoint(directory: str, step: int, tree: PyTree) -> str:
    """Write ``tree`` as ``directory/ckpt_{step:08d}.npz``; returns the path."""
    os.makedirs(directory, exist_ok=True)
    flat, _ = tree_flatten_with_path(tree)
    keyed = {}
    for path, leaf in flat:
        tag = _tag(leaf)
        keyed[_path_str(path) + (f"::{tag}" if tag else "")] = leaf
    final = os.path.join(directory, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f, zipfile.ZipFile(f, "w", allowZip64=True) as zf:
            crc = 0
            for key in sorted(keyed):
                arr = _encode(keyed[key])
                crc = _digest_update(crc, key, arr)
                _write_entry(zf, key, arr)
                del arr
            _write_entry(zf, _CHECKSUM_KEY, np.asarray(crc, np.uint32))
        os.replace(tmp, final)
    except BaseException:
        os.remove(tmp)
        raise
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def _decode(arr: np.ndarray, tag: str) -> torch.Tensor:
    """A stored array → a host tensor of the dtype it was saved from."""
    if tag:
        dt, tview, _ = _BITCAST[tag]
        npview = np.int16 if tview == torch.int16 else np.uint8
        return torch.from_numpy(arr.view(npview)).view(dt)
    return torch.from_numpy(arr)


def _restore(t: torch.Tensor, like):
    """Cast to ``like``'s dtype and place it where ``like`` lives."""
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, int) and not isinstance(like, bool):
        return int(t)
    if t.dtype in _TAG_OF:
        t = t.float()
    return t.numpy().astype(np.asarray(like).dtype)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)


def load_checkpoint(directory: str, step: int, like: PyTree) -> PyTree:
    """Restore ``directory/ckpt_{step:08d}.npz`` into the structure of
    ``like``: each leaf cast to ``like``'s dtype and placed on its device
    (tensors), an ``int`` or a numpy array (other leaves). Raises
    :class:`CheckpointCorruptionError` for an unreadable file or a digest
    mismatch, then ``KeyError`` for a leaf the file lacks and
    ``ValueError`` for a shape that differs."""
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    flat, treedef = tree_flatten_with_path(like)
    want = {_path_str(p): leaf for p, leaf in flat}
    got, shapes, stored, crc = {}, {}, None, 0
    try:
        with np.load(path) as data:
            for key in sorted(data.files):
                arr = data[key]
                if key == _CHECKSUM_KEY:
                    stored = int(arr)
                    continue
                crc = _digest_update(crc, key, arr)
                base, _, tag = key.partition("::")
                if base in want:
                    shapes[base] = arr.shape
                    if arr.shape == _shape(want[base]):
                        got[base] = _restore(_decode(arr, tag), want[base])
                del arr
    except FileNotFoundError:
        raise  # absent is absent, not corrupt
    except (zipfile.BadZipFile, zlib.error, ValueError, EOFError, OSError) as e:
        raise CheckpointCorruptionError(
            f"checkpoint {path} is corrupt (unreadable archive: {e})") from e
    if stored is not None and stored != crc:
        raise CheckpointCorruptionError(
            f"checkpoint {path} is corrupt: content checksum mismatch "
            f"(stored {stored:#010x}, computed {crc:#010x})")
    leaves = []
    for key, leaf in want.items():
        if key not in shapes:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        if key not in got:
            raise ValueError(f"{key}: checkpoint shape {shapes[key]} != expected "
                             f"{_shape(leaf)}")
        leaves.append(got[key])
    return treedef.unflatten(leaves)
