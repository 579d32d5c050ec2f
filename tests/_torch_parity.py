"""Helpers shared by the PyTorch-port parity tests (tests/test_torch_*.py)."""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a test file's torch work on one thread (imported by each port test
    file, where it applies to every test). The tier-1 suite runs six pytest
    workers at once; a torch op spread over every core in each of them makes
    the workers contend until small ops run tens of times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_np(x) -> np.ndarray:
    """Tensor or JAX array → numpy (bf16 as its raw int16 bits)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.int16)
    return arr


def ulp_diff(a, b) -> int:
    """Largest distance in units in the last place between two float arrays
    of one dtype (f32, or bf16 given as raw int16 bits by :func:`to_np`),
    computed on the bit patterns (±0 are one apart only by sign: equal)."""
    a, b = to_np(a), to_np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype == np.float32:
        ia, ib, top = a.view(np.int32), b.view(np.int32), 2**31
    else:
        assert a.dtype == b.dtype == np.int16, (a.dtype, b.dtype)
        ia, ib, top = a, b, 2**15
    ia, ib = ia.astype(np.int64), ib.astype(np.int64)
    ka = np.where(ia < 0, -top - ia, ia)
    kb = np.where(ib < 0, -top - ib, ib)
    return int(np.max(np.abs(ka - kb))) if ka.size else 0


def close_except_flips(got, want, step, rtol, atol_scale=False) -> int:
    """Within rtol / atol 1e-6 (or rtol of the largest magnitude, with
    ``atol_scale``), except at flagged coordinates, which must lie within
    ``step`` (one quantization step); returns how many were flagged."""
    got = np.asarray(got, np.float64).reshape(-1)
    want = np.asarray(want, np.float64).reshape(-1)
    err = np.abs(got - want)
    tol = rtol * np.abs(want).max() if atol_scale else 1e-6 + rtol * np.abs(want)
    flagged = err > tol
    assert (err[flagged] <= step * (1 + 1e-4)
            + np.broadcast_to(tol, err.shape)[flagged]).all(), (err[flagged].max(), step)
    return int(flagged.sum())


def ordered_scatter_mean(v: np.ndarray, o: np.ndarray, B: int) -> np.ndarray:
    """The scatter-mean of (n, nblk, kb) f32 values at int32 offsets as a
    numpy loop in the oracle's order (w, then t) per block, each add and the
    final ÷ n rounded once in f32; offsets outside [0, B) skipped."""
    n, nblk, kb = v.shape
    acc = np.zeros((nblk, B), np.float32)
    for b in range(nblk):
        for w in range(n):
            for t in range(kb):
                if 0 <= o[w, b, t] < B:
                    acc[b, o[w, b, t]] = np.float32(acc[b, o[w, b, t]] + v[w, b, t])
    return acc / np.float32(n)
