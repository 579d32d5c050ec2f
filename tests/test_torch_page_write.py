"""The int8 KV-page write of one layer against ``repro``'s, on the CPU.

* ``ref.absmax_quant_write_pages_ref`` (the plain version of the one-launch
  write ``quantize.absmax_quant_write_pages``) leaves the same pool as the
  reference's ``models.attention._paged_write`` on the int8 route (backend
  ``ref`` and ``pallas_interpret``), f32 and bf16 rows, with page / row maps
  that send idle tokens to the null page: every row of pages ≥ 1 bit-equal
  (codes, scales, the sign of zero), page 0 not compared (tokens that share
  it race there, on the card as in any scatter with duplicate indices);
* the wrapper given CPU tensors returns the plain version's pool and
  launches nothing, rows with a token stride included;
* the port's ``_paged_write`` on the int8 route (``auto`` and ``ref``)
  gives the reference's pool, and on the f32 route its pages as before;
* a continuous serve run on int8 pages calls the write once per layer and
  step, with the layout the kernel takes (each token's (KV, hd) rows
  contiguous, page and row (T,) int32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, to_np  # noqa: F401
from repro.models import attention as jattn
from repro_torch import kernels
from repro_torch.convert import params_from_jax
from repro_torch.kernels import quantize as tquant
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import ModelConfig, dense_stack, init_params

NPAGE, P = 6, 4
POOL_KEYS = ("kq", "vq", "k_scale", "v_scale")


def _rows(rng, T, KV, hd):
    """(T, KV, hd) f32 rows spread over scales, with a zero row, ±0 and
    exact .5 ties among them."""
    x = (rng.normal(size=(T, KV, hd)) * np.exp(rng.normal(size=(T, KV, 1)))).astype(np.float32)
    x[0, 0] = 0.0
    x[0, -1, : hd // 2] = -0.0
    x[-1, 0] = np.float32(127.0)
    x[-1, 0, ::2] = np.arange(hd // 2, dtype=np.float32) % 127 + 0.5
    return x


def _maps(rng, T, n_real):
    """page / row (T,) int32: ``n_real`` tokens at distinct rows of pages ≥ 1,
    the rest on the null page (page 0) at repeated rows, shuffled."""
    slots = rng.permutation((NPAGE - 1) * P)[:n_real]
    page = np.concatenate([1 + slots // P, np.zeros(T - n_real, np.int64)])
    row = np.concatenate([slots % P, rng.integers(0, 2, T - n_real)])
    order = rng.permutation(T)
    return page[order].astype(np.int32), row[order].astype(np.int32)


def _pool(rng, KV, hd):
    """A layer's int8 pool with random earlier contents (rows the write must
    leave alone are then visible)."""
    shape = (NPAGE, P, KV, hd)
    return {"kq": rng.integers(-127, 128, shape).astype(np.int8),
            "vq": rng.integers(-127, 128, shape).astype(np.int8),
            "k_scale": rng.random(shape[:3]).astype(np.float32),
            "v_scale": rng.random(shape[:3]).astype(np.float32)}


def _case(seed, T, n_real, KV, hd, dtype):
    rng = np.random.default_rng(seed)
    k, v = _rows(rng, T, KV, hd), _rows(rng, T, KV, hd)
    page, row = _maps(rng, T, n_real)
    jk, jv = jnp.asarray(k).astype(dtype), jnp.asarray(v).astype(dtype)
    tk = params_from_jax(np.asarray(jk), device="cpu")
    tv = params_from_jax(np.asarray(jv), device="cpu")
    return (jk, jv, tk, tv, page, row, _pool(rng, KV, hd))


def _torch_pool(pool):
    return {key: torch.from_numpy(a.copy()) for key, a in pool.items()}


def _assert_pages_from_one_bit_equal(got: dict, want: dict):
    """Every row of pages ≥ 1 bit-equal (scales as bit patterns)."""
    for key in POOL_KEYS:
        g, w = to_np(got[key])[1:], np.asarray(want[key])[1:]
        if g.dtype == np.float32:
            g, w = g.view(np.uint32), w.view(np.uint32)
        np.testing.assert_array_equal(g, w, err_msg=key)


#: (T tokens, real tokens, KV, hd): decode-like (a few slots, some idle) and
#: prefill-like (a chunk with padded tokens)
SHAPES = [(6, 4, 2, 32), (16, 11, 2, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_write_pages_plain_matches_reference_paged_write(shape, backend, dtype):
    T, n_real, KV, hd = shape
    jk, jv, tk, tv, page, row, pool = _case(T + hd, T, n_real, KV, hd, dtype)
    want = jattn._paged_write({k: jnp.asarray(a) for k, a in pool.items()}, jk, jv,
                              jnp.asarray(page), jnp.asarray(row), backend=backend)
    got = _torch_pool(pool)
    tref.absmax_quant_write_pages_ref(tk, tv, got, torch.from_numpy(page),
                                      torch.from_numpy(row))
    _assert_pages_from_one_bit_equal(got, want)
    touched = np.zeros((NPAGE, P), bool)
    touched[page, row] = True
    assert (to_np(got["kq"])[1:][~touched[1:]] == pool["kq"][1:][~touched[1:]]).all()


@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "token_stride"])
def test_write_pages_wrapper_on_cpu_is_the_plain_version(strided):
    """On CPU tensors the wrapper writes the plain version's pool and
    launches nothing; rows taken with a token stride (k and v halves of one
    (T, 2, KV, hd) buffer) give the pool of their contiguous copies."""
    T, n_real, KV, hd = SHAPES[1]
    _, _, tk, tv, page, row, pool = _case(5, T, n_real, KV, hd, "float32")
    if strided:
        kv = torch.stack([tk, tv], dim=1)
        tk, tv = kv[:, 0], kv[:, 1]
        assert not tk.is_contiguous() and tk.stride(1) == hd
    page_t, row_t = torch.from_numpy(page), torch.from_numpy(row)
    kernels.reset_launch_counts()
    got = _torch_pool(pool)
    assert tquant.absmax_quant_write_pages(tk, tv, got, page_t, row_t) is None
    assert not any(kernels.launch_counts().values()), "a CPU tensor launched a kernel"
    want = _torch_pool(pool)
    tref.absmax_quant_write_pages_ref(tk.contiguous(), tv.contiguous(), want, page_t, row_t)
    for key in POOL_KEYS:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("backend", ["auto", "ref"])
@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "f32"])
def test_port_paged_write_gives_the_reference_pool(quantized, backend):
    T, n_real, KV, hd = SHAPES[0]
    jk, jv, tk, tv, page, row, pool = _case(11, T, n_real, KV, hd, "float32")
    if not quantized:
        rng = np.random.default_rng(3)
        pool = {key: rng.normal(size=(NPAGE, P, KV, hd)).astype(np.float32)
                for key in ("k", "v")}
    want = jattn._paged_write({k: jnp.asarray(a) for k, a in pool.items()}, jk, jv,
                              jnp.asarray(page), jnp.asarray(row), backend="ref")
    got = _torch_pool(pool)
    out = tattn._paged_write(got, tk, tv, torch.from_numpy(page), torch.from_numpy(row),
                             backend=backend)
    assert out is got
    if quantized:
        _assert_pages_from_one_bit_equal(got, want)
    else:
        for key in ("k", "v"):
            np.testing.assert_array_equal(to_np(got[key])[1:], np.asarray(want[key])[1:])


def test_serve_int8_writes_once_per_layer_and_step_in_the_kernels_layout(monkeypatch):
    """A continuous run on int8 pages (a 2-layer GQA LM, prefill chunks and
    decode steps) calls the write once per layer and step, k and v
    together, with rows whose (KV, hd) part is contiguous and (T,) int32
    page and row maps: what the kernel takes on the card."""
    cfg = ModelConfig(name="tiny-gqa", arch_type="dense", d_model=128, num_heads=4,
                      num_kv_heads=2, d_ff=256, vocab_size=512, segments=dense_stack(2),
                      qk_norm=True, head_dim=32)
    params = init_params(0, cfg, device="cpu")
    seen = []
    plain = tquant.absmax_quant_write_pages

    def spy(k_rows, v_rows, cache, page, row):
        T, KV, hd = k_rows.shape
        seen.append(T)
        assert v_rows.shape == k_rows.shape and (KV, hd) == (2, cfg.resolved_head_dim)
        for rows in (k_rows, v_rows):
            assert (rows.stride(1), rows.stride(2)) == (hd, 1)
        for idx in (page, row):
            assert idx.dtype == torch.int32 and tuple(idx.shape) == (T,)
            assert T <= 1 or idx.stride(0) == 1
        return plain(k_rows, v_rows, cache, page, row)

    monkeypatch.setattr(tquant, "absmax_quant_write_pages", spy)
    reqs = tserve.make_workload(cfg, tserve.parse_requests("9:6,3:4,14:5,6:7,2:3"))
    kernels.reset_launch_counts()
    rep = tserve.run_continuous(params, cfg, reqs, slots=3, page_size=4, chunk=4,
                                quantized=True, npage=8)
    assert not any(kernels.launch_counts().values())
    assert len(seen) == cfg.num_layers * (rep.prefill_chunks + rep.decode_steps) > 0
    assert seen.count(3) == cfg.num_layers * rep.decode_steps  # decode: one token a slot
    assert seen.count(4) == cfg.num_layers * rep.prefill_chunks  # prefill: a chunk
