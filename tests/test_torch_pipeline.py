"""The port's ``data/pipeline.py`` against ``repro.data.pipeline``.

* ``dirichlet_partition``: given the reference's proportions, the shards
  are the reference's, index for index (the shuffle is seeded from
  ``prng.bits(key)``, bit-equal to ``jax.random.bits``); they cover every
  index once.
* ``dirichlet_proportions``: numpy's Dir(α) rows under
  ``prng.key_to_seed(key)``; the uniform mixture for α = None or ∞; rows
  summing to 1, concentrated at α = 0.1.
* ``client_weights_from_counts`` equals the reference's.
* ``make_prefix_embeddings`` within 3 ulp × 0.02 of the reference's (plus
  the product's own rounding): ``prng.normal`` is within 3 ulp of
  ``jax.random.normal``.
* The Dirichlet token streams: each worker's π comes from the reference's
  key ``fold_in(PRNGKey(seed + 101), worker)``; batches are deterministic,
  in range, and narrower per worker at α = 0.1 than at α = ∞ (the
  reference's ``test_lm_data_alpha_deterministic_and_skewed``);
  ``lm_batch_iterator`` yields ``worker_batches`` from its start step.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro.data import pipeline as jpipe
from repro_torch import prng
from repro_torch.data import pipeline as tpipe


@pytest.mark.parametrize("n_clients,n_classes,alpha,seed",
                         [(6, 5, 0.5, 4), (3, 2, 0.1, 11), (8, 10, 5.0, 0)])
def test_dirichlet_partition_shards_equal_given_the_proportions(
        monkeypatch, n_clients, n_classes, alpha, seed):
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, 300)
    want = jpipe.dirichlet_partition(key, labels, n_clients, alpha)
    props = np.asarray(jpipe.dirichlet_proportions(key, n_clients, n_classes, alpha))
    monkeypatch.setattr(tpipe, "dirichlet_proportions", lambda *args: props)
    got = tpipe.dirichlet_partition(np.asarray(key), labels, n_clients, alpha)
    assert len(got) == len(want) == n_clients
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.sort(np.concatenate(got)), np.arange(len(labels)))


def test_dirichlet_proportions_are_numpy_rows_under_the_key():
    key = jax.random.PRNGKey(4)
    seed = int(np.asarray(jax.random.bits(key)))
    assert prng.key_to_seed(np.asarray(key)) == seed
    ps = tpipe.dirichlet_proportions(np.asarray(key), 16, 8, 0.1)
    want = np.random.default_rng(seed).dirichlet(np.full(8, 0.1), 16).astype(np.float32)
    np.testing.assert_array_equal(ps, want)
    np.testing.assert_allclose(ps.sum(-1), 1.0, atol=1e-5)
    assert ps.max(-1).mean() > 0.6  # skewed clients
    for alpha in (None, np.inf):
        pu = tpipe.dirichlet_proportions(np.asarray(key), 8, 4, alpha)
        np.testing.assert_array_equal(
            pu, np.asarray(jpipe.dirichlet_proportions(key, 8, 4, np.inf)))


def test_client_weights_from_counts_match_reference():
    counts = [17, 3, 40, 0, 9]
    np.testing.assert_array_equal(tpipe.client_weights_from_counts(counts).numpy(),
                                  np.asarray(jpipe.client_weights_from_counts(counts)))


def test_prefix_embeddings_within_three_ulp_of_reference():
    for seed in (7, 8):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
        want = np.asarray(jpipe.make_prefix_embeddings(key, 2, 3, 4, 64))
        got = tpipe.make_prefix_embeddings(np.asarray(key), 2, 3, 4, 64, device="cpu")
        assert got.dtype == torch.float32 and got.shape == want.shape
        unit = np.abs(want / np.float32(0.02))
        bound = 3 * np.spacing(unit) * 0.02 + np.spacing(np.abs(want))
        assert (np.abs(got.numpy() - want) <= bound).all()


def test_lm_data_spec_matches_reference():
    t = tpipe.make_lm_data(4, 256, 32, seed=3, heterogeneity=0.5, alpha=0.1)
    j = jpipe.make_lm_data(4, 256, 32, seed=3, heterogeneity=0.5, alpha=0.1)
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name


def test_dirichlet_token_streams_use_the_reference_keys_and_skew():
    data = tpipe.make_lm_data(4, 256, 32, seed=0, alpha=0.1)
    for w, row in enumerate(tpipe._worker_mixtures(data).numpy()):
        k = jax.random.fold_in(jax.random.PRNGKey(101), w)  # the reference's key
        rng = np.random.default_rng(int(np.asarray(jax.random.bits(k))))
        np.testing.assert_array_equal(
            row, rng.dirichlet(np.full(data.n_regions, 0.1)).astype(np.float32))
    b1 = tpipe.worker_batches(data, 3, 2, device="cpu")
    b2 = tpipe.worker_batches(data, 3, 2, device="cpu")
    assert torch.equal(b1, b2) and b1.shape == (4, 2, 32)
    assert int(b1.min()) >= 0 and int(b1.max()) < 256
    data_iid = tpipe.make_lm_data(4, 256, 32, seed=0, alpha=np.inf)
    b_iid = tpipe.worker_batches(data_iid, 3, 2, device="cpu")
    spread = b1.reshape(4, -1).double().std(dim=1).mean()
    spread_iid = b_iid.reshape(4, -1).double().std(dim=1).mean()
    assert spread < spread_iid  # skewed streams are narrower per worker
    legacy = tpipe.make_lm_data(4, 256, 32, seed=0)
    assert not torch.equal(tpipe.worker_batches(legacy, 3, 2, device="cpu"), b1)


def test_lm_batch_iterator_yields_the_steps_batches():
    data = tpipe.make_lm_data(2, 64, 8, seed=1, alpha=0.3)
    it = tpipe.lm_batch_iterator(data, 3, start_step=5, device="cpu")
    for step in (5, 6, 7):
        assert torch.equal(next(it), tpipe.worker_batches(data, step, 3, device="cpu"))
