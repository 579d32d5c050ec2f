"""The port's trainer end to end on the CPU, and the port's boundaries.

* ``Trainer(..., device="cpu")`` trains a reduced dense LM for 4 steps in
  both round shapes: the loss stays finite and each step's ledger entry is
  ``wire.seeded_randk_bits`` on compressed rounds, 32·d on sync rounds;
  the step hook sees every step, and a profiler sees the trainer's spans.
  The same for ``vr_marina`` × permk (ledger ``wire.permk_bits``) and
  ``pp_marina`` × block_randk (ledger ``wire.pp_*_total_bits`` / n), and
  for all three on the packed QSGD wire (``wire.block_qsgd_bits``) and with
  a QSGD downlink, whose per-step down ledger is the Q_down payload on
  compressed rounds and 32·d on sync rounds; the downlink's refusals (non
  marina-family methods, PermK), and without a flat engine the per-leaf
  compressor it names.
* ``repro_torch`` (its checkpoint store, problems and data pipeline
  among the modules), ``chip_smoke.py`` and the example twins import
  neither ``jax`` nor ``repro`` (checked in a fresh interpreter).
* Entry points default to the card and raise without one: the trainer,
  model init, the engine, the data stream and the prefix embeddings, the
  problem makers, the seeded offsets and the converters from the
  reference's arrays.
* Checkpoints: a run resumed from a checkpoint equals the uninterrupted run
  bit for bit (params, g, h, step, c_k), its ledgers continuing from the
  float32 values saved, as the reference's do; older layouts (no
  skipped-rounds ledger, no downlink ledger, a bare state) resume through
  the reference's three fallback tiers, and a corrupt file raises
  ``CheckpointCorruptionError`` through them. Prefix embeddings and the
  Dirichlet data dial run through the trainer.
"""

import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointCorruptionError, load_checkpoint, save_checkpoint

from _torch_parity import one_torch_thread  # noqa: F401
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import make_engine, wire
from repro_torch.core.flat import seeded_offsets
from repro_torch.core import problems
from repro_torch.core.problems import make_synthetic_binclass
from repro_torch.data import HeterogeneousLMData, make_prefix_embeddings, worker_batches
from repro_torch.core.tree_util import tree_leaves
from repro_torch.models import ModelConfig, dense_stack, init_params
from repro_torch.train import TrainConfig, Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = ModelConfig(name="tiny-dense", arch_type="dense", d_model=64, num_heads=4,
                  num_kv_heads=2, d_ff=128, vocab_size=256,
                  segments=dense_stack(2), qkv_bias=True, tie_embeddings=True,
                  rope_theta=1_000_000.0)


def _tc(carry, method="marina", compressor="block_randk", **kw):
    comp_kwargs = {"permk": {"block": 128}, "block_qsgd": {"s": 7, "block": 128}}.get(
        compressor, {"kb": 8, "block": 128})
    kw = {"n_workers": 2, **kw}
    return TrainConfig(method=method, compressor=compressor,
                       comp_kwargs=comp_kwargs, gamma=0.05, p=0.5,
                       batch_per_worker=2, steps=4, log_every=2,
                       carry_grads=carry, **kw)


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
def test_trainer_cpu_smoke_and_ledger(carry):
    params = init_params(0, CFG, device="cpu")
    tr = Trainer(CFG, _tc(carry), params, device="cpu")
    hooked = []
    state, hist = tr.run(hooked.append)
    assert hooked == [0, 1, 2, 3]
    d = sum(t.numel() for t in tree_leaves(params))
    nblk = math.ceil(d / 128)
    assert all(math.isfinite(v) for v in hist.loss)
    assert set(hist.round_sync) == {0, 1}
    for c_k, bits in zip(hist.round_sync, hist.round_bits):
        assert bits == (wire.dense_f32_bits(d) if c_k
                        else wire.seeded_randk_bits(nblk, 8))
    assert hist.bits_cum[-1] == sum(hist.round_bits)
    assert hist.skipped_cum[-1] == 0.0
    assert len(hist.step_seconds) == 4


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
@pytest.mark.parametrize("method", ["vr_marina", "pp_marina"])
def test_trainer_vr_and_pp_cpu_smoke_and_ledger(method, carry):
    """VR-MARINA on the permk wire, PP-MARINA (r = 2 of 4) on block_randk:
    4 steps, finite loss, both round types, ledgers equal to the wire
    formulas."""
    if method == "vr_marina":
        tc = _tc(carry, method, "permk", mb_per_worker=1)
    else:
        tc = _tc(carry, method, n_workers=4, r_participating=2)
    params = init_params(0, CFG, device="cpu")
    tr = Trainer(CFG, tc, params, device="cpu")
    assert tr.engine is not None and tr.engine.sampler == (
        "permk" if method == "vr_marina" else "randk")
    _, hist = tr.run()
    d = sum(t.numel() for t in tree_leaves(params))
    nblk = math.ceil(d / 128)
    n = tc.n_workers
    assert all(math.isfinite(v) for v in hist.loss)
    assert set(hist.round_sync) == {0, 1}
    for c_k, bits in zip(hist.round_sync, hist.round_bits):
        if method == "vr_marina":
            want = wire.dense_f32_bits(d) if c_k else wire.permk_bits(nblk * 128, n)
        else:
            want = (wire.pp_sync_total_bits(n, d) if c_k else wire.pp_uplink_total_bits(
                2, wire.seeded_randk_bits(nblk, 8))) / n
        assert bits == want
    assert hist.bits_cum[-1] == sum(hist.round_bits)
    assert hist.skipped_cum[-1] == 0.0


def test_trainer_pp_oracle_ledger_sums_float32_rounds_per_chunk():
    """PP-MARINA at r = 2 of n = 3, recompute rounds (two gradients a
    cohort member), books float32(2·2/3) a compressed round, as the
    reference does (``tests/test_torch_problems.py`` holds the round's
    value to it exactly), and the ledger sums each log interval's rounds in
    float32 before adding them, as the reference's scan carries them: 8
    steps logged every 4."""
    tc = dataclasses.replace(_tc(False, "pp_marina", n_workers=3, r_participating=2),
                             steps=8, log_every=4)
    tr = Trainer(CFG, tc, init_params(0, CFG, device="cpu"), device="cpu")
    _, hist = tr.run()
    assert 0 in hist.round_sync and 1 in hist.round_sync
    want, total = [0.0], 0.0
    for lo in range(0, 8, 4):
        chunk = np.float32(0.0)
        for c_k in hist.round_sync[lo:lo + 4]:
            chunk = np.float32(chunk + (np.float32(1.0) if c_k else np.float32(2 * 2 / 3)))
        total += float(chunk)
        want.append(total)
    assert hist.oracle_cum == want


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
@pytest.mark.parametrize("method", ["marina", "vr_marina", "pp_marina"])
@pytest.mark.parametrize("wire_kind", ["block_qsgd", "downlink"])
def test_trainer_qsgd_and_downlink_cpu_smoke_and_ledger(wire_kind, method, carry):
    """The packed QSGD uplink, or a RandK uplink under a QSGD downlink: 4
    steps, finite loss, both round types, up and down ledgers per step equal
    to the wire formulas."""
    kw = dict(n_workers=4, r_participating=2, mb_per_worker=1)
    if wire_kind == "block_qsgd":
        tc = _tc(carry, method, "block_qsgd", **kw)
    else:
        tc = _tc(carry, method, downlink="qsgd", downlink_kwargs={"s": 7}, **kw)
    params = init_params(0, CFG, device="cpu")
    tr = Trainer(CFG, tc, params, device="cpu")
    _, hist = tr.run()
    d = sum(t.numel() for t in tree_leaves(params))
    nblk = math.ceil(d / 128)
    qsgd = wire.block_qsgd_bits(nblk, 128, 7)
    up_q = qsgd if wire_kind == "block_qsgd" else wire.seeded_randk_bits(nblk, 8)
    down_q = qsgd if wire_kind == "downlink" else wire.downlink_dense_bits(d)
    assert tr.engine.sampler == ("qsgd" if wire_kind == "block_qsgd" else "randk")
    assert (tr.down_engine is None) == (wire_kind == "block_qsgd")
    assert all(math.isfinite(v) for v in hist.loss)
    assert set(hist.round_sync) == {0, 1}
    for c_k, up, down in zip(hist.round_sync, hist.round_bits, hist.round_down_bits):
        if method == "pp_marina":
            want = (wire.pp_sync_total_bits(4, d) if c_k
                    else wire.pp_uplink_total_bits(2, up_q)) / 4
        else:
            want = wire.dense_f32_bits(d) if c_k else up_q
        assert up == want
        assert down == (wire.dense_f32_bits(d) if c_k else down_q)
    assert hist.bits_cum[-1] == sum(hist.round_bits)
    assert hist.down_cum[-1] == sum(hist.round_down_bits)
    assert hist.skipped_cum[-1] == 0.0


def test_trainer_block_qsgd_default_p_is_bits_balanced():
    from repro_torch.core import BlockQSGD

    params = init_params(0, CFG, device="cpu")
    tc = _tc(False, compressor="block_qsgd")
    tc.p = None
    tr = Trainer(CFG, tc, params, device="cpu")
    d = sum(t.numel() for t in tree_leaves(params))
    assert tr.p == BlockQSGD(s=7, block=128).default_p(d)
    assert (tr.engine.sampler, tr.engine.s) == ("qsgd", 7)


def test_trainer_downlink_refusals():
    """A downlink refuses loudly where it cannot be wired: on methods
    outside the MARINA family (the broadcast would stay dense while the user
    believes it compressed) and for PermK over an engine (a partition, not a
    broadcast). Without a flat engine it is the named per-leaf compressor."""
    params = init_params(0, CFG, device="cpu")
    for method in ("diana", "dcgd", "ec_sgd", "gd"):
        with pytest.raises(ValueError, match="downlink"):
            Trainer(CFG, _tc(False, method, downlink="qsgd"), params, device="cpu")
    with pytest.raises(ValueError, match="broadcastable"):
        Trainer(CFG, _tc(False, downlink="permk"), params, device="cpu")
    tr = Trainer(CFG, _tc(False, downlink="natural"), params, device="cpu")
    assert tr.down_engine.sampler == "natural"  # ported: no refusal
    tc = _tc(False, downlink="qsgd")
    tc.compressor, tc.comp_kwargs = "randk", {"k": 0.01}  # the per-leaf tree path
    tr = Trainer(CFG, tc, params, device="cpu")
    assert tr.down_engine is None and tr.down_comp.name == "qsgd"
    assert tr.method.down_compressor is tr.down_comp


def test_trainer_methods_not_ported_raise():
    """Every method of the reference is ported now: the baselines build, and
    only an unknown method raises."""
    params = init_params(0, CFG, device="cpu")
    assert TrainConfig().method == "vr_marina"  # the reference's default
    for method in ("diana", "dcgd", "ec_sgd", "gd"):
        Trainer(CFG, _tc(False, method), params, device="cpu")
    with pytest.raises(ValueError):
        Trainer(CFG, _tc(False, "adam"), params, device="cpu")


def test_trainer_profiler_spans():
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.trainer import SPAN_GRAD, SPAN_STEP

    tr = Trainer(CFG, _tc(True), init_params(0, CFG, device="cpu"), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.run()
    names = [e.name for e in prof.events()]
    # one step span per step; one gradient span per worker in init and steps
    assert names.count(SPAN_STEP) == 4
    assert names.count(SPAN_GRAD) == 2 * (1 + 4)


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for name in ('quickstart_torch', 'federated_pp_torch', 'train_lm_torch',\n"
        "             'serve_lm_torch'):\n"
        "    spec = importlib.util.spec_from_file_location(name, f'examples/{name}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "spec = importlib.util.spec_from_file_location('cat', 'scripts/check_async_torch.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "new = ('repro_torch.checkpoint.store', 'repro_torch.core.problems',\n"
        "       'repro_torch.data.pipeline', 'repro_torch.models.moe',\n"
        "       'repro_torch.configs.deepseek_v3_671b', 'repro_torch.models.ssm',\n"
        "       'repro_torch.configs.recurrentgemma_2b', 'repro_torch.configs.xlstm_350m',\n"
        "       'repro_torch.launch.topology', 'repro_torch.launch.transport',\n"
        "       'repro_torch.launch.distributed', 'repro_torch.launch.participation',\n"
        "       'repro_torch.launch.sharding', 'repro_torch.launch.train')\n"
        "assert all(m in sys.modules for m in new), new\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep + ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every submodule was imported


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(CFG, _tc(False), init_params(0, CFG, device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(0, CFG)
    for call in (
        lambda: make_engine({"v": torch.zeros(300)}),
        lambda: make_synthetic_binclass(0, 2, 4, 8),
        lambda: problems.make_quadratic(0, 2, 4),
        lambda: problems.make_shifted_quadratics(0, 2, 4),
        lambda: problems.make_dirichlet_binclass(0, 2, 4, 8, alpha=0.1),
        lambda: make_prefix_embeddings(np.zeros(2, np.uint32), 1, 1, 1, 4),
        lambda: params_from_jax({"v": [1.0]}),
        lambda: state_from_jax({"v": [1.0]}, {"v": [0.0]}, 0),
        lambda: worker_batches(HeterogeneousLMData(2, 256, 8), 0, 1),
        lambda: seeded_offsets(7, 3, 128, 8),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_trainer_nan_guard_skips_poisoned_rounds():
    """A ``nan`` client under the plain mean: the guard reverts each poisoned
    round and counts it, and the state stays finite (the reference's
    ``test_trainer_nan_guard_skips_poisoned_rounds``); the robust dials are
    MARINA-family only."""
    cfg = ModelConfig(name="rg", arch_type="dense", d_model=32, num_heads=2,
                      num_kv_heads=2, d_ff=64, vocab_size=64, segments=dense_stack(1))
    params = init_params(0, cfg, device="cpu")
    tc = TrainConfig(method="marina", compressor="qsgd", comp_kwargs={"s": 7}, gamma=0.02,
                     n_workers=4, steps=8, log_every=4, faults="nan", faults_frac=0.25)
    st, hist = Trainer(cfg, tc, params, device="cpu").run()
    assert hist.skipped_cum[-1] > 0
    assert math.isfinite(hist.loss[-1])
    assert all(torch.isfinite(t).all() for t in tree_leaves(st.params))
    for kw in ({"faults": "nan"}, {"aggregator": "krum"}):
        with pytest.raises(ValueError, match="marina-family"):
            Trainer(cfg, dataclasses.replace(tc, **{"method": "dcgd", "faults": "none", **kw}),
                    params, device="cpu")


@pytest.mark.parametrize("carry", [False, True], ids=["recompute", "carry"])
def test_trainer_robust_dials_build_and_run(carry):
    """aggregator / faults build a ServerAggregator / FaultSpec only when they
    differ from the honest defaults; a trimmed-mean run under sign_flip on the
    packed QSGD engine stays finite and books the wire formulas, a drop run
    (carry) books (n − f)/n of ζ on compressed rounds."""
    from repro_torch.core import FaultSpec, ServerAggregator

    params = init_params(0, CFG, device="cpu")
    honest = Trainer(CFG, _tc(carry, compressor="block_qsgd", n_workers=3), params,
                     device="cpu")
    assert honest.method.aggregator is None and honest.method.faults is None
    tc = _tc(carry, compressor="block_qsgd", n_workers=3, aggregator="trimmed_mean",
             aggregator_f=1, faults="sign_flip", faults_frac=0.34, faults_scale=10.0)
    tr = Trainer(CFG, tc, params, device="cpu")
    assert tr.method.aggregator == ServerAggregator("trimmed_mean", 1)
    assert tr.method.faults == FaultSpec("sign_flip", frac=0.34, scale=10.0)
    _, hist = tr.run()
    d = sum(t.numel() for t in tree_leaves(params))
    nblk = math.ceil(d / 128)
    assert all(math.isfinite(v) for v in hist.loss) and hist.skipped_cum[-1] == 0.0
    for c_k, bits in zip(hist.round_sync, hist.round_bits):
        assert bits == (wire.dense_f32_bits(d) if c_k else wire.block_qsgd_bits(nblk, 128, 7))
    if carry:
        tc = _tc(True, n_workers=4, faults="drop", faults_frac=0.25)
        _, hist = Trainer(CFG, tc, params, device="cpu").run()
        zeta = wire.seeded_randk_bits(nblk, 8)
        for c_k, bits in zip(hist.round_sync, hist.round_bits):
            assert bits == (wire.dense_f32_bits(d) if c_k
                            else float(np.float32(zeta) * np.float32(0.75)))


def _leaves(state):
    from repro_torch.core.tree_util import tree_flatten_with_path

    return [leaf for _, leaf in tree_flatten_with_path(state)[0]]


def _bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, int):
            assert x == y
        else:
            assert x.dtype == y.dtype and torch.equal(x.view(torch.int32), y.view(torch.int32))


_f32 = lambda v: float(np.float32(v))  # noqa: E731


@pytest.mark.parametrize("method,carry", [("marina", False), ("marina", True),
                                          ("vr_marina", True), ("pp_marina", True)])
def test_resumed_run_equals_uninterrupted(tmp_path, method, carry):
    """U: 4 steps; A: steps 0-1, saving after step 1; B: the same config on
    A's directory, resumed at step 2. B's state equals U's bit for bit; its
    ledgers start from A's as saved (float32) and add B's rounds exactly;
    its anchor log is step 1 with the eval at step 2."""
    kw = dict(n_workers=4, r_participating=2, mb_per_worker=1, alpha=0.1)
    base = (_tc(carry, method, "permk", **kw) if method == "vr_marina"
            else _tc(carry, method, **kw))
    tc = lambda **k: dataclasses.replace(base, **k)  # noqa: E731
    params = init_params(0, CFG, device="cpu")
    d = str(tmp_path)
    s_u, h_u = Trainer(CFG, tc(), params, device="cpu").run()
    _, h_a = Trainer(CFG, tc(steps=2, ckpt_dir=d, ckpt_every=2), params, device="cpu").run()
    assert sorted(os.listdir(d)) == ["ckpt_00000001.npz"]
    s_b, h_b = Trainer(CFG, tc(ckpt_dir=d), params, device="cpu").run()
    _bit_equal(s_u, s_b)
    assert h_b.round_sync == h_u.round_sync[2:] and h_b.round_bits == h_u.round_bits[2:]
    assert h_b.step == [1, 3]
    for cum, a, rounds in ((h_b.bits_cum, h_a.bits_cum, h_b.round_bits),
                           (h_b.down_cum, h_a.down_cum, h_b.round_down_bits)):
        assert cum[0] == _f32(a[-1])
        assert cum[-1] == _f32(a[-1]) + sum(rounds)
    assert h_b.oracle_cum[0] == _f32(h_a.oracle_cum[-1])
    assert len(os.listdir(d)) == 1  # ckpt_every = 0: B saves nothing


def test_resume_fallback_tiers_and_corrupt_file(tmp_path):
    """Checkpoints of the older layouts resume with the ledgers they hold
    (no skipped-rounds ledger; no downlink ledger either; a bare state with
    zeroed ledgers), B's state bit-equal to U's each time; a corrupt file
    raises CheckpointCorruptionError, not a fallback."""
    tc = lambda **k: dataclasses.replace(_tc(True), **k)  # noqa: E731
    params = init_params(0, CFG, device="cpu")
    s_u, _ = Trainer(CFG, tc(), params, device="cpu").run()
    full = str(tmp_path / "full")
    _, h_a = Trainer(CFG, tc(steps=2, ckpt_dir=full, ckpt_every=2), params,
                     device="cpu").run()
    tr = Trainer(CFG, tc(), params, device="cpu")
    like_state = tr.method.init(tr.params0, tr._batches(0, 2))
    saved = load_checkpoint(full, 1, {"state": like_state, **{
        k: np.zeros((), np.float32) for k in ("bits", "down", "oracle", "skipped")}})
    bits, down = _f32(h_a.bits_cum[-1]), _f32(h_a.down_cum[-1])
    for name, keep, want in (("no_skipped", ("bits", "down", "oracle"), (bits, down)),
                             ("no_down", ("bits", "oracle"), (bits, 0.0)),
                             ("bare", None, (0.0, 0.0))):
        d = str(tmp_path / name)
        tree = saved["state"] if keep is None else {
            "state": saved["state"], **{k: saved[k] for k in keep}}
        save_checkpoint(d, 1, tree)
        s_b, h_b = Trainer(CFG, tc(ckpt_dir=d), params, device="cpu").run()
        _bit_equal(s_u, s_b)
        assert (h_b.bits_cum[0], h_b.down_cum[0]) == want, name
        assert h_b.skipped_cum[0] == 0.0
    path = os.path.join(full, "ckpt_00000001.npz")
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with pytest.raises(CheckpointCorruptionError):
        Trainer(CFG, tc(ckpt_dir=full), params, device="cpu").run()


def test_trainer_prefix_embeddings_and_dirichlet_data():
    """prefix_len gives every batch (n, b, P, d_model) embeddings from
    fold_in(PRNGKey(seed + 7), step); the loss covers the token positions;
    alpha switches the token streams to the Dirichlet dial."""
    from repro_torch import prng
    from repro_torch.models import lm_loss

    params = init_params(0, CFG, device="cpu")
    tr = Trainer(CFG, _tc(True, alpha=0.1), params, prefix_len=3, device="cpu")
    assert tr.data.alpha == 0.1
    b = tr._batches(5, 2)
    assert b["prefix"].shape == (2, 2, 3, CFG.d_model)
    assert torch.equal(b["prefix"], make_prefix_embeddings(
        prng.fold_in(prng.PRNGKey(7), 5), 2, 2, 3, CFG.d_model, device="cpu"))
    want = np.mean([float(lm_loss(params, CFG, b["tokens"][w], b["prefix"][w]))
                    for w in range(2)])
    assert tr.eval_loss(params, 5) == pytest.approx(want, rel=1e-6)
    _, hist = tr.run()
    assert all(math.isfinite(v) for v in hist.loss) and hist.skipped_cum[-1] == 0.0
