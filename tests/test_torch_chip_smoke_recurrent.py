"""``chip_smoke.py``'s recurrent phase rehearsed on the CPU at a tiny size
(``chip_smoke.DEVICE = "cpu"``, the device-memory counters stubbed, every
kernel wrapper counting a launch where it returns its plain version):

* the static legs on recurrentgemma-2b (RG-LRU, RG-LRU, sliding-window
  attention at d_model 64; prompts past the reduced window of 16) and on an
  xLSTM of one mLSTM and one sLSTM layer: no launches, full streams, the
  teacher-forced check (xLSTM's again in float64), the xLSTM state's bytes
  equal at every length;
* the xLSTM training leg: exactly ``MAIN_LAUNCHES["marina_randk_carry"]``
  under ``RECURRENT_TRAIN_PATH``, c_k, the ledgers, the plain run's params;
* the reduced recurrent families through the trainer (the small-input
  phase's ``SMALL_RECURRENT``, recurrentgemma-2b here);
* sampling at T = 0.7 on a tiny GQA LM: two runs of each path identical,
  the continuous path's launches and its streams against the plain run's
  (plain against plain here: identical), the Gumbel draws' check.

The file is separate from ``tests/test_torch_chip_smoke.py`` so that the
two spread over the suite's workers.
"""

import dataclasses
import os
import sys

import torch

import repro_torch.configs as configs
from _torch_parity import one_torch_thread  # noqa: F401
from repro_torch import kernels
from repro_torch.models import LayerSpec, ModelConfig, Segment, dense_stack, reduced

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from test_torch_chip_smoke import _serve_on_cpu  # noqa: E402

TINY_GQA = ModelConfig(name="tiny-gqa", arch_type="dense", d_model=64, num_heads=4,
                       num_kv_heads=2, d_ff=128, vocab_size=256, segments=dense_stack(2),
                       qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0)


def _tiny_recurrent(monkeypatch):
    """get_arch → recurrentgemma-2b reduced to 3 layers at d_model 64, an
    xLSTM of one mLSTM and one sLSTM layer at d_model 32 (so the trainer's
    sequences are 128 tokens), and the tiny GQA LM for the serve paths."""
    real = configs.get_arch

    def tiny(name):
        arch = real(name)
        if name == "recurrentgemma-2b":
            model = reduced(arch.model, layers=3, d_model=64)
        elif name == "xlstm-350m":
            model = dataclasses.replace(
                reduced(arch.model, layers=8, d_model=32),
                segments=(Segment(period=(LayerSpec("mlstm", "none"),
                                          LayerSpec("slstm", "none")), repeat=1),))
        else:
            model = TINY_GQA
        return dataclasses.replace(arch, model=model)
    monkeypatch.setattr(configs, "get_arch", tiny)


def test_recurrent_phase_runs_at_a_tiny_width(monkeypatch):
    _serve_on_cpu(monkeypatch)
    _tiny_recurrent(monkeypatch)
    monkeypatch.setattr(chip_smoke, "RECURRENT_STATIC", {
        "recurrentgemma-2b": ("22:6,22:6", 2), "xlstm-350m": ("12:6,12:6", 2)})
    monkeypatch.setattr(chip_smoke, "SMALL_RECURRENT", {"recurrentgemma-2b": 3})
    monkeypatch.setattr(chip_smoke, "SERVE_SPEC", "12:5,5:3,9:4,3:2,7:6")
    monkeypatch.setattr(chip_smoke, "SERVE_SLOTS", 3)
    monkeypatch.setattr(chip_smoke, "SERVE_PAGE", 4)
    monkeypatch.setattr(chip_smoke, "SERVE_CHUNK", 4)
    monkeypatch.setattr(chip_smoke, "SERVE_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "RECURRENT_BUDGET_S", 1e6)
    report = {}
    launches = chip_smoke.run_recurrent(report)
    kernels.reset_launch_counts()
    assert set(launches) == {chip_smoke.RECURRENT_TRAIN_PATH, "sampled_serve_continuous"}
    want = chip_smoke.MAIN_LAUNCHES["marina_randk_carry"]
    assert {k: v for k, v in launches[chip_smoke.RECURRENT_TRAIN_PATH].items() if v} == want
    rec = report["recurrent"]
    for name in chip_smoke.RECURRENT_STATIC:
        leg = rec[name]
        tf = leg["serve_static"]["teacher_forced"]
        assert tf["steps"] == chip_smoke.FAMILY_TEACHER_STEPS
        assert tf["max_rel_logit_err"] <= chip_smoke.FAMILY_LOGIT_RTOL
        assert leg["seconds"] > 0 and leg["reduced"] == []
    xl = rec["xlstm-350m"]
    assert len(set(xl["state_bytes"].values())) == 1
    assert xl["teacher_forced_f64"]["dtype"] == "torch.float64"
    assert xl["teacher_forced_f64"]["max_rel_logit_err"] <= 1e-9
    assert xl["serve_static"]["teacher_forced"]["bound"] == \
        chip_smoke.RECURRENT_F32_RTOL["xlstm-350m"]
    train = xl["train"]
    assert train["c_k"] == chip_smoke.MAIN_C_K and train["max_abs_param_diff"] == 0.0
    assert set(train["median_step_s"]) == {"sync", "compressed"}
    chip_smoke.check_families_small_input(report, chip_smoke.SMALL_RECURRENT,
                                          "small_input_recurrent")
    kernels.reset_launch_counts()
    assert {name: run["launches"] for name, run in report["small_input_recurrent"].items()} \
        == {"recurrentgemma-2b": chip_smoke.EXPECTED_LAUNCHES["marina_randk_carry"]}
    samp = rec["sampling"]
    cont = samp["sampled_serve_continuous"]
    assert launches["sampled_serve_continuous"]["paged_attn_decode"] == \
        2 * cont["decode_steps"] > 0
    assert cont["diverged"] == []
    assert samp["gumbel"]["uniform_bit_equal"] and samp["gumbel"]["gumbel_bit_equal"]
    assert samp["gumbel"]["shape"] == [3, TINY_GQA.vocab_size]
    assert rec["seconds"] > 0


def test_sampling_draws_differ_from_greedy_and_repeat_under_a_seed(monkeypatch):
    """The sampled paths really sample: at T = 0.7 the tiny LM's streams
    differ from its greedy ones, and the same seed repeats them."""
    from repro_torch.launch import serve
    from repro_torch.models import init_params

    params = init_params(0, TINY_GQA, device="cpu")
    pairs = serve.parse_requests("12:5,5:3,9:4")
    out = []
    for temperature in (0.0, 0.7, 0.7):
        reqs = serve.make_workload(TINY_GQA, pairs)
        serve.run_continuous(params, TINY_GQA, reqs, slots=2, page_size=4, chunk=4,
                             temperature=temperature, seed=chip_smoke.SAMPLE_SEED)
        out.append([r.generated for r in reqs])
    assert out[1] == out[2] != out[0]
    assert torch.get_num_threads() == 1
