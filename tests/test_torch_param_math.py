"""The port's parameter and FLOP accounting (``launch/param_math.py``)
against ``repro.launch.param_math``, at full size from shapes alone (the
port's meta tensors, the reference's ``jax.eval_shape``): ``count_params``,
``count_active_params`` and ``model_flops`` equal for nine configs (the
tenth, deepseek-v3-671b, whose reference shapes take ~50 s to trace, is in
``test_torch_param_math_deepseek.py``); the counts the reference gives are
pinned too, and nothing is allocated.
"""

import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs import get_arch as j_get_arch
from repro.launch import param_math as jpm
from repro_torch.configs import PUBLIC_TO_MODULE, get_arch
from repro_torch.core.tree_util import tree_leaves
from repro_torch.launch import param_math as pm

#: the reference's counts on the CPU: (params, active)
PINNED = {
    "deepseek-v3-671b": (682_636_457_984, 38_240_368_640),
    "llama4-scout-17b-a16e": (107_769_873_408, 17_172_907_008),
    "qwen1.5-0.5b": (463_987_712, 463_987_712),
}

NINE = sorted(n for n in PUBLIC_TO_MODULE if n != "deepseek-v3-671b")


def check_against_reference(name: str) -> None:
    cfg, jcfg = get_arch(name).model, j_get_arch(name).model
    n, act = pm.count_params(cfg), pm.count_active_params(cfg)
    assert n == jpm.count_params(jcfg)
    assert act == jpm.count_active_params(jcfg)
    assert pm.model_flops(cfg, 8192) == jpm.model_flops(jcfg, 8192)
    if name in PINNED:
        assert (n, act) == PINNED[name]
    assert (act < n) == (cfg.moe is not None)


@pytest.mark.parametrize("name", NINE)
def test_counts_equal_the_reference(name):
    check_against_reference(name)


def test_shapes_are_meta_and_cached():
    cfg = get_arch("qwen1.5-0.5b").model
    shapes = pm.param_shapes(cfg)
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for t in tree_leaves(shapes))
    assert pm.param_shapes(cfg) is shapes
    assert pm.param_shapes(cfg, torch.float32) is not shapes
    # the ml round of chip_smoke: 6 · N · 8 × 4 × 256 tokens
    assert pm.model_flops(cfg, 8192) == 6.0 * 463_987_712 * 8192
