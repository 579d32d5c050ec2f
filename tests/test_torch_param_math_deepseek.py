"""``launch/param_math.py`` on deepseek-v3-671b against the reference (its
own file: the reference's ``jax.eval_shape`` of the 671 B tree takes ~50 s,
and the test runner spreads files over its workers)."""

from _torch_parity import one_torch_thread  # noqa: F401
from test_torch_param_math import check_against_reference


def test_deepseek_v3_counts_equal_the_reference():
    check_against_reference("deepseek-v3-671b")
