"""The port's sharding rule table against the reference's.

For all ten configs at full width and depth, every parameter leaf (paths
and shapes from the port's ``init_params`` on the meta device; for
Qwen1.5-0.5B they equal the reference's ``jax.eval_shape``), and every
decode-cache leaf at batch 16: ``param_spec`` (with the arch's fsdp flag
and with fsdp forced on), ``cache_leaf_spec`` and ``param_sharding_tree``
give the reference's ``PartitionSpec``s as plain tuples, on the
production 16 × 16 mesh and on a (4, 2) mesh; ``_fit``, ``batch_spec``
and ``serve_batch_axes`` likewise on their own inputs.
"""

import jax
import pytest

from _torch_parity import one_torch_thread  # noqa: F401
from repro.configs import get_arch as j_get_arch
from repro.launch import sharding as jshd
from repro.models import init_params as j_init_params
from repro_torch.configs import PUBLIC_TO_MODULE, get_arch
from repro_torch.core.tree_util import tree_flatten_with_path
from repro_torch.launch import sharding as shd
from repro_torch.models import init_cache, init_params


class FakeMesh:
    def __init__(self, **axes):
        self.shape = axes


MESHES = {"16x16": FakeMesh(data=16, model=16), "4x2": FakeMesh(data=4, model=2),
          "pod": FakeMesh(pod=2, data=16, model=16)}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", sorted(PUBLIC_TO_MODULE))
def test_param_and_cache_specs_match_the_reference(name, mesh):
    m = MESHES[mesh]
    arch = get_arch(name)
    flat, _ = tree_flatten_with_path(init_params(0, arch.model, device="meta"))
    for path, leaf in flat:
        for fsdp in {arch.fsdp, True}:
            assert shd.param_spec(path, leaf, m, fsdp) == tuple(
                jshd.param_spec(path, leaf, m, fsdp)), (path, leaf.shape)
    baxes = shd.serve_batch_axes(m, 16)
    assert baxes == jshd.serve_batch_axes(m, 16)
    cflat, _ = tree_flatten_with_path(init_cache(arch.model, 16, 128, device="meta"))
    for path, leaf in cflat:
        assert shd.cache_leaf_spec(path, leaf, m, baxes) == tuple(
            jshd.cache_leaf_spec(path, leaf, m, baxes)), (path, leaf.shape)


def test_param_shapes_and_tree_match_the_reference():
    """Qwen1.5-0.5B: the port's meta paths and shapes are the reference's,
    and ``param_sharding_tree`` gives its specs leaf for leaf."""
    arch = get_arch("qwen1.5-0.5b")
    shapes = init_params(0, arch.model, device="meta")
    jshapes = jax.eval_shape(lambda k: j_init_params(k, j_get_arch("qwen1.5-0.5b").model),
                             jax.random.PRNGKey(0))
    jflat = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    flat, treedef = tree_flatten_with_path(shapes)
    assert [(jax.tree_util.keystr(p), tuple(leaf.shape)) for p, leaf in jflat] == [
        ("".join(f"[{k.key!r}]" if hasattr(k, "key") else f"[{k.idx}]" for k in p),
         tuple(leaf.shape)) for p, leaf in flat]
    big = FakeMesh(data=16, model=16)
    got = shd.param_sharding_tree(shapes, big, False)
    # the specs are tuples: flatten the tree only down to the parameter leaves
    for (path, leaf), spec in zip(flat, treedef.flatten_up_to(got)):
        assert spec == tuple(jshd.param_spec(path, leaf, big, False))


def test_fit_batch_and_serve_axes_match_the_reference():
    M, F = shd.M, shd.F
    assert (M, F) == (jshd.M, jshd.F) and shd._RULES == jshd._RULES
    m = FakeMesh(data=16, model=16)
    for roles, shape, fsdp in (((F, M), (1024, 4096), True), ((F, M), (1024, 4096), False),
                               ((F, M), (1024, 10), True), ((M, F, None), (58, 256, 7168, 2048), True),
                               ((M,), (0,), True), ((), (3, 4), True)):
        assert shd._fit(roles, shape, m, fsdp) == tuple(jshd._fit(roles, shape, m, fsdp))
    for waxes, inner, ndim in ((("data",), None, 3), (("pod", "data"), "model", 4),
                               (("pod",), "data", 3)):
        assert shd.batch_spec(waxes, inner, ndim) == tuple(jshd.batch_spec(waxes, inner, ndim))
    for mesh in MESHES.values():
        for B in range(1, 70):
            assert shd.serve_batch_axes(mesh, B) == jshd.serve_batch_axes(mesh, B)
    assert shd.replicated() == tuple(jax.sharding.PartitionSpec())
