"""The attention and MoE families of the port against ``repro.models``, on
the CPU: the seven configs whose mixers are attention (global,
sliding-window or MLA), each reduced (``reduced(…, layers, d_model=64)``,
attention chunks of 16 so that the banded and the global scans cross chunk
boundaries), with the reference's parameters carried across by
``convert.params_from_jax``. deepseek-v3 runs at 4 layers, so that its MoE
segment (after the 3 dense layers) and an MoE MTP head are built; gemma3
runs at 2 layers (two sliding-window layers) and at 6 (five local, then a
global one).

* ``forward`` logits, ``lm_loss`` (MoE aux losses and the MTP term
  included) and every leaf's gradient agree to rtol 1e-5 / atol 1e-6
  (ROADMAP C's first entry: torch and XLA sum matmuls in other orders);
  the vision and audio configs take a prefix of frontend embeddings.
* ``prefill`` then ``decode_step``, prompts longer than the reduced window
  (16) so that each ring wraps: the prefill caches (ring, latent and full)
  within 1e-5, and every step's logits within the serving tests'
  ``LOGIT_TOL`` = 1e-4, the port's cache its own, fed the reference's
  greedy tokens, which are also the port's.

The serving engine and the MARINA rounds on these configs are in
``tests/test_torch_families_paths.py``.
* The port's own ``init_params`` (meta device) has the reference's leaf
  paths, shapes and dtypes, reduced and at full width (the families
  phase's Llama-4-Scout and DeepSeek-V3 cuts).
* ``get_arch`` builds the reference's config for every ported id; the two
  recurrent ids raise ``NotImplementedError`` naming the next slice.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, port_cfg  # noqa: F401
from repro.configs import PUBLIC_TO_MODULE as J_ARCHS
from repro.configs import get_arch as j_get_arch
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import lm_loss as j_lm_loss
from repro.models import prefill as j_prefill
from repro.models import reduced as j_reduced
from repro_torch import configs
from repro_torch.convert import params_from_jax
from repro_torch.core.tree_util import tree_flatten, tree_unflatten
from repro_torch.models import decode_step, forward, lm_loss, prefill

LOGIT_TOL = 1e-4
#: case → (architecture, layers of the reduced config)
CASES = {
    "gemma3-27b": ("gemma3-27b", 2),
    "gemma3-27b-6l": ("gemma3-27b", 6),
    "qwen3-32b": ("qwen3-32b", 2),
    "deepseek-coder-33b": ("deepseek-coder-33b", 2),
    "llama4-scout-17b-a16e": ("llama4-scout-17b-a16e", 2),
    "deepseek-v3-671b": ("deepseek-v3-671b", 4),
    "internvl2-1b": ("internvl2-1b", 2),
    "musicgen-medium": ("musicgen-medium", 2),
}
PREFIX = 3
_MODELS: dict = {}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_port(tree):
    return params_from_jax(_np_tree(tree), device="cpu")


def _model(case):
    """(arch, reference config, port config, reference params, port params),
    built once per case."""
    if case not in _MODELS:
        name, layers = CASES[case]
        arch = j_get_arch(name)
        jcfg = dataclasses.replace(j_reduced(arch.model, layers=layers, d_model=64),
                                   attn_chunk=16)
        jp = j_init_params(jax.random.PRNGKey(0), jcfg)
        _MODELS[case] = (arch, jcfg, port_cfg(jcfg), jp, _to_port(jp))
    return _MODELS[case]


def _inputs(arch, cfg, seed, S, B=2):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    prefix = None
    if arch.prefix_len:
        prefix = (rng.standard_normal((B, PREFIX, cfg.d_model)) * 0.02).astype(np.float32)
    return toks, prefix


def _opt(a, conv):
    return None if a is None else conv(a)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_reduced_configs_build_every_block_type():
    kinds = {case: {(l.mixer, l.ff) for s in _model(case)[2].segments for l in s.period}
             for case in CASES}
    assert kinds["gemma3-27b"] == {("attn_local", "mlp")}
    assert kinds["gemma3-27b-6l"] == {("attn_local", "mlp"), ("attn", "mlp")}
    assert kinds["llama4-scout-17b-a16e"] == {("attn", "moe")}
    assert kinds["deepseek-v3-671b"] == {("mla", "mlp"), ("mla", "moe")}
    cfg = _model("deepseek-v3-671b")[2]
    assert cfg.mtp_depth == 1 and cfg.moe.router_score == "sigmoid"
    assert _model("musicgen-medium")[2].pos_emb == "sinusoidal"


def _cut(name, repeats):
    """A full-width config cut to the given repeats of its segments, the MTP
    head off: chip_smoke.py's families phase."""
    cfg = j_get_arch(name).model
    segs = tuple(dataclasses.replace(seg, repeat=r) for seg, r in zip(cfg.segments, repeats))
    return dataclasses.replace(cfg, segments=segs, mtp_depth=0)


@pytest.mark.parametrize("case", sorted(CASES) + ["llama4-full-4l", "deepseek-v3-full-2l"])
def test_init_params_tree_matches_reference(case):
    """The port's own init (on the meta device) has the reference's leaves,
    paths, shapes and dtypes, so a flat layout of either package places
    every leaf at the same offset: the reduced configs, and at full width
    the two MoE legs of chip_smoke.py's families phase."""
    from repro.checkpoint import store as jstore
    from repro_torch.checkpoint import store
    from repro_torch.core.tree_util import tree_flatten_with_path
    from repro_torch.models import init_params

    if case in CASES:
        jcfg, tcfg = _model(case)[1:3]
    else:
        name, reps = (("llama4-scout-17b-a16e", (4,)) if case.startswith("llama4")
                      else ("deepseek-v3-671b", (1, 1)))
        jcfg = _cut(name, reps)
        tcfg = port_cfg(jcfg)
    want = jax.eval_shape(lambda k: j_init_params(k, jcfg), jax.random.PRNGKey(0))
    jflat = jax.tree_util.tree_flatten_with_path(want)[0]
    tflat = tree_flatten_with_path(init_params(0, tcfg, device="meta"))[0]
    assert [jstore._path_str(p) for p, _ in jflat] == [store._path_str(p) for p, _ in tflat]
    for (_, a), (_, b) in zip(jflat, tflat):
        assert tuple(b.shape) == a.shape and str(b.dtype).split(".")[1] == str(a.dtype)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_loss_and_grads_match_reference(case):
    arch, jcfg, tcfg, jp, tp = _model(case)
    toks, prefix = _inputs(arch, jcfg, 0, 40)
    jpre, tpre = _opt(prefix, jnp.asarray), _opt(prefix, torch.from_numpy)
    jlogits, jaux, _, _ = j_forward(jp, jcfg, jnp.asarray(toks), jpre)
    jl, jg = jax.jit(jax.value_and_grad(j_lm_loss), static_argnums=1)(
        jp, jcfg, jnp.asarray(toks), jpre)
    leaves, treedef = tree_flatten(tp)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    params = tree_unflatten(treedef, leaves)
    with torch.no_grad():
        tlogits, taux, _, _ = forward(params, tcfg, torch.from_numpy(toks), tpre)
    # logits sum d_model products of O(1) terms: held at rtol 1e-5 with an
    # atol of 1e-5 of their largest magnitude (ROADMAP C)
    _close_to_leaf_scale(tlogits, jlogits, 1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5, atol=1e-7)
    if jcfg.moe is not None:
        assert float(taux) > 0
    tl = lm_loss(params, tcfg, torch.from_numpy(toks), tpre)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    tg = torch.autograd.grad(tl, leaves)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for a, b in zip(tg, jleaves):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_decode_streams_match_reference(case):
    """A 20-token prompt (after the prefix, where the config has one) and 6
    greedy steps; the port's ring / latent / full cache is its own from the
    prefill on."""
    arch, jcfg, tcfg, jp, tp = _model(case)
    S, G = 20, 6
    toks, prefix = _inputs(arch, jcfg, 1, S)
    off = 0 if prefix is None else PREFIX
    max_len = off + S + G
    jlast, jcache = j_prefill(jp, jcfg, jnp.asarray(toks), _opt(prefix, jnp.asarray),
                              max_len=max_len)
    with torch.inference_mode():
        tlast, tcache = prefill(tp, tcfg, torch.from_numpy(toks),
                                _opt(prefix, torch.from_numpy), max_len=max_len)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=LOGIT_TOL, rtol=0)
    for a, b in zip(jax.tree.leaves(jcache), _leaves(tcache)):
        assert a.shape == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=1e-5)
    tok = jnp.argmax(jlast, -1).astype(jnp.int32)
    assert np.array_equal(torch.argmax(tlast, -1).numpy(), np.asarray(tok))
    for i in range(G):
        pos = off + S + i
        jl, jcache = j_decode_step(jp, jcfg, jcache, tok, pos)
        with torch.inference_mode():
            tl, tcache = decode_step(tp, tcfg, tcache, torch.from_numpy(np.asarray(tok)),
                                     pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"{case} pos {pos}")
        tok = jnp.argmax(jl, -1).astype(jnp.int32)
        assert np.array_equal(torch.argmax(tl, -1).numpy(), np.asarray(tok))


def _close_to_leaf_scale(a, b, rtol):
    b = np.asarray(b)
    scale = float(np.max(np.abs(b))) if b.size else 0.0
    np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("name", sorted(J_ARCHS))
def test_get_arch_builds_every_ported_config(name):
    jarch = j_get_arch(name)
    if name in ("recurrentgemma-2b", "xlstm-350m"):
        with pytest.raises(NotImplementedError, match="next slice.*A4c"):
            configs.get_arch(name)
        return
    arch = configs.get_arch(name)
    assert dataclasses.asdict(arch.model) == dataclasses.asdict(jarch.model)
    assert (arch.worker_axes, arch.fsdp, arch.prefix_len, arch.runs_long_context) == (
        jarch.worker_axes, jarch.fsdp, jarch.prefix_len, jarch.runs_long_context)
    assert name in configs.PUBLIC_TO_MODULE
