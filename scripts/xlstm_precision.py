#!/usr/bin/env python3
"""How far float32 xLSTM results sit from float64, in the port and in the
reference, on the CPU: the measurements behind ROADMAP C's xLSTM entry.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/xlstm_precision.py

First the single mLSTM and sLSTM layers of ``tests/test_torch_ssm.py``;
then the reduced xlstm-350m of ``tests/test_torch_ssm_paths.py`` (8 layers,
d_model 64) with the reference's parameters carried across: the forward
logits at S = 40 and 512, and the ``lm_loss`` gradient at S = 40, of each
package in float32 against the port in float64 (its recurrences keep
float64 for float64 parameters), as fractions of the largest magnitude;
then, at 24 layers and d_model 128 and 256, prefill (252 tokens) + 4
decode steps against the teacher-forced forward, in float32 for both
packages and in float64 for the port, as fractions of each row's largest
logit (``chip_smoke.py``'s teacher-forced check).
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from _torch_parity import port_cfg  # noqa: E402
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.models import decode_step as j_decode_step  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import lm_loss as j_lm_loss  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models import reduced as j_reduced  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.tree_util import tree_flatten, tree_map, tree_unflatten  # noqa: E402
from repro_torch.models import decode_step, forward, lm_loss, prefill  # noqa: E402


def model(layers: int, d_model: int):
    jcfg = j_reduced(j_get_arch("xlstm-350m").model, layers=layers, d_model=d_model)
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, port_cfg(jcfg), jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                                     device="cpu")


def frac(a, b, scale) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)))
                 / scale)


def logits_and_grads(jcfg, tcfg, jp, tp, S: int, B: int):
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jl = np.asarray(jax.jit(lambda p, t: j_forward(p, jcfg, t)[0])(jp, jnp.asarray(toks)))
    with torch.inference_mode():
        tl = forward(tp, tcfg, torch.from_numpy(toks))[0].numpy()
        t64 = forward(tree_map(lambda t: t.double(), tp), tcfg,
                      torch.from_numpy(toks))[0].numpy()
    scale = np.abs(t64).max()
    print(f"S = {S}: logits from float64, port {frac(tl, t64, scale):.2e}, reference "
          f"{frac(jl, t64, scale):.2e}; port against reference {frac(tl, jl, scale):.2e}")
    if S > 256:
        return
    jg = jax.jit(jax.grad(j_lm_loss), static_argnums=1)(jp, jcfg, jnp.asarray(toks))

    def grads(dtype):
        leaves, treedef = tree_flatten(tp)
        leaves = [t.to(dtype).detach().requires_grad_(True) for t in leaves]
        loss = lm_loss(tree_unflatten(treedef, leaves), tcfg, torch.from_numpy(toks))
        return [g.numpy() for g in torch.autograd.grad(loss, leaves)]

    worst = [0.0, 0.0]
    for a, b, c in zip(grads(torch.float32), jax.tree.leaves(jg), grads(torch.float64)):
        scale = np.abs(c).max()
        worst = [max(worst[0], frac(a, c, scale)), max(worst[1], frac(b, c, scale))]
    print(f"S = {S}: gradients from float64, largest over leaves as a fraction of the "
          f"leaf's scale: port {worst[0]:.2e}, reference {worst[1]:.2e}")


def teacher_forced(layers: int, d_model: int, P: int = 252, n: int = 4):
    jcfg, tcfg, jp, tp = model(layers, d_model)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (1, P + n)).astype(np.int32)

    def port(params):
        with torch.inference_mode():
            full = forward(params, tcfg, torch.from_numpy(toks))[0][0, P:].double().numpy()
            _, cache = prefill(params, tcfg, torch.from_numpy(toks[:, :P]), max_len=P + n)
            dec = []
            for i in range(n):
                lg, cache = decode_step(params, tcfg, cache, torch.from_numpy(toks[:, P + i]),
                                        P + i)
                dec.append(lg[0].double().numpy())
        return full, np.stack(dec)

    f32, d32 = port(tp)
    f64, d64 = port(tree_map(lambda t: t.double(), tp))
    jf = np.asarray(jax.jit(lambda p, t: j_forward(p, jcfg, t)[0])(
        jp, jnp.asarray(toks)))[0, P:]
    _, jc = jax.jit(lambda p, t: j_prefill(p, jcfg, t, max_len=P + n))(
        jp, jnp.asarray(toks[:, :P]))
    step = jax.jit(lambda p, c, t, pos: j_decode_step(p, jcfg, c, t, pos))
    jd = []
    for i in range(n):
        lg, jc = step(jp, jc, jnp.asarray(toks[:, P + i]), P + i)
        jd.append(np.asarray(lg[0]))
    rows = np.abs(f64).max(axis=-1, keepdims=True)

    def rel(a, b):
        return float(np.max(np.abs(np.asarray(a, np.float64) - b) / rows))

    print(f"{layers} layers, d_model {d_model}: decode against the teacher-forced forward, "
          f"port {rel(d32, f32):.2e}, reference {rel(np.stack(jd), jf):.2e}, port in "
          f"float64 {rel(d64, f64):.2e}")


def mixers():
    """``tests/test_torch_ssm.py``'s mLSTM and sLSTM training cases: the
    output and the gradients of its random projection, each package's
    float32 against the port's float64, as fractions of the largest
    magnitude."""
    import test_torch_ssm as cases

    for case, (mixer, S, scale) in sorted(cases.TRAIN_CASES.items()):
        if mixer == "rglru":
            continue
        jcfg, tcfg, jp, tp = cases._weights(mixer, seed=1, gate_scale=scale)
        rng = np.random.default_rng(2)
        B = 1 if S > 256 else 2
        x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
        proj = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
        jy = cases.J_TRAIN[mixer](jp, jcfg, jnp.asarray(x))
        jg = jax.jit(jax.grad(lambda p, xx: jnp.sum(cases.J_TRAIN[mixer](p, jcfg, xx) * proj),
                              argnums=(0, 1)))(jp, jnp.asarray(x))

        def run(dtype):
            leaves, treedef = tree_flatten(tp)
            leaves = [t.to(dtype).detach().requires_grad_(True) for t in leaves]
            xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
            y = cases.T_TRAIN[mixer](tree_unflatten(treedef, leaves), tcfg, xt)
            g = torch.autograd.grad((y * torch.from_numpy(proj).to(dtype)).sum(), leaves + [xt])
            return y.detach().numpy(), [t.numpy() for t in g]

        y32, g32 = run(torch.float32)
        y64, g64 = run(torch.float64)
        worst = [frac(y32, y64, np.abs(y64).max()), frac(jy, y64, np.abs(y64).max())]
        for a, b, c in zip(g32, jax.tree.leaves(jg), g64):
            scale = np.abs(c).max()
            worst = [max(worst[0], frac(a, c, scale)), max(worst[1], frac(b, c, scale))]
        print(f"mixer case {case}: output and gradients from float64, port {worst[0]:.2e}, "
              f"reference {worst[1]:.2e}")


def main() -> int:
    torch.set_num_threads(2)
    mixers()
    jcfg, tcfg, jp, tp = model(8, 64)
    logits_and_grads(jcfg, tcfg, jp, tp, 40, 2)
    logits_and_grads(jcfg, tcfg, jp, tp, 512, 1)
    for d_model in (128, 256):
        teacher_forced(24, d_model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
