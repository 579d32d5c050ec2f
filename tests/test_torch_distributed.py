"""The port's mesh round assembly (``repro_torch.launch.distributed``)
against the reference's, round by round.

Two reference subprocesses, run at once, each with 4 fake CPU devices and a
(4, 1) ("data", "model") mesh with Auto axes (``jax.make_mesh``'s default
Explicit axes are what make ``tests/test_sharding.py`` and
``tests/test_pp.py`` fail under JAX 0.9, ROADMAP C), build the
configurations below on a reduced Qwen1.5-0.5B (2 layers, d_model 64, f32),
run ``sync_step`` from zeros, then ``compressed_step`` from their own sync
state, and write the states, the ledger and ``bundle.meta`` to an npz, once
per module. The port builds the same bundle on a CPU mesh without a
process group and is held to it from the reference's states:

* sync gradients within rtol 1e-5 / atol 1e-6 (autograd against XLA,
  ROADMAP C's first entry);
* compressed rounds leaf by leaf within 1e-4 of the leaf's largest
  magnitude (ROADMAP C's LM rule); on the QSGD wires a level may flip where
  the port's gradient moved a floor argument across an integer (at most
  0.1 % of a leaf's coordinates, each within one level of the leaf);
* the ledgers scope by scope, bit for bit, and ``meta`` equal.

The configurations: randk, permk, packed qsgd (s = 7), carry with a qsgd
downlink, PP flat with ``replicate_params`` (the cohort-compute path),
robust ``trimmed_mean`` with a ``nan`` client, and ``drop`` with carry;
``train_step``'s scope books sync and compressed together. Then 8 PP
``train_step`` rounds against the reference's 8 mesh rounds (the program of
``tests/test_pp.py``'s mesh test, in the same subprocess) and, as a second
witness, the port's core ``PPMarina`` on the same flat sampler and keys; the
refusals (robust × permk or shared mask, drop without carry: the
reference's errors), a model axis > 1 in one process (the rank holds the
whole model, with the sharded model's decisions), an fsdp arch in one
process (the bundle builds, its data axis inside the rank), and entry points
that raise without a card. The CLI twin ``python -m repro_torch.launch.train`` books the
reference CLI's ledger on a reduced model, and ``scripts/check_async_torch.py``
(the twin of ``scripts/check_async.py``) passes its two bitwise contracts.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_parity import close_except_flips, one_torch_thread  # noqa: F401
from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import BlockRandK, FaultSpec, PPMarina, ServerAggregator, make_engine
from repro_torch.core.marina import MarinaState
from repro_torch.core.tree_util import tree_flatten, tree_leaves, tree_map
from repro_torch.launch import topology as topo
from repro_torch.launch.distributed import build_train_steps, pp_cohort_schedule
from repro_torch.models import lm_loss, reduced

N, B, S = 4, 2, 32
SEL_BASE = 42
PP_BASE = 42

#: name → (build_train_steps dials, as python source for the reference)
CONFIGS = {
    "randk": "dict()",
    "permk": "dict(compression='permk')",
    "qsgd": "dict(compression='qsgd', qsgd_s=7, packed_payload=True)",
    "carry_downqsgd": "dict(grad_carry=True, downlink='qsgd', downlink_s=7)",
    "pp_flat": "dict(replicate_params=True, participation=(2, 'without'), p=0.3)",
    "robust": "dict(aggregator=ServerAggregator('trimmed_mean', f=1), "
              "faults=FaultSpec('nan', frac=0.25))",
    "drop": "dict(grad_carry=True, faults=FaultSpec('drop', frac=0.25))",
}
QUANTIZED = ("qsgd", "carry_downqsgd")

_REF_PROG = textwrap.dedent(
    """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_arch
    from repro.core import FaultSpec, ServerAggregator
    from repro.launch.distributed import build_train_steps, pp_cohort_schedule
    from repro.models import reduced, init_params

    CONFIGS = json.loads(sys.argv[2])
    mesh = jax.make_mesh((4, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    arch = get_arch("qwen1.5-0.5b")
    arch = dataclasses.replace(arch, model=reduced(arch.model, layers=2, d_model=64))
    cfg = arch.model
    params = init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    toks = jax.random.randint(jax.random.PRNGKey(1), (4, %(B)d, %(S)d), 0, cfg.vocab_size)
    batch = {"tokens": toks}
    out = {"tokens": np.asarray(toks)}
    leaves = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
    copy = lambda t: jax.tree.map(jnp.array, t)
    for name, src in CONFIGS.items():
        kw = eval(src)
        b = build_train_steps(arch, mesh, multi_pod=False, global_batch=4 * %(B)d,
                              seq_len=%(S)d, gamma=0.1, dtype=jnp.float32, **kw)
        carry = kw.get("grad_carry", False)
        g0 = jax.tree.map(jnp.zeros_like, params)
        h0 = (jax.tree.map(lambda t: jnp.zeros((4, *t.shape), t.dtype), params),) if carry else ()
        with b.mesh:
            s1 = b.fns["sync_step"][0](copy(params), g0, *h0, batch)
            s1 = jax.tree.map(np.asarray, s1)
            sel = ()
            if "participation" in kw:
                sel = (pp_cohort_schedule(jax.random.PRNGKey(%(SEL_BASE)d), 1, 4, 2)[0],)
            s2 = b.fns["compressed_step"][0](*copy(s1), batch, jax.random.PRNGKey(7), *sel)
            if name == "randk":
                b.fns["train_step"][0](*copy(s1), batch, jax.random.PRNGKey(3))
        for i, part in enumerate(s1):
            out.update({f"{name}/s1/{i}/{j}": a for j, a in enumerate(leaves(part))})
        for i, part in enumerate(s2):
            out.update({f"{name}/s2/{i}/{j}": a for j, a in enumerate(leaves(part))})
        led = b.transport.ledger
        out[f"{name}/ledger"] = np.array(json.dumps(
            [[list(k), v, led.counts[k]] for k, v in led.bits.items()]))
        out[f"{name}/meta"] = np.array(json.dumps(
            {k: (list(v) if isinstance(v, tuple) else v) for k, v in b.meta.items()}))
        if name == "pp_flat":
            pp = b
    # tests/test_pp.py's mesh program on these params and tokens: 8 PP
    # train_step rounds from zeros, the state after each
    if "pp_flat" in CONFIGS:
        base = jax.random.PRNGKey(%(PP_BASE)d)
        sched = pp_cohort_schedule(base, 8, 4, 2)
        pd, gd = copy(params), jax.tree.map(jnp.zeros_like, params)
        with pp.mesh:
            for k in range(8):
                pd, gd = pp.fns["train_step"][0](pd, gd, batch, jax.random.fold_in(base, k),
                                                  sched[k])
                out.update({f"pp8/{k}/0/{j}": a for j, a in enumerate(leaves(pd))})
                out.update({f"pp8/{k}/1/{j}": a for j, a in enumerate(leaves(gd))})
    out.update({f"params/{j}": a for j, a in enumerate(leaves(params))})
    np.savez(sys.argv[1], **out)
    print("REF_OK")
    """ % {"B": B, "S": S, "SEL_BASE": SEL_BASE, "PP_BASE": PP_BASE})


#: the configurations of each of the two reference processes, which run at
#: once (each spends its time compiling; the PP rounds go with ``pp_flat``)
REF_SPLIT = (("randk", "permk", "qsgd", "carry_downqsgd"), ("pp_flat", "robust", "drop"))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    assert sorted(sum(REF_SPLIT, ())) == sorted(CONFIGS)
    tmp = tmp_path_factory.mktemp("mesh_ref")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    runs = []
    for i, names in enumerate(REF_SPLIT):
        path = str(tmp / f"ref{i}.npz")
        cfgs = json.dumps({k: CONFIGS[k] for k in names})
        runs.append((path, subprocess.Popen([sys.executable, "-c", _REF_PROG, path, cfgs],
                                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True, env=env)))
    out = {}
    for path, proc in runs:
        stdout, stderr = proc.communicate(timeout=560)
        assert proc.returncode == 0 and "REF_OK" in stdout, stderr[-3000:]
        out.update(np.load(path))
    return out


@pytest.fixture(scope="module")
def arch():
    a = get_arch("qwen1.5-0.5b")
    return dataclasses.replace(a, model=reduced(a.model, layers=2, d_model=64))


@pytest.fixture(scope="module")
def mesh():
    return topo.make_test_mesh(N, 1, device="cpu")


def _bundle(arch, mesh, name):
    from repro_torch.core import FaultSpec, ServerAggregator  # noqa: F401 (eval)

    return build_train_steps(arch, mesh, False, global_batch=N * B, seq_len=S, gamma=0.1,
                             dtype=torch.float32, **eval(CONFIGS[name]))


def _params(ref, like):
    """The reference's params as the port's tree (leaves in flatten order)."""
    leaves = [torch.from_numpy(ref[f"params/{j}"].copy()) for j in range(len(tree_leaves(like)))]
    return tree_flatten(like)[1].unflatten(leaves)


def _state(ref, name, stage, like, carry):
    """The reference's state after ``stage`` as the port's (params, g[, h])."""
    treedef = tree_flatten(like)[1]
    nleaf = len(tree_leaves(like))
    parts = []
    for i in range(3 if carry else 2):
        parts.append(treedef.unflatten(
            [torch.from_numpy(ref[f"{name}/{stage}/{i}/{j}"].copy()) for j in range(nleaf)]))
    return tuple(parts)


def _ledger(ref, name):
    rows = json.loads(str(ref[f"{name}/ledger"]))
    return ({tuple(k): v for k, v, _c in rows}, {tuple(k): c for k, _v, c in rows})


@pytest.fixture(scope="module")
def shapes(arch):
    from repro_torch.models import init_params

    return init_params(0, arch.model, torch.float32, device="meta")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mesh_rounds_hold_to_the_reference(ref, arch, mesh, shapes, name):
    b = _bundle(arch, mesh, name)
    carry = "grad_carry" in CONFIGS[name]
    params = _params(ref, shapes)
    batch = {"tokens": torch.from_numpy(ref["tokens"].copy())}
    g0 = tree_map(torch.zeros_like, params)
    h0 = (tree_map(lambda t: torch.zeros((N, *t.shape)), params),) if carry else ()
    s1 = b.fns["sync_step"](params, g0, *h0, batch)
    want1 = _state(ref, name, "s1", shapes, carry)
    for got, want in zip(tree_leaves(s1[1]), tree_leaves(want1[1])):  # the sync grads
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    sel = ()
    if "participation" in CONFIGS[name]:
        sel = (pp_cohort_schedule(prng.PRNGKey(SEL_BASE), 1, N, 2)[0],)
    s2 = b.fns["compressed_step"](*want1, batch, prng.PRNGKey(7), *sel)
    if name == "randk":
        b.fns["train_step"](*want1, batch, prng.PRNGKey(3))
    want2 = _state(ref, name, "s2", shapes, carry)
    for part, (got_t, want_t) in enumerate(zip(s2, want2)):
        for got, want in zip(tree_leaves(got_t), tree_leaves(want_t)):
            got, want = got.numpy(), want.numpy()
            assert np.all(np.isfinite(got)), (name, part)
            if part == 1 and name in QUANTIZED:
                flips = close_except_flips(got, want, np.abs(want).max(), 1e-4,
                                           atol_scale=True)
                assert flips <= 1e-3 * want.size, (name, flips)
            else:
                scale = max(float(np.abs(want).max()), 1e-30)
                assert np.abs(got - want).max() <= 1e-4 * scale, (name, part)
    bits, counts = _ledger(ref, name)
    assert b.transport.ledger.bits == bits
    assert b.transport.ledger.counts == counts
    meta = {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in json.loads(str(ref[f"{name}/meta"])).items()}
    assert b.meta == meta


def test_pp_train_rounds_equal_the_core(ref, arch, mesh, shapes):
    """8 PP ``train_step`` rounds (flat PP, cohort compute, r = 2 of 4) from
    the reference's params and tokens: each round's params and g within
    1e-4 of the reference's mesh program (``tests/test_pp.py``'s, on an
    Auto mesh) and, as a second witness, of the port's core ``PPMarina`` on
    the same flat sampler and keys; some rounds compressed."""
    b = _bundle(arch, mesh, "pp_flat")
    assert b.meta["cohort_compute"] and b.meta["flat_pp"]
    cfg = arch.model
    params = _params(ref, shapes)
    toks = torch.from_numpy(ref["tokens"].copy())

    def grad_fn(p_, t):
        leaves, treedef = tree_flatten(p_)
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        loss = lm_loss(treedef.unflatten(leaves), cfg, t)
        return treedef.unflatten(torch.autograd.grad(loss, leaves))

    eng = make_engine(params, kb=8, block=1024, backend="ref", device="cpu")
    core = PPMarina(grad_fn, BlockRandK(kb=8), 0.1, 0.3, r=2, engine=eng, replace=False)
    g0 = tree_map(torch.zeros_like, params)
    st = MarinaState(params=params, g=g0, step=0)
    base = prng.PRNGKey(PP_BASE)
    sched = pp_cohort_schedule(base, 8, N, 2)
    pd, gd = params, g0
    comp = 0

    def err(a, c):
        return max(float((x - y).abs().max()) for x, y in zip(tree_leaves(a), tree_leaves(c)))

    for k in range(8):
        key = prng.fold_in(base, k)
        pd, gd = b.fns["train_step"](pd, gd, {"tokens": toks}, key, sched[k])
        st, met = core.step(st, key, toks)
        comp += 1 - int(met.sync_round)
        want_p, want_g = _state(ref, "pp8", k, shapes, False)
        for got, want, who in ((pd, want_p, "ref params"), (gd, want_g, "ref g"),
                               (pd, st.params, "core params"), (gd, st.g, "core g")):
            assert err(got, want) < 1e-4, (k, who, err(got, want))
    assert comp > 0


def test_refusals_match_the_reference(arch, mesh):
    """Robust × permk, robust × shared mask and drop without carry raise the
    reference's errors."""
    from repro.configs import get_arch as j_get_arch
    from repro.core import FaultSpec as JFaultSpec
    from repro.core import ServerAggregator as JAggregator
    from repro.launch.distributed import build_train_steps as j_build

    class FakeMesh:
        shape = {"data": N, "model": 1}

    jarch = j_get_arch("qwen1.5-0.5b")
    cases = [
        (dict(compression="permk"), "trimmed_mean", None),
        (dict(shared_mask=True), "krum", None),
        (dict(), None, "drop"),
    ]
    for kw, rule, attack in cases:
        jkw = dict(kw, aggregator=JAggregator(rule, f=1) if rule else None,
                   faults=JFaultSpec(attack) if attack else None)
        tkw = dict(kw, aggregator=ServerAggregator(rule, f=1) if rule else None,
                   faults=FaultSpec(attack) if attack else None)
        with pytest.raises(ValueError) as jerr:
            j_build(jarch, FakeMesh(), False, global_batch=8, seq_len=S, **jkw)
        with pytest.raises(ValueError) as terr:
            build_train_steps(arch, mesh, False, global_batch=8, seq_len=S, **tkw)
        assert str(terr.value) == str(jerr.value)


def test_model_axis_needs_replicate_params_and_the_card(arch):
    """A model axis > 1 shards the parameters across its ranks; in one
    process the rank holds every slice, with the reference's decisions for a
    sharded model axis (no flat sync, no flat PP). ``replicate_params`` runs
    the model axis as within-worker data parallelism (flat sync, flat PP);
    an fsdp arch whose workers are pods builds in one process, the data
    axis inside the rank (no flat sync, no flat PP: "data" is an inner
    axis). Without a card, every entry point given no device raises."""
    m = topo.make_test_mesh(N, 2, device="cpu")
    assert m.model == 1
    b = build_train_steps(arch, m, False, global_batch=8, seq_len=S,
                          participation=(2, "without"))
    assert not b.transport.flat_sync and not b.meta["flat_pp"]
    b = build_train_steps(arch, m, False, global_batch=8, seq_len=S, replicate_params=True,
                          participation=(2, "without"))
    assert b.transport.flat_sync and b.meta["flat_pp"]
    pods = topo.make_federated_mesh(N, 1, device="cpu")
    pods = dataclasses.replace(pods, axis_names=("pod", "data", "model"), sizes=(2, 2, 1))
    fs = dataclasses.replace(arch, fsdp=True, worker_axes="pod")
    b = build_train_steps(fs, pods, True, global_batch=8, seq_len=S,
                          participation=(1, "without"))
    assert b.n_workers == 2 and pods.fsdp == 1 and "fsdp" not in b.meta
    assert not b.transport.flat_sync and not b.meta["flat_pp"]
    assert b.local_shapes is b.param_shapes
    if not torch.cuda.is_available():
        for fn in (lambda: topo.make_test_mesh(N, 1), lambda: topo.init_from_env(),
                   lambda: topo.make_federated_mesh(N), lambda: params_from_jax({})):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()


def test_train_cli_and_async_gate_run_on_the_cpu(capsys):
    """The CLI twin trains the reduced model and books 32·d on the first
    (sync) round's ledger as the reference's CLI does; the async gate's two
    contracts hold bit for bit; both raise without a device and a card."""
    import importlib.util

    from repro_torch.launch import train as cli

    hist = cli.main(["--arch", "qwen1.5-0.5b", "--steps", "2", "--method", "marina",
                     "--compressor", "randk", "--reduced", "--device", "cpu"])
    assert len(hist.loss) == 3 and all(np.isfinite(hist.loss))
    assert hist.bits_cum[0] == 0.0 and hist.bits_cum[-1] > 0
    path = os.path.join(os.path.dirname(__file__), "..", "scripts", "check_async_torch.py")
    spec = importlib.util.spec_from_file_location("check_async_torch", path)
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    assert gate.main(["--device", "cpu"]) == 0
    assert "async gate passed" in capsys.readouterr().out
    if not torch.cuda.is_available():
        for fn in (lambda: cli.main(["--arch", "qwen1.5-0.5b", "--reduced"]),
                   lambda: gate.main([])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()
