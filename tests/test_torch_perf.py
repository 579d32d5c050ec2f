"""``launch/perf.py``'s wire ledgers against the reference's: Qwen1.5-0.5B
× train_4k at full width on both production meshes, for the variants
``baseline``, ``grad_carry``, ``permk_payload`` and ``qsgd4_packed``.

The port's ledger is its bundle's on the dry run's meta stand-in, booked by
each step without running it (``perf.variant_ledger``), as the reference's
``.lower()`` books without executing. The reference's is its bundle's after
tracing each step (``jit(...).trace``: the booking happens while the step
is traced, before any lowering) on 512 fake host devices with Auto axes
(ROADMAP C), in a subprocess (``repro.launch.perf`` sets ``XLA_FLAGS`` at
import). The two are bit-equal, key for key; the committed
``experiments/perf/*grad_carry.json`` records are a cross-check.
"""

import json
import os
import subprocess
import sys

import pytest

from _torch_parity import one_torch_thread  # noqa: F401
from repro_torch.launch import perf

ROOT = os.path.join(os.path.dirname(__file__), "..")
VARIANTS = ("baseline", "grad_carry", "permk_payload", "qsgd4_packed")

_REF_PROG = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json
import jax
from repro.configs import get_arch
from repro.launch.distributed import build_train_steps
from repro.launch.perf import VARIANTS
from repro.launch.dryrun import SHAPES
from repro.launch.topology import production_topology
out = {}
spec = SHAPES["train_4k"]
for mesh_name in ("single", "multi"):
    multi = mesh_name == "multi"
    shape, axes = (((2, 16, 16), ("pod", "data", "model")) if multi
                   else ((16, 16), ("data", "model")))
    mesh = jax.make_mesh(shape, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
    for v in sys.argv[1].split(","):
        b = build_train_steps(get_arch("qwen1.5-0.5b"), mesh, multi,
                              global_batch=spec["global_batch"], seq_len=spec["seq_len"],
                              topology=production_topology(multi_pod=multi), **VARIANTS[v][0])
        with b.mesh:
            for name, (fn, args) in b.fns.items():
                fn.trace(*args)
        out[f"{mesh_name}/{v}"] = b.transport.ledger.to_dict()
print("LEDGERS " + json.dumps(out), flush=True)
"""


@pytest.fixture(scope="module")
def ref_ledgers():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run([sys.executable, "-c", _REF_PROG, ",".join(VARIANTS)],
                          capture_output=True, text=True, env=env, timeout=400)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(x for x in proc.stdout.splitlines() if x.startswith("LEDGERS "))
    return json.loads(line[len("LEDGERS "):])


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_wire_ledger_is_the_references(ref_ledgers, mesh_name, variant):
    got = perf.variant_ledger("qwen1.5-0.5b", "train_4k", mesh_name, variant)
    assert got == ref_ledgers[f"{mesh_name}/{variant}"]
    committed = os.path.join(ROOT, "experiments", "perf",
                             f"qwen1.5-0.5b__train_4k__{mesh_name}__{variant}.json")
    if os.path.exists(committed):
        with open(committed) as f:
            rec = json.load(f)
        if "wire_by_tier" in rec:     # the records written since the ledger was kept
            assert got == rec["wire_by_tier"]
