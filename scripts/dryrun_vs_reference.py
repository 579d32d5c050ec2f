"""The port's dry-run records beside the reference's, collective by
collective.

For one (arch, shape, mesh) combination it reads the port's record
(``experiments/dryrun_torch/<combo>.json``, or ``card/`` with ``--card``)
and the reference's (``experiments/dryrun/<combo>.json``) and prints, for
every step both have:

* the collective term of the roofline (``collective_s``) and the priced
  bytes a device of each;
* each collective op with its count and priced GB;
* the port's model-axis sums: at m > 2 each is one ``model/all-to-all``
  (the reduce-scatter half) and one ``model/all-gather``, and nothing else
  on that axis is an all-to-all, so the all-to-alls count the sums; their
  mean priced GB a sum; beside them the reference's all-reduces, their
  count and mean priced GB;
* each side's ``memory_analysis`` (argument, output, temp, alias) and the
  peak they give (temp + argument + output − alias), the port's with the
  operator at its peak and, in a card record, the allocator's peak beside
  it. The port counts its eager program's live bytes; the reference's are
  XLA's buffer assignment.

With ``--sums`` it first runs the combination's steps on meta
(``repro_torch.launch.dryrun.run_one``; minutes) and prints the inner
groups' sums they issue (``Mesh._group_sum``), by axis and kind: their
count, total and largest bytes of the summed tensor. With ``--peak`` it
runs them on meta and prints, for each step, what is live at the counted
peak by the operator that allocated it (the step's ``peak_memory_by_op``).
Neither writes a record.

The two counts do not count the same thing: the reference's record prices
each collective line of its compiled HLO once
(``repro.roofline.analysis.collective_bytes_from_hlo``), and a segment of
layers runs as one ``lax.scan`` whose body is one layer's; the port's mesh
counts each collective it issues, every layer's. The script prints the
counts; it reads JSON only.

Usage: python scripts/dryrun_vs_reference.py --arch qwen1.5-0.5b
           --shape train_4k --mesh single [--card]
       PYTHONPATH=src python scripts/dryrun_vs_reference.py ... --sums [--steps sync_step]
       PYTHONPATH=src python scripts/dryrun_vs_reference.py ... --peak [--steps sync_step]
"""

from __future__ import annotations

import argparse
import json
import os

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def compare(port: dict, ref: dict) -> list:
    """Lines of the comparison (module doc), step by step."""
    lines = []
    for name in port["steps"]:
        p, r = port["steps"][name], ref["steps"].get(name)
        if r is None or not p.get("ok") or not r.get("ok"):
            continue
        lines.append(f"{name}: collective_s port {p['collective_s']:.4f} s, reference "
                     f"{r['collective_s']:.4f} s ({p['collective_s'] / r['collective_s']:.2f}×); "
                     f"priced GB a device port {p['collective_bytes_per_device'] / 1e9:.4f}, "
                     f"reference {r['collective_bytes_per_device'] / 1e9:.4f}")
        for who, s in (("port", p), ("reference", r)):
            ops = ", ".join(f"{op} {s['collective_counts'][op]} × "
                            f"{s['collective_by_kind_bytes'][op] / 1e9:.4f} GB"
                            for op in sorted(s["collective_counts"]))
            lines.append(f"  {who}: {ops}")
        n = p["collective_counts"].get("model/all-to-all", 0)
        if n:
            # the all-gather half prices as the all-to-all half, up to the padding
            gb = 2 * p["collective_by_kind_bytes"]["model/all-to-all"] / 1e9
            lines.append(f"  port model-axis sums {n}: about {gb:.4f} GB priced, "
                         f"{gb / n:.4f} GB a sum")
        n = r["collective_counts"].get("all-reduce", 0)
        if n:
            gb = r["collective_by_kind_bytes"]["all-reduce"] / 1e9
            lines.append(f"  reference all-reduces {n}: {gb:.4f} GB priced, {gb / n:.4f} GB "
                         "an all-reduce")
        lines.extend(memory_lines(p, r))
    return lines


def _peak(ma: dict) -> float:
    return (ma["temp_size_in_bytes"] + ma["argument_size_in_bytes"]
            + ma["output_size_in_bytes"] - ma["alias_size_in_bytes"])


def _memory(ma: dict) -> str:
    return (f"peak {_peak(ma) / 1e9:.3f} GB = temp {ma['temp_size_in_bytes'] / 1e9:.3f} + argument "
            f"{ma['argument_size_in_bytes']:.0f} B + output {ma['output_size_in_bytes']:.0f} B"
            f" − alias {ma['alias_size_in_bytes']:.0f} B")


def memory_lines(p: dict, r: dict) -> list:
    """The two sides' ``memory_analysis`` (module doc), where each has one."""
    lines = []
    if p.get("memory_analysis"):
        card = p.get("memory_vs_allocator")
        lines.append(f"  port memory: {_memory(p['memory_analysis'])}, at "
                     f"{p.get('peak_memory_op')}" + (
                         "" if card is None else
                         f"; the allocator's peak {card['allocator'] / 1e9:.3f} GB "
                         f"(gap {card['gap'] / 1e9:+.3f} GB)"))
    if r.get("memory_analysis"):
        lines.append(f"  reference memory: {_memory(r['memory_analysis'])}")
        if p.get("memory_analysis"):
            ratio = _peak(p["memory_analysis"]) / _peak(r["memory_analysis"])
            lines.append(f"  counted peak port / reference: {ratio:.2f}×")
    return lines


def summed_tensors(arch: str, shape: str, mesh: str, steps=None) -> list:
    """Lines of the sums one meta run of the combination issues (module
    doc): the run's own records are not written."""
    from repro_torch.launch import dryrun, topology

    seen: dict = {}
    group_sum = topology.Mesh._group_sum

    def counted(self, t, parts, group, kind, prefix):
        seen.setdefault((prefix, kind, parts), []).append(t.numel() * t.element_size())
        return group_sum(self, t, parts, group, kind, prefix)

    topology.Mesh._group_sum = counted
    try:
        dryrun.run_one(arch, shape, mesh, steps=steps)
    finally:
        topology.Mesh._group_sum = group_sum
    return [f"  sums {kind} over {g} ranks: {len(b)}, {sum(b) / 1e9:.4f} GB summed, "
            f"largest {max(b)} B" for (_p, kind, g), b in sorted(seen.items())]


def peak_breakdown(arch: str, shape: str, mesh: str, steps=None, top: int = 8) -> list:
    """Lines of what is live at each step's counted peak, by allocating
    operator, from one meta run of the combination (module doc)."""
    from repro_torch.launch import dryrun

    res = dryrun.run_one(arch, shape, mesh, steps=steps)
    lines = []
    for name, s in res["steps"].items():
        if not s.get("ok"):
            lines.append(f"  {name}: {s.get('error')}")
            continue
        ops = sorted(s["peak_memory_by_op"].items(), key=lambda kv: -kv[1])[:top]
        lines.append(f"  {name}: peak {s['peak_memory_per_device'] / 1e9:.3f} GB at "
                     f"{s['peak_memory_op']}; arguments "
                     f"{s['memory_analysis']['argument_size_in_bytes'] / 1e9:.3f} GB; live by "
                     "allocating operator: "
                     + ", ".join(f"{op} {b / 1e9:.3f}" for op, b in ops) + " GB")
    return lines


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--card", action="store_true",
                    help="read the port's card record (experiments/dryrun_torch/card/)")
    ap.add_argument("--sums", action="store_true",
                    help="run the steps on meta and count the inner groups' sums")
    ap.add_argument("--peak", action="store_true",
                    help="run the steps on meta and break each counted peak down by operator")
    ap.add_argument("--steps", default=None, help="comma-separated step names (--sums, --peak)")
    args = ap.parse_args()
    combo = f"{args.arch}__{args.shape}__{args.mesh}.json"
    sub = os.path.join("dryrun_torch", "card") if args.card else "dryrun_torch"
    port = _load(os.path.join(ROOT, "experiments", sub, combo))
    ref_path = os.path.join(ROOT, "experiments", "dryrun", combo)
    device = {s.get("device") for s in port["steps"].values()}
    if os.path.exists(ref_path):
        print(f"{combo[:-5]}: the port's record ({', '.join(sorted(map(str, device)))}) "
              "beside the reference's")
        print("\n".join(compare(port, _load(ref_path))))
    else:
        print(f"{combo[:-5]}: the reference has no record")
    if args.sums:
        steps = tuple(args.steps.split(",")) if args.steps else None
        print(f"the inner groups' sums of one meta run ({', '.join(steps or ('every step',))}):")
        print("\n".join(summed_tensors(args.arch, args.shape, args.mesh, steps)))
    if args.peak:
        steps = tuple(args.steps.split(",")) if args.steps else None
        print(f"the counted peaks of one meta run ({', '.join(steps or ('every step',))}):")
        print("\n".join(peak_breakdown(args.arch, args.shape, args.mesh, steps)))


if __name__ == "__main__":
    main()
