"""Production training entry point — the CLI twin of ``repro.launch.train``.

Selects an architecture (``--arch``), a MARINA-family method and a
compressor, and trains it through the port's :class:`~repro_torch.train.Trainer`
(all n workers simulated in one process, as the reference's CLI does —
its ``--backend mesh`` is a docstring only), printing the loss and the
communication ledger. ``--reduced`` trains the reduced variant. On the card
unless ``--device`` names another (it raises without a card).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 20 \\
      --method vr_marina --compressor randk --k 0.02 --reduced --device cpu
"""

from __future__ import annotations

import argparse

from repro_torch.configs import PUBLIC_TO_MODULE, get_arch
from repro_torch.device import default_device
from repro_torch.models import init_params, param_count
from repro_torch.models import reduced as reduce_cfg
from repro_torch.train import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(PUBLIC_TO_MODULE))
    ap.add_argument("--method", default="vr_marina")
    ap.add_argument("--compressor", default="randk")
    ap.add_argument("--k", type=float, default=0.02)
    ap.add_argument("--gamma", type=float, default=0.2)
    ap.add_argument("--p", type=float, default=None)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--mb", type=int, default=2)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced variant (CPU-feasible)")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="where to train (default: the card; raises without one)")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    arch = get_arch(args.arch)
    cfg = (reduce_cfg(arch.model, layers=args.layers, d_model=args.d_model)
           if args.reduced else arch.model)
    params = init_params(0, cfg, device=device)
    print(f"arch={args.arch} ({'reduced' if args.reduced else 'FULL'}) "
          f"params={param_count(params):,} method={args.method}")

    comp_kwargs = {"k": args.k} if args.compressor in ("randk", "shared_randk", "topk") else {}
    tcfg = TrainConfig(
        method=args.method,
        compressor=args.compressor,
        comp_kwargs=comp_kwargs,
        gamma=args.gamma,
        p=args.p,
        n_workers=args.workers,
        batch_per_worker=args.batch,
        mb_per_worker=args.mb,
        steps=args.steps,
        log_every=max(1, args.steps // 10),
        ckpt_dir=args.ckpt_dir,
        ckpt_every=max(1, args.steps // 3) if args.ckpt_dir else 0,
    )
    trainer = Trainer(cfg, tcfg, params, prefix_len=8 if arch.prefix_len else 0,
                      device=device)
    _, hist = trainer.run()
    print(f"\n{'step':>6} {'loss':>9} {'Mbits/worker':>13} {'oracle':>9}")
    for s, l, b, o in zip(hist.step, hist.loss, hist.bits_cum, hist.oracle_cum):
        print(f"{s:>6} {l:>9.4f} {b / 1e6:>13.2f} {o:>9.0f}")
    return hist


if __name__ == "__main__":
    main()
