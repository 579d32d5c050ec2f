"""Serving: continuous batching over the paged KV cache (DESIGN.md
§8), with the static-batch path kept for A/B comparison — port of
``repro.launch.serve``.

Continuous mode threads one page-pool cache through one decode step per
iteration, joining prefill chunks into the running batch as slots and pages
free up; it takes global-attention models only, and raises the reference's
``ValueError`` for sliding-window and MLA layers. Static mode pads every
batch of requests to its longest prompt, prefills once and decodes until
the longest generation finishes, through the full, ring or latent cache or
the recurrent state of each layer, so it serves every config. Decoding is
greedy at ``temperature = 0`` (the first index of the largest logit); above
it each step draws ``prng.categorical`` (the Gumbel-max trick, JAX's
uniforms bit for bit) from logits / temperature, under a key split as the
reference splits it: once per batch's prefill and decode step in static
mode, once per prefill chunk and decode step in continuous mode. Every step
runs under ``torch.inference_mode()`` and writes the cache in place;
swapped-out snapshots live in host memory.

Usage (on the card unless ``--device`` names another):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --requests 32:24,32:4,8:4,8:4 --slots 4 --mode continuous
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
      --device cpu --mode static --batch 4 --prompt 32 --gen 16 --temperature 0.7
"""

from __future__ import annotations

import argparse
import json
import time
import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs import PUBLIC_TO_MODULE, get_arch
from repro_torch.core.paging import PagedLayout
from repro_torch.device import default_device
from repro_torch.launch.scheduler import ContinuousEngine, ContinuousScheduler, Request
from repro_torch.models import (
    decode_step,
    init_paged_cache,
    init_params,
    paged_copy_pages,
    paged_gather_pages,
    paged_scatter_pages,
    prefill,
)
from repro_torch.models import reduced as reduce_cfg

def scale_logits(logits: torch.Tensor, temperature: float, *, jitted: bool) -> torch.Tensor:
    """logits / temperature as the reference computes it: a true division
    where it runs eagerly (``run_static``), a multiply by float32(1 /
    temperature) in the paged steps, where XLA rewrites the division under
    ``jit`` (ROADMAP C)."""
    if jitted:
        return logits * float(np.float32(1) / np.float32(temperature))
    return logits / torch.tensor(temperature, dtype=logits.dtype, device=logits.device)


def sample(logits: torch.Tensor, temperature: float, key=None, *,
           jitted: bool = False) -> torch.Tensor:
    """Greedy (``temperature`` 0: the first index of the largest logit), or
    ``prng.categorical(key, logits / temperature)``."""
    if temperature > 0:
        return prng.categorical(key, scale_logits(logits, temperature, jitted=jitted))
    return torch.argmax(logits, dim=-1)


class KeyStream:
    """The reference's key threading: ``PRNGKey(seed)``, split once per
    draw (``next()`` returns the subkey)."""

    def __init__(self, seed: int):
        self.key = prng.PRNGKey(seed)

    def next(self):
        self.key, sub = prng.split(self.key)
        return sub


def _device_of(params) -> torch.device:
    return params["embed"].device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_requests(spec: str) -> list[tuple[int, int]]:
    """``"32:24,8:4"`` → [(prompt_len, gen_len), ...]."""
    out = []
    for part in spec.split(","):
        p, g = part.split(":")
        out.append((int(p), int(g)))
    return out


def make_workload(cfg, pairs, seed: int = 1) -> list[Request]:
    """One request per (prompt_len, gen_len): prompts drawn with ``prng``'s
    ``split`` / ``randint``, bit-equal to the reference's ``jax.random``."""
    key = prng.PRNGKey(seed)
    reqs = []
    for rid, (p, g) in enumerate(pairs):
        key, sub = prng.split(key)
        prompt = prng.randint(sub, (p,), 0, cfg.vocab_size).astype(np.int32)
        reqs.append(Request(rid=rid, prompt=prompt, max_new=g))
    return reqs


def build_paged_steps(params, cfg, *, temperature: float = 0.0, seed: int = 0,
                      backend: str = "auto") -> dict:
    """The engine's step functions over ``params``: the paged prefill chunk
    and decode step with their sampling (``serve_steps.paged_step_fns`` on
    a mesh of this process alone), and the COW / swap page ops. One set
    serves f32 and int8 caches and any number of engines (which then share
    one key stream, as the reference's steps do). At ``temperature`` > 0
    the key ``PRNGKey(seed)`` splits once per prefill chunk and decode
    step; greedy steps never touch it. ``backend`` ``ref`` runs the
    kernels' plain versions."""
    from repro_torch.launch.serve_steps import paged_step_fns
    from repro_torch.launch.topology import Mesh

    mesh = Mesh(axis_names=("data",), sizes=(1,), device=_device_of(params))
    decode, chunk = paged_step_fns(cfg, mesh, temperature=temperature, backend=backend)
    return engine_form(params, decode, chunk, temperature=temperature, seed=seed)


def engine_form(params, decode, chunk, *, temperature: float, seed: int) -> dict:
    """Paged steps in the engine's form: ``decode(params, cache, token,
    lens, tbl, key)`` and ``chunk(params, cache, tokens, start, row,
    n_valid, key)`` with numpy tokens out, the key ``PRNGKey(seed)`` split
    once per call at ``temperature`` > 0, and the COW / swap page ops."""
    keys = KeyStream(seed)

    def key():
        return keys.next() if temperature > 0 else None

    def prefill_fn(cache, toks, start, row, nv):
        tok, cache = chunk(params, cache, toks, start, row, nv, key())
        return tok.cpu().numpy(), cache

    def decode_fn(cache, toks, lengths, tables):
        tok, cache = decode(params, cache, toks, lengths, tables, key())
        return tok.cpu().numpy(), cache

    @torch.inference_mode()
    def copy_fn(cache, src, dst):
        return paged_copy_pages(cache, src, dst)

    @torch.inference_mode()
    def gather_fn(cache, ids):
        return paged_gather_pages(cache, ids)

    @torch.inference_mode()
    def scatter_fn(cache, ids, snap):
        return paged_scatter_pages(cache, ids, snap)

    return {"prefill": prefill_fn, "decode": decode_fn, "copy": copy_fn,
            "gather": gather_fn, "scatter": scatter_fn}


def build_engine(params, cfg, layout: PagedLayout, *, chunk: int,
                 temperature: float = 0.0, quantized: bool = False, seed: int = 0,
                 share_prefix: bool = False, admission: str = "expected",
                 steps: dict | None = None, backend: str = "auto") -> ContinuousEngine:
    """Single-process engine over the paged steps and one page-pool cache
    on the params' device. ``share_prefix`` maps cached prompt pages via the
    prefix index (COW on first write); ``admission`` picks the scheduler
    policy ("expected" = lazy pages + preemption, "reserve" = full
    reservation). Pass a :func:`build_paged_steps` dict via ``steps`` to
    share it across engines."""
    if steps is None:
        steps = build_paged_steps(params, cfg, temperature=temperature, seed=seed,
                                  backend=backend)
    with torch.inference_mode():
        cache = init_paged_cache(cfg, layout.npage, layout.page_size,
                                 params["embed"].dtype, quantized=quantized,
                                 device=_device_of(params))
    sched = ContinuousScheduler(layout, admission=admission, share_prefix=share_prefix)
    return ContinuousEngine(sched, cache, steps["prefill"], steps["decode"], chunk=chunk,
                            copy_fn=steps["copy"], gather_fn=steps["gather"],
                            scatter_fn=steps["scatter"])


def paged_layout(reqs: list[Request], *, slots: int, page_size: int,
                 npage: int | None = None) -> PagedLayout:
    """The pool for ``reqs``: block-table rows wide enough for the longest
    request and, unless ``npage`` is given, a worst-case request per slot
    plus the null page."""
    need = max(r.prompt_len + r.max_new for r in reqs)
    max_pages = -(-need // page_size)
    if npage is None:
        npage = 1 + slots * max_pages
    return PagedLayout(npage=npage, page_size=page_size, max_pages=max_pages,
                       n_slots=slots)


def run_continuous(params, cfg, reqs: list[Request], *, slots: int, page_size: int,
                   npage: int | None = None, chunk: int = 16, temperature: float = 0.0,
                   quantized: bool = False, share_prefix: bool = False,
                   admission: str = "expected", steps: dict | None = None,
                   backend: str = "auto", seed: int = 0):
    """Serve ``reqs`` with continuous batching; returns the ServeReport (each
    request's tokens are in ``req.generated``). The pool's conservation audit
    runs at the end. Global-attention models only: a sliding-window, MLA or
    recurrent layer raises the reference's ``ValueError``. ``seed`` keys the
    sampling (the reference's engine uses seed 0)."""
    layout = paged_layout(reqs, slots=slots, page_size=page_size, npage=npage)
    engine = build_engine(params, cfg, layout, chunk=chunk, temperature=temperature,
                          quantized=quantized, seed=seed, share_prefix=share_prefix,
                          admission=admission, steps=steps, backend=backend)
    report = engine.run(reqs)
    engine.sched.pool.check_conservation(engine.sched.tables)
    return report


@torch.inference_mode()
def run_static(params, cfg, reqs: list[Request], *, batch: int,
               temperature: float = 0.0, seed: int = 0):
    """Static batching: pad each batch of ``batch`` requests on the left to
    its longest prompt, prefill, decode until the longest generation
    finishes. tokens/s counts USEFUL tokens only (what each request asked
    for), so padding and overrun show up as lost throughput. Each request's
    first ``max_new`` tokens of its row go to ``req.generated``. At
    ``temperature`` > 0 the key ``PRNGKey(seed)`` splits once for each
    batch's prefill and once per decode step."""
    dev = _device_of(params)
    keys = KeyStream(seed)

    def pick(logits):
        return sample(logits, temperature, keys.next() if temperature > 0 else None)

    t0 = time.perf_counter()
    total_new = 0
    firsts, comps = [], []
    for i in range(0, len(reqs), batch):
        group = reqs[i:i + batch]
        pmax = max(r.prompt_len for r in group)
        gmax = max(r.max_new for r in group)
        toks = np.zeros((len(group), pmax), np.int32)
        for j, r in enumerate(group):
            toks[j, pmax - r.prompt_len:] = r.prompt  # left-pad
        logits, cache = prefill(params, cfg, torch.as_tensor(toks, device=dev),
                                max_len=pmax + gmax)
        tok = pick(logits)
        rows = [tok]
        _sync(dev)
        t_first = time.perf_counter()
        firsts += [(t_first - t0) * 1e3] * len(group)
        done_at = [None] * len(group)
        for step in range(1, gmax):
            lg, cache = decode_step(params, cfg, cache, tok, pmax + step - 1)
            tok = pick(lg)
            rows.append(tok)
            _sync(dev)
            now = time.perf_counter()
            for j, r in enumerate(group):
                if done_at[j] is None and step + 1 >= r.max_new:
                    done_at[j] = now
        now = time.perf_counter()
        out = torch.stack(rows, dim=1).cpu().numpy()
        for j, r in enumerate(group):
            r.generated = [int(t) for t in out[j, :r.max_new]]
            total_new += r.max_new
            comps.append(((done_at[j] or now) - t0) * 1e3)
    wall = time.perf_counter() - t0
    return {
        "n_requests": len(reqs),
        "total_new_tokens": total_new,
        "wall_s": wall,
        "tokens_per_s": total_new / wall if wall > 0 else 0.0,
        "first_token_p50_ms": float(np.percentile(firsts, 50)),
        "first_token_p99_ms": float(np.percentile(firsts, 99)),
        "completion_p50_ms": float(np.percentile(comps, 50)),
        "completion_p99_ms": float(np.percentile(comps, 99)),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(PUBLIC_TO_MODULE))
    ap.add_argument("--mode", choices=["continuous", "static"], default="continuous")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument(
        "--requests", default=None,
        help="mixed workload 'prompt:gen,prompt:gen,...' (overrides --batch/--prompt/--gen)",
    )
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument(
        "--reduced", action=argparse.BooleanOptionalAction, default=True,
        help="2-layer, d_model 128 config of the family (--no-reduced: the full arch)",
    )
    ap.add_argument("--quantized", action="store_true", help="int8 KV pages")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0, help="the sampling key's seed")
    ap.add_argument(
        "--share-prefix", action="store_true",
        help="map cached prompt pages via the prefix index (COW on write)",
    )
    ap.add_argument(
        "--admission", choices=["expected", "reserve"], default="expected",
        help="'expected' admits on fresh prompt pages and preempts under "
             "pressure; 'reserve' requires the full worst-case reservation",
    )
    ap.add_argument(
        "--npage", type=int, default=None,
        help="pool size override (default: worst-case fit for --slots)",
    )
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    cfg = reduce_cfg(arch.model, layers=2, d_model=128) if args.reduced else arch.model
    params = init_params(0, cfg, device=default_device(args.device))

    pairs = (
        parse_requests(args.requests)
        if args.requests
        else [(args.prompt, args.gen)] * args.batch
    )
    reqs = make_workload(cfg, pairs)

    if args.mode == "continuous":
        rep = run_continuous(
            params, cfg, reqs, slots=args.slots, page_size=args.page_size,
            npage=args.npage, chunk=args.chunk, temperature=args.temperature,
            quantized=args.quantized, share_prefix=args.share_prefix,
            admission=args.admission, seed=args.seed,
        ).to_dict()
    else:
        rep = run_static(params, cfg, reqs, batch=args.batch, temperature=args.temperature,
                         seed=args.seed)
    print(json.dumps(rep, indent=1))


if __name__ == "__main__":
    main()
