"""Training loop wiring the MARINA family and the paper's baselines into LM
training — port of ``repro.train.trainer`` for ``method`` in ``marina``,
``vr_marina`` (the default, as in the reference), ``pp_marina``, ``diana``,
``dcgd``, ``ec_sgd`` and ``gd``.

The trainer simulates the n workers on one device (worker-stacked trees),
builds the fused flat engine for the ``block_randk``, ``permk``,
``block_qsgd`` and ``block_natural`` compressors (MARINA family; the
baselines compress on the per-leaf tree path, as in the reference), and
keeps the communication ledger in bits actually uplinked and received.
``downlink`` compresses the server's broadcast: with a flat engine through
a second engine over the uplink's layout (``"qsgd"``, ``"randk"`` or
``"natural"``, with ``downlink_kwargs`` ``s`` / ``kb``), without one
through the named per-leaf compressor (``make_compressor(downlink,
**downlink_kwargs)``); it and ``carry_grads``
are MARINA-family dials, refused elsewhere, as are ``aggregator`` (a rule
of :data:`repro_torch.core.aggregators.RULES`, with ``aggregator_f``) and
``faults`` (an attack of :data:`repro_torch.core.faults.ATTACKS`, with
``faults_frac`` and ``faults_scale``), which build a ``ServerAggregator`` /
``FaultSpec`` only when they differ from "mean" / "none". DIANA's shift stepsize is
``diana_alpha``, by default 1/(1 + ω) of the compressor's worst leaf (0.5
for a biased one).
VR-MARINA's compressed rounds take b′-minibatches from the data stream at
step ``10**7 + step``; PP-MARINA samples ``r_participating`` clients. The
step key is ``fold_in(PRNGKey(seed), step)``, as in the reference, so
``c_k``, the worker seeds and the cohorts of every round are the
reference's.

The reference scans chunks of steps on device; here a Python loop runs one
step at a time (PyTorch is eager) and records each step's wall time and
round type. With ``nonfinite_guard`` a step whose new state holds any NaN/inf
(a ``nan`` attack under the plain mean) is reverted and counted as skipped.

``alpha`` switches the token streams to the Dirichlet(α) federated dial;
``prefix_len`` gives every batch stub frontend embeddings from
``fold_in(PRNGKey(seed + 7), step)``. With ``ckpt_dir`` the trainer saves
``{"state", "bits", "down", "oracle", "skipped"}`` (the ledgers in float32)
after every step s with (s + 1) % ``ckpt_every`` == 0, in the reference's
file format, and resumes from the directory's latest checkpoint at s + 1:
a resumed run's state, c_k and ledgers are the uninterrupted run's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import prng
from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.core import (
    DCGD,
    ECSGD,
    BlockNatural,
    BlockQSGD,
    BlockRandK,
    CorrelatedCompressor,
    Diana,
    FaultSpec,
    Marina,
    PermK,
    PPMarina,
    ServerAggregator,
    VRMarina,
    diana_alpha,
    make_compressor,
    make_downlink,
    make_engine,
    make_gd,
    tree_dim,
    tree_omega,
)
from repro_torch.core.tree_util import (
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_norm,
    tree_unflatten,
    tree_worker_slice,
)
from repro_torch.data import HeterogeneousLMData, make_prefix_embeddings, worker_batches
from repro_torch.device import default_device
from repro_torch.models import lm_loss
from repro_torch.models.config import ModelConfig

PyTree = Any

MARINA_FAMILY = ("marina", "vr_marina", "pp_marina")
#: baselines whose ``init`` takes the parameters alone
PARAMS_ONLY_INIT = ("diana", "dcgd", "ec_sgd")

#: profiler spans (``torch.profiler.record_function``): one optimizer step,
#: between its two device synchronisations; one worker's forward + backward
SPAN_STEP = "train.step"
SPAN_GRAD = "train.grad"

#: the ledgers a checkpoint holds beside the state
LEDGERS = ("bits", "down", "oracle", "skipped")
#: the ledgers of each older checkpoint layout the resume falls back to, in
#: the reference's order: no skipped-rounds ledger (before the non-finite
#: guard), then no downlink ledger (before the compressed downlink)
OLDER_LAYOUTS = (("bits", "down", "oracle"), ("bits", "oracle"))


@dataclasses.dataclass
class TrainConfig:
    """The reference's fields."""

    method: str = "vr_marina"          # marina|vr_marina|pp_marina|diana|dcgd|ec_sgd|gd
    compressor: str = "randk"
    comp_kwargs: dict = dataclasses.field(default_factory=lambda: {"k": 0.01})
    gamma: float = 0.05
    p: Optional[float] = None          # None → ζ_Q/d (Cor. 2.1)
    n_workers: int = 4
    batch_per_worker: int = 8          # b  (sync rounds / full batches)
    mb_per_worker: int = 2             # b' (VR-MARINA compressed rounds)
    r_participating: int = 2           # PP-MARINA cohort size r
    pp_replace: bool = True            # i.i.d. cohort (False: distinct clients)
    pp_weights: Optional[Any] = None   # client weights (raw counts are fine)
    # Dirichlet non-IID dial for the LM data (None → the legacy
    # heterogeneity scalar): 0.1 near-single-region clients, np.inf iid
    alpha: Optional[float] = None
    steps: int = 100
    seed: int = 0
    log_every: int = 10
    ckpt_dir: Optional[str] = None     # resume from its latest checkpoint
    ckpt_every: int = 0                # save after every ckpt_every-th step (0: never)
    diana_alpha: Optional[float] = None  # None → 1/(1+ω), ω of the worst leaf
    flat_backend: str = "auto"         # kernel backend for the flat engine
    carry_grads: bool = False
    # compressed downlink: the sampler of Q_down(g^{k+1} − g^k) over the flat
    # engine's layout ("qsgd" | "randk" | "natural"), or without an engine a
    # per-leaf compressor's name; None = dense broadcast
    downlink: Optional[str] = None
    downlink_kwargs: dict = dataclasses.field(default_factory=dict)
    # Byzantine-robust server aggregation and client faults (MARINA family):
    # a GAR name with its assumed Byzantine count, an attack with its faulty
    # fraction and amplitude; "mean" / "none" leave the honest path as it is
    aggregator: str = "mean"
    aggregator_f: int = 0
    faults: str = "none"
    faults_frac: float = 0.0
    faults_scale: float = 1.0
    # revert a round whose new state holds any NaN/inf and count it skipped
    nonfinite_guard: bool = True


@dataclasses.dataclass
class TrainMetrics:
    step: list = dataclasses.field(default_factory=list)
    loss: list = dataclasses.field(default_factory=list)
    grad_est_norm: list = dataclasses.field(default_factory=list)
    bits_cum: list = dataclasses.field(default_factory=list)
    down_cum: list = dataclasses.field(default_factory=list)
    oracle_cum: list = dataclasses.field(default_factory=list)
    wall: list = dataclasses.field(default_factory=list)
    skipped_cum: list = dataclasses.field(default_factory=list)
    #: per optimizer step (not per log point): c_k, the bits booked up and
    #: down, and the step's wall seconds, ended by a device synchronisation
    round_sync: list = dataclasses.field(default_factory=list)
    round_bits: list = dataclasses.field(default_factory=list)
    round_down_bits: list = dataclasses.field(default_factory=list)
    step_seconds: list = dataclasses.field(default_factory=list)


def _state_finite(state) -> bool:
    """Every floating tensor of the optimizer state (params, estimator g,
    carried h, DIANA's shifts, EC-SGD's errors, …) is all-finite."""
    parts = [getattr(state, f.name) for f in dataclasses.fields(state)]
    leaves = [t for t in tree_leaves(parts)
              if isinstance(t, torch.Tensor) and torch.is_floating_point(t)]
    if not leaves:
        return True
    return bool(torch.stack([torch.isfinite(t).all() for t in leaves]).all())


class Trainer:
    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 init_params: PyTree, prefix_len: int = 0, device=None):
        m = train_cfg.method
        if m not in MARINA_FAMILY + PARAMS_ONLY_INIT + ("gd",):
            raise ValueError(f"unknown method {m!r}")
        if train_cfg.downlink is not None and m not in MARINA_FAMILY:
            # refuse rather than broadcast dense while the user believes the
            # downlink is compressed
            raise ValueError(f"downlink is a marina-family mode, not {m!r}")
        if train_cfg.carry_grads and m not in MARINA_FAMILY:
            raise ValueError(f"carry_grads is a marina-family mode, not {m!r}")
        # None when the dial is the honest default, as in the reference
        agg = (ServerAggregator(train_cfg.aggregator, f=train_cfg.aggregator_f)
               if train_cfg.aggregator != "mean" else None)
        fspec = (FaultSpec(train_cfg.faults, frac=train_cfg.faults_frac,
                           scale=train_cfg.faults_scale)
                 if train_cfg.faults != "none" else None)
        if (agg is not None or fspec is not None) and m not in MARINA_FAMILY:
            raise ValueError(f"aggregator/faults are marina-family dials, not {m!r}")
        self.device = default_device(device)
        self.mcfg = model_cfg
        self.tcfg = train_cfg
        self.prefix_len = prefix_len
        self.data = HeterogeneousLMData(
            n_workers=train_cfg.n_workers,
            vocab_size=model_cfg.vocab_size,
            seq_len=128 if model_cfg.num_layers <= 4 else 256,
            seed=train_cfg.seed,
            alpha=train_cfg.alpha,
        )
        self._prefix_key = prng.PRNGKey(train_cfg.seed + 7)

        def loss_fn(params, batch):
            return lm_loss(params, model_cfg, batch["tokens"], batch.get("prefix"))

        def grad_fn(params, batch):
            with record_function(SPAN_GRAD):
                leaves, treedef = tree_flatten(params)
                leaves = [t.detach().requires_grad_(True) for t in leaves]
                loss = loss_fn(tree_unflatten(treedef, leaves), batch)
                return tree_unflatten(treedef, torch.autograd.grad(loss, leaves))

        self.loss_fn = loss_fn
        self.params0 = tree_map(lambda t: t.to(self.device), init_params)
        d = tree_dim(self.params0)
        comp = make_compressor(train_cfg.compressor, **train_cfg.comp_kwargs)
        if isinstance(comp, CorrelatedCompressor) and comp.n == 0:
            # correlated collections are sized by the worker fleet
            comp = dataclasses.replace(comp, n=train_cfg.n_workers)
        self.p = train_cfg.p if train_cfg.p is not None else comp.default_p(d)
        self.comp = comp
        self.engine = None
        if isinstance(comp, BlockRandK):
            self.engine = make_engine(self.params0, kb=comp.kb, block=comp.block,
                                      backend=train_cfg.flat_backend,
                                      device=self.device)
        elif isinstance(comp, PermK):
            self.engine = make_engine(self.params0, block=comp.block,
                                      backend=train_cfg.flat_backend,
                                      sampler="permk", device=self.device)
        elif isinstance(comp, BlockQSGD):
            self.engine = make_engine(self.params0, block=comp.block,
                                      backend=train_cfg.flat_backend,
                                      sampler="qsgd", s=comp.s, device=self.device)
        elif isinstance(comp, BlockNatural):
            self.engine = make_engine(self.params0, block=comp.block,
                                      backend=train_cfg.flat_backend,
                                      sampler="natural", device=self.device)
        self.down_engine, self.down_comp = self._downlink(train_cfg)
        tc, carry = train_cfg, train_cfg.carry_grads
        down = dict(down_compressor=self.down_comp, down_engine=self.down_engine)
        if m == "marina":
            self.method = Marina(grad_fn, comp, tc.gamma, self.p, self.engine,
                                 carry=carry, aggregator=agg, faults=fspec, **down)
        elif m == "vr_marina":
            self.method = VRMarina(grad_fn, grad_fn, comp, tc.gamma, self.p,
                                   self.engine, carry=carry, aggregator=agg,
                                   faults=fspec, **down)
        elif m == "pp_marina":
            self.method = PPMarina(grad_fn, comp, tc.gamma, self.p,
                                   tc.r_participating, self.engine,
                                   replace=tc.pp_replace, weights=tc.pp_weights,
                                   carry=carry, aggregator=agg, faults=fspec, **down)
        elif m == "gd":
            self.method = make_gd(grad_fn, tc.gamma)
        elif m == "diana":
            alpha = tc.diana_alpha
            if alpha is None:
                # the per-leaf lifted compressor's worst-leaf ω, not ω of the
                # whole tree's dimension (as the reference)
                alpha = (diana_alpha(max(tree_omega(comp, self.params0), 1e-9))
                         if comp.unbiased else 0.5)
            self.method = Diana(grad_fn, comp, tc.gamma, alpha, tc.n_workers)
        elif m == "dcgd":
            self.method = DCGD(grad_fn, comp, tc.gamma, tc.n_workers)
        else:
            self.method = ECSGD(grad_fn, comp, tc.gamma, tc.n_workers)

    def _downlink(self, tc: TrainConfig):
        """(downlink engine, per-leaf downlink compressor): with a flat
        engine, a second engine over its layout (the name is its sampler);
        without one, the named tree compressor; (None, None) for the dense
        broadcast."""
        if tc.downlink is None:
            return None, None
        dkw = tc.downlink_kwargs
        if self.engine is None:
            return None, make_compressor(tc.downlink, **dkw)
        name = tc.downlink.removeprefix("block_")
        if name not in ("randk", "qsgd", "natural"):
            raise ValueError(f"downlink {tc.downlink!r} is not broadcastable "
                             "(permk partitions across receivers)")
        return make_downlink(self.engine, sampler=name, kb=dkw.get("kb"),
                             s=dkw.get("s")), None

    # ------------------------------------------------------------------
    def _batches(self, step: int, per_worker: int) -> dict:
        batch = {"tokens": worker_batches(self.data, step, per_worker, self.device)}
        if self.prefix_len:
            batch["prefix"] = make_prefix_embeddings(
                prng.fold_in(self._prefix_key, step), self.tcfg.n_workers, per_worker,
                self.prefix_len, self.mcfg.d_model, self.device)
        return batch

    def _step(self, state, key, step: int):
        """One optimizer step; VR-MARINA also takes the step's minibatches."""
        full = self._batches(step, self.tcfg.batch_per_worker)
        if self.tcfg.method == "vr_marina":
            mb = self._batches(10**7 + step, self.tcfg.mb_per_worker)
            return self.method.step(state, key, full, mb)
        return self.method.step(state, key, full)

    def eval_loss(self, params, step: int = 10**6) -> float:
        b = self._batches(step, self.tcfg.batch_per_worker)
        with torch.no_grad():
            losses = [float(self.loss_fn(params, tree_worker_slice(b, w)))
                      for w in range(self.tcfg.n_workers)]
        return sum(losses) / len(losses)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, step_hook: Optional[Callable[[int], None]] = None):
        """Train ``steps`` rounds from ``init_params``. Returns the final
        :class:`MarinaState` and the :class:`TrainMetrics` history.
        ``step_hook(step)``, if given, runs after each step's closing
        synchronisation and before its evaluation (e.g. ``profiler.step``)."""
        tc = self.tcfg
        if tc.method in PARAMS_ONLY_INIT:
            state = self.method.init(self.params0)
        else:
            state = self.method.init(self.params0, self._batches(0, tc.batch_per_worker))
        state, start, ledgers = self._resume(state)
        bits, down, oracle, skipped = (ledgers[k] for k in LEDGERS)
        hist = TrainMetrics()
        t0 = time.time()

        def log(step, loss, gnorm):
            hist.step.append(step)
            hist.loss.append(loss)
            hist.grad_est_norm.append(gnorm)
            hist.bits_cum.append(bits)
            hist.down_cum.append(down)
            hist.oracle_cum.append(oracle)
            hist.wall.append(time.time() - t0)
            hist.skipped_cum.append(skipped)

        # the curve's anchor: the state the run starts from, 0 bits if fresh
        log(start - 1, self.eval_loss(state.params, start),
            float(tree_norm(state.g)) if hasattr(state, "g") else 0.0)
        base_key = prng.PRNGKey(tc.seed)
        # the oracle ledger sums the rounds between two log / checkpoint
        # steps in float32, then adds that sum, as the reference's scan
        # carries it (each round books float32(r/n) there too)
        chunk_oracle = np.float32(0.0)
        for step in range(start, tc.steps):
            self._sync()
            ts = time.perf_counter()
            with record_function(SPAN_STEP):
                key = prng.fold_in(base_key, step)
                new_state, met = self._step(state, key, step)
                gnorm = met.grad_est_norm
                if tc.nonfinite_guard and not _state_finite(new_state):
                    # revert the entire state: finite h/g paired with reverted
                    # params would desynchronize the estimator recursion
                    new_state, gnorm = state, torch.zeros(())
                    skipped += 1.0
                state = new_state
                bits += met.bits_per_worker
                down += met.down_bits
                chunk_oracle = np.float32(chunk_oracle + np.float32(met.oracle_calls))
                self._sync()
            hist.step_seconds.append(time.perf_counter() - ts)
            hist.round_sync.append(met.sync_round)
            hist.round_bits.append(met.bits_per_worker)
            hist.round_down_bits.append(met.down_bits)
            if step_hook is not None:
                step_hook(step)
            is_log = (step + 1) % tc.log_every == 0 or step == tc.steps - 1
            is_ckpt = bool(tc.ckpt_dir and tc.ckpt_every and (step + 1) % tc.ckpt_every == 0)
            if is_log or is_ckpt:
                oracle += float(chunk_oracle)
                chunk_oracle = np.float32(0.0)
            if is_log:
                log(step, self.eval_loss(state.params, step), float(gnorm))
            if is_ckpt:
                save_checkpoint(tc.ckpt_dir, step, {
                    "state": state, "bits": np.float32(bits), "down": np.float32(down),
                    "oracle": np.float32(oracle), "skipped": np.float32(skipped)})
        return state, hist

    def _resume(self, state):
        """(state, first step, ledgers) from ``ckpt_dir``'s latest
        checkpoint, or (``state``, 0, zeros) without one. The ledgers resume
        with the state (as saved: float32). A checkpoint of an older layout
        loads with the ledgers it has (the rest 0), and a bare state tree
        with zeroed ledgers — each tier tried on a ``KeyError``; a corrupt
        file raises :class:`CheckpointCorruptionError` from the first."""
        tc = self.tcfg
        zeros = dict.fromkeys(LEDGERS, 0.0)
        s = latest_step(tc.ckpt_dir) if tc.ckpt_dir else None
        if s is None:
            return state, 0, zeros
        for names in (LEDGERS,) + OLDER_LAYOUTS:
            like = {"state": state, **{k: np.zeros((), np.float32) for k in names}}
            try:
                ck = load_checkpoint(tc.ckpt_dir, s, like)
            except KeyError:
                continue
            return ck["state"], s + 1, {**zeros, **{k: float(ck[k]) for k in names}}
        return load_checkpoint(tc.ckpt_dir, s, state), s + 1, zeros
