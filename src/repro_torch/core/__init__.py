"""repro_torch.core — MARINA, VR-MARINA and PP-MARINA on the flat engine,
with the RandK, PermK, packed-QSGD, natural and RandK∘QSGD wires, the
per-leaf compressors (SharedRandK and CorrelatedQ included), the
compressed downlink (a flat engine or a per-leaf compressor), Byzantine-robust aggregation and client fault
injection, deadline-cohort MARINA, and the paper's baselines (DIANA,
VR-DIANA, DCGD, EC-SGD, GD) on the per-leaf tree path (PyTorch port of
repro.core)."""

from .aggregators import RULES, ServerAggregator
from .async_rounds import AsyncMarinaState, AsyncStepMetrics, DeadlineMarina

from .baselines import (
    DCGD,
    DCGDState,
    Diana,
    DianaState,
    ECSGD,
    ECSGDState,
    VRDiana,
    VRDianaState,
)
from .faults import ATTACKS, FaultSpec, flip_binclass_labels
from .compressors import (
    QSGD,
    BlockNatural,
    BlockQSGD,
    BlockRandK,
    Compressor,
    CorrelatedCompressor,
    CorrelatedQ,
    Identity,
    NaturalCompression,
    PermK,
    RandK,
    SharedRandK,
    TopK,
    make_compressor,
    tree_ab_constants,
    tree_compress,
    tree_compress_worker,
    tree_decompress,
    tree_dim,
    tree_omega,
    tree_payload_bits,
    tree_roundtrip,
)
from .flat import (
    FlatEngine,
    FlatLayout,
    make_downlink,
    make_engine,
    make_layout,
    pack,
    pack_stacked,
    resolve_backend,
    unpack,
)
from .marina import (
    Marina,
    MarinaState,
    PPMarina,
    StepMetrics,
    VRMarina,
    make_gd,
    pp_sample_cohort,
)
from .roundtime import TIME_FOLD, RoundTimeModel
from .stepsize import (
    ab_from_omega,
    async_marina_gamma,
    diana_alpha,
    diana_gamma,
    marina_comm_per_worker,
    marina_gamma,
    marina_gamma_ab,
    marina_gamma_permk,
    marina_gamma_pl,
    marina_iteration_bound,
    permk_default_p,
    pp_marina_gamma,
    robust_marina_gamma,
    robust_n_eff,
    robust_pp_marina_gamma,
    vr_marina_gamma,
)

__all__ = [
    "ATTACKS", "AsyncMarinaState", "AsyncStepMetrics", "DeadlineMarina", "FaultSpec",
    "RULES", "RoundTimeModel", "ServerAggregator", "TIME_FOLD", "async_marina_gamma",
    "flip_binclass_labels", "robust_marina_gamma", "robust_n_eff",
    "robust_pp_marina_gamma",
    "DCGD", "DCGDState", "Diana", "DianaState", "ECSGD", "ECSGDState", "QSGD",
    "BlockNatural", "BlockQSGD", "BlockRandK", "Compressor",
    "CorrelatedCompressor", "CorrelatedQ", "FlatEngine", "FlatLayout", "Identity",
    "Marina", "MarinaState", "NaturalCompression", "PPMarina", "PermK", "RandK",
    "SharedRandK", "StepMetrics", "TopK", "VRDiana", "VRDianaState", "VRMarina",
    "ab_from_omega", "diana_alpha", "diana_gamma", "make_compressor", "make_downlink",
    "make_engine", "make_gd", "make_layout", "marina_comm_per_worker", "marina_gamma",
    "marina_gamma_ab", "marina_gamma_permk", "marina_gamma_pl", "marina_iteration_bound",
    "pack", "pack_stacked", "permk_default_p", "pp_marina_gamma", "pp_sample_cohort",
    "resolve_backend", "tree_ab_constants", "tree_compress", "tree_compress_worker",
    "tree_decompress", "tree_dim", "tree_omega", "tree_payload_bits", "tree_roundtrip",
    "unpack", "vr_marina_gamma",
]
