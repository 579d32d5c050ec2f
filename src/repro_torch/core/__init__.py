"""repro_torch.core — MARINA, VR-MARINA and PP-MARINA on the flat engine,
with the RandK, PermK, packed-QSGD, natural and RandK∘QSGD wires and the
compressed downlink, and the paper's baselines (DIANA, VR-DIANA, DCGD,
EC-SGD, GD) on the per-leaf tree path (PyTorch port of repro.core)."""

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
from .compressors import (
    QSGD,
    BlockNatural,
    BlockQSGD,
    BlockRandK,
    Compressor,
    CorrelatedCompressor,
    Identity,
    NaturalCompression,
    PermK,
    RandK,
    TopK,
    make_compressor,
    tree_compress,
    tree_compress_worker,
    tree_decompress,
    tree_dim,
    tree_omega,
    tree_payload_bits,
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
from .stepsize import diana_alpha, diana_gamma, marina_gamma

__all__ = [
    "DCGD", "DCGDState", "Diana", "DianaState", "ECSGD", "ECSGDState", "QSGD",
    "BlockNatural", "BlockQSGD", "BlockRandK", "Compressor",
    "CorrelatedCompressor", "FlatEngine", "FlatLayout", "Identity", "Marina",
    "MarinaState", "NaturalCompression", "PPMarina", "PermK", "RandK",
    "StepMetrics", "TopK", "VRDiana", "VRDianaState", "VRMarina", "diana_alpha",
    "diana_gamma", "make_compressor", "make_downlink", "make_engine", "make_gd",
    "make_layout", "marina_gamma", "pack", "pack_stacked", "pp_sample_cohort",
    "resolve_backend", "tree_compress", "tree_compress_worker", "tree_decompress",
    "tree_dim", "tree_omega", "tree_payload_bits", "unpack",
]
