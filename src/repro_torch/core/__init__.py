"""repro_torch.core — MARINA, VR-MARINA and PP-MARINA on the flat engine,
with the RandK, PermK and packed-QSGD wires and the compressed downlink
(PyTorch port of repro.core)."""

from .compressors import (
    BlockQSGD,
    BlockRandK,
    Compressor,
    CorrelatedCompressor,
    Identity,
    PermK,
    RandK,
    make_compressor,
    tree_compress,
    tree_compress_worker,
    tree_decompress,
    tree_dim,
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
    pp_sample_cohort,
)
from .stepsize import marina_gamma

__all__ = [
    "BlockQSGD", "BlockRandK", "Compressor", "CorrelatedCompressor",
    "FlatEngine", "FlatLayout", "Identity", "Marina", "MarinaState", "PPMarina",
    "PermK", "RandK", "StepMetrics", "VRMarina", "make_compressor",
    "make_downlink", "make_engine", "make_layout", "marina_gamma", "pack",
    "pack_stacked", "pp_sample_cohort", "resolve_backend", "tree_compress",
    "tree_compress_worker", "tree_decompress", "tree_dim", "tree_payload_bits",
    "unpack",
]
