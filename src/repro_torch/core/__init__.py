"""repro_torch.core — MARINA on the flat engine (PyTorch port of repro.core)."""

from .compressors import (
    BlockRandK,
    Compressor,
    Identity,
    RandK,
    make_compressor,
    tree_compress,
    tree_decompress,
    tree_dim,
    tree_payload_bits,
)
from .flat import (
    FlatEngine,
    FlatLayout,
    make_engine,
    make_layout,
    pack,
    pack_stacked,
    resolve_backend,
    unpack,
)
from .marina import Marina, MarinaState, StepMetrics
from .stepsize import marina_gamma

__all__ = [
    "BlockRandK", "Compressor", "FlatEngine", "FlatLayout", "Identity",
    "Marina", "MarinaState", "RandK", "StepMetrics", "make_compressor",
    "make_engine", "make_layout", "marina_gamma", "pack", "pack_stacked",
    "resolve_backend", "tree_compress", "tree_decompress", "tree_dim",
    "tree_payload_bits", "unpack",
]
