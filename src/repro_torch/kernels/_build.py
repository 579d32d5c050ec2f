"""Build and load the CUDA kernels: ``nvcc`` into a C-interface shared
library per source, loaded with ``ctypes``.

Each source in ``csrc/`` compiles at first use into ``build/repro_torch/``
at the root of the checkout (listed in ``.gitignore``), for ``sm_90a`` and
with FMA contraction off. The library name carries a hash of the sources and
flags, so an edited kernel is rebuilt and a stale one is never loaded.
:func:`build_all` compiles every source at once, one ``nvcc`` each.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("randk", "permk", "quantize", "epilogue", "paged", "yardstick")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_U = ctypes.c_uint32
_IP = ctypes.POINTER(ctypes.c_int)
#: argtypes of every exported entry point (all return cudaError_t as int)
SIGNATURES = {
    "randk": {
        "randk_seeded_workers": (_P, _P, _P, _P, _I, _L, _I, _I, _F, _P),
        "scatter_accum": (_P, _P, _P, _I, _L, _I, _I, _P),
        **{f"randk_gather_{t}": (_P, _P, _P, _L, _I, _I, _F, _P) for t in ("f32", "bf16")},
        **{f"randk_seeded_{t}": (_P, _U, _P, _P, _L, _I, _I, _F, _P)
           for t in ("f32", "bf16")},
        "l2_fetch_granularity": (_IP,),
        "set_l2_fetch_granularity": (_I,),
    },
    "permk": {
        "permk_seeded_workers_f32": (_P, _U, _P, _P, _I, _L, _I, _P),
        "permk_seeded_workers_bf16": (_P, _U, _P, _P, _I, _L, _I, _P),
    },
    "quantize": {
        "qsgd_block_workers_f32": (_P, _P, _P, _P, _I, _L, _I, _I, _P),
        "qsgd_block_workers_bf16": (_P, _P, _P, _P, _I, _L, _I, _I, _P),
        "qsgd_dequant_mean": (_P, _P, _P, _I, _L, _I, _I, _P),
        "nibble_pack": (_P, _P, _L, _P),
        "nibble_unpack": (_P, _P, _L, _P),
        "natural_block_workers_f32": (_P, _P, _P, _P, _I, _L, _I, _P),
        "natural_block_workers_bf16": (_P, _P, _P, _P, _I, _L, _I, _P),
        "natural_dequant_mean": (_P, _P, _P, _I, _L, _I, _P),
        "absmax_quant_rows_f32": (_P, _P, _P, _L, _I, _P),
        "absmax_quant_rows_bf16": (_P, _P, _P, _L, _I, _P),
        **{f"absmax_quant_write_pages_{t}": (_P, _P, _L, _L, _P, _P, _P, _P, _P, _P, _I, _I,
                                             _I, _I, _I, _P) for t in ("f32", "bf16")},
        "absmax_dequant_rows": (_P, _P, _P, _L, _I, _P),
        **{f"block_sumsq_{t}": (_P, _P, _L, _I, _P) for t in ("f32", "bf16")},
        **{f"qsgd_quantize_{t}": (_P, _P, _P, _P, _L, _I, _P) for t in ("f32", "bf16")},
        "qsgd_dequantize": (_P, _P, _P, _L, _I, _P),
    },
    "epilogue": {
        "scatter_epilogue_f32": (_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _F, _P),
        "scatter_epilogue_bf16": (_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _F, _P),
        "mean_epilogue_f32": (_P, _P, _P, _P, _I, _L, _F, _P),
        "mean_epilogue_bf16": (_P, _P, _P, _P, _I, _L, _F, _P),
        "delta_epilogue_f32": (_P, _P, _P, _P, _P, _L, _F, _P),
        "delta_epilogue_bf16": (_P, _P, _P, _P, _P, _L, _F, _P),
        "qsgd_epilogue_f32": (_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _F, _P),
        "qsgd_epilogue_bf16": (_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _F, _P),
        "natural_epilogue_f32": (_P, _P, _P, _P, _P, _P, _I, _L, _I, _F, _P),
        "natural_epilogue_bf16": (_P, _P, _P, _P, _P, _P, _I, _L, _I, _F, _P),
        **{f"trimmed_delta_epilogue_{b}_{x}": (_P, _P, _P, _P, _P, _I, _L, _I, _I, _F, _P)
           for b in ("f32", "bf16") for x in ("f32", "bf16")},
        **{f"trimmed_sync_epilogue_{b}_{x}": (_P, _P, _P, _P, _I, _L, _I, _I, _F, _P)
           for b in ("f32", "bf16") for x in ("f32", "bf16")},
    },
    "paged": {
        f"paged_attn_decode_{t}": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                                   _P)
        for t in ("f32", "bf16")
    },
    "yardstick": {
        "yardstick_gather": (_P, _P, _P, _L, _I, _I, _U, _I, _I, _P),
        "yardstick_affine": (_P, _U, _P, _P, _I, _L, _I, _I, _I, _P),
    },
}

_loaded: dict = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp, proc) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return log


def build_all() -> tuple[float, dict]:
    """Compile every source not yet built, all ``nvcc`` runs started
    together. Returns (seconds, {source: compiler output})."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in SOURCES}
    logs = {name: _finish(name, *started[name]) for name in SOURCES}
    return time.perf_counter() - t0, logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        out, tmp, proc = _start(name)
        _finish(name, out, tmp, proc)
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def entry(name: str, fn: str):
    """The bound C entry point ``fn`` of ``csrc/<name>.cu``, looked up once
    (a wrapper called per layer and decode step skips the lookup)."""
    return getattr(library(name), fn)


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
