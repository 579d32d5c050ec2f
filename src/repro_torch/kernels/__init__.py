"""Hand-written Hopper kernels of the compression and serving hot paths and
of the flat-vector wire, with their plain versions.

* ``randk.py``    — seeded RandK uplink (`randk_seeded_workers`), the
                    server scatter-mean (`scatter_accum`) and the
                    flat-vector gathers (`randk_gather` at host-supplied
                    offsets, `randk_seeded` under one seed), over
                    ``csrc/randk.cu``.
* ``permk.py``    — PermK uplink with one shared seed
                    (`permk_seeded_workers`), over ``csrc/permk.cu``.
* ``quantize.py`` — packed quantization wire: blockwise QSGD uplink
                    (`qsgd_block_workers`), dequantize-and-mean
                    (`qsgd_dequant_mean`), the 4-bit words
                    (`nibble_pack`, `nibble_unpack`) and blockwise
                    natural compression (`natural_block_workers`,
                    `natural_dequant_mean`), the int8 KV-page rows
                    (`absmax_quant_rows`, also as the one-launch page
                    write `absmax_quant_write_pages`, counted under it,
                    and `absmax_dequant_rows`) and the
                    two-pass global-norm QSGD of the flat-vector wire
                    (`block_sumsq`, `qsgd_quantize`, `qsgd_dequantize`),
                    over ``csrc/quantize.cu``.
* ``epilogue.py`` — fused server epilogues (`scatter_epilogue`,
                    `delta_epilogue`, `qsgd_epilogue`,
                    `natural_epilogue`, `mean_epilogue`) and the robust
                    trimmed pair (`trimmed_delta_epilogue`,
                    `trimmed_sync_epilogue`), over ``csrc/epilogue.cu``.
* ``paged.py``    — paged-KV decode attention (`paged_attn_decode`), over
                    ``csrc/paged.cu``, and the int8-page route
                    (`paged_attn_decode_q8`).
* ``ops.py``      — the flat-vector wire (`randk_compress`,
                    `randk_decompress_mean`, `qsgd_compress`,
                    `qsgd_decompress`) over those wrappers.
* ``yardstick.py`` — random-gather yardsticks over ``csrc/yardstick.cu``:
                    no path calls them and they port no TPU kernel;
                    ``chip_smoke.py`` times them beside the RandK and
                    PermK gathers.
* ``ref.py``      — plain PyTorch versions: the CPU path of every wrapper
                    and the yardstick the kernels are held against on the card.
* ``_build.py``   — ``nvcc`` → shared library → ``ctypes``, at first use.
"""

from . import epilogue, paged, permk, quantize, randk, ref

#: every kernel wrapper, by name
KERNELS = {
    "randk_seeded_workers": randk.randk_seeded_workers,
    "scatter_accum": randk.scatter_accum,
    "scatter_epilogue": epilogue.scatter_epilogue,
    "mean_epilogue": epilogue.mean_epilogue,
    "permk_seeded_workers": permk.permk_seeded_workers,
    "delta_epilogue": epilogue.delta_epilogue,
    "qsgd_block_workers": quantize.qsgd_block_workers,
    "nibble_pack": quantize.nibble_pack,
    "nibble_unpack": quantize.nibble_unpack,
    "qsgd_dequant_mean": quantize.qsgd_dequant_mean,
    "qsgd_epilogue": epilogue.qsgd_epilogue,
    "natural_block_workers": quantize.natural_block_workers,
    "natural_dequant_mean": quantize.natural_dequant_mean,
    "natural_epilogue": epilogue.natural_epilogue,
    "trimmed_delta_epilogue": epilogue.trimmed_delta_epilogue,
    "trimmed_sync_epilogue": epilogue.trimmed_sync_epilogue,
    "absmax_quant_rows": quantize.absmax_quant_rows,
    "absmax_dequant_rows": quantize.absmax_dequant_rows,
    "paged_attn_decode": paged.paged_attn_decode,
    "randk_gather": randk.randk_gather,
    "randk_seeded": randk.randk_seeded,
    "block_sumsq": quantize.block_sumsq,
    "qsgd_quantize": quantize.qsgd_quantize,
    "qsgd_dequantize": quantize.qsgd_dequantize,
}


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["KERNELS", "epilogue", "launch_counts", "paged", "permk", "quantize", "randk",
           "ref", "reset_launch_counts"]
