"""Hand-written Hopper kernels of the compression hot path + plain versions.

* ``randk.py``    — seeded RandK uplink (`randk_seeded_workers`) and the
                    server scatter-mean (`scatter_accum`), over
                    ``csrc/randk.cu``.
* ``epilogue.py`` — fused server epilogues (`scatter_epilogue`,
                    `mean_epilogue`), over ``csrc/epilogue.cu``.
* ``ref.py``      — plain PyTorch versions: the CPU path of every wrapper
                    and the yardstick the kernels are held against on the card.
* ``_build.py``   — ``nvcc`` → shared library → ``ctypes``, at first use.
"""

from . import epilogue, randk, ref

#: every kernel wrapper of the main path, by name
KERNELS = {
    "randk_seeded_workers": randk.randk_seeded_workers,
    "scatter_accum": randk.scatter_accum,
    "scatter_epilogue": epilogue.scatter_epilogue,
    "mean_epilogue": epilogue.mean_epilogue,
}


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["KERNELS", "epilogue", "launch_counts", "randk", "ref",
           "reset_launch_counts"]
