"""PyTorch / CUDA port of the MARINA repro (``repro``), for one NVIDIA H100.

Mirrors ``repro``'s layout (``core/``, ``kernels/``, ``models/``, ``data/``,
``train/``, ``configs/``); imports ``torch``, never ``jax`` or ``repro``.
"""
