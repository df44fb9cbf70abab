"""AdaPT in PyTorch: approximate-accelerator emulation with hand-written
CUDA LUT-GEMM kernels for Hopper.

The PyTorch port of the JAX package ``repro``, which stays the reference.
The modules mirror its layout (``core/``, ``kernels/<name>/{ops,ref}.py``,
``models/``, ``serve/``, ``train/``, ``optim/``, ``data/``); the CUDA
sources are in ``csrc/`` and build at first use (``kernels/runtime.py``).
"""
