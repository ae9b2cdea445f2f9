"""PyTorch/CUDA port of the DMS hyper-scaling system, beside the JAX
reference package ``repro``.

It mirrors the reference's layout (``core/``, ``configs/``, ``models/``,
``kernels/``, ``serving/``), imports ``torch`` and numpy and never JAX or
the reference package, and runs its hand-written kernels on an NVIDIA
Hopper card.  Entry points default to ``device="cuda"``; the CPU tests pass
``device="cpu"`` and run each kernel's plain PyTorch version instead.
"""
