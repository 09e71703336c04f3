"""PyTorch/CUDA port of the coded random-projection system.

A package beside the JAX reference ``repro`` with the same layout
(``core/``, ``kernels/``, ``encode/``, ``ann/``). It imports ``torch``
and ``numpy`` only. Entry points run on the CUDA card unless the caller
passes ``device="cpu"``; on the card each TPU kernel of the reference is
a hand-written CUDA kernel (``kernels/csrc``), on the CPU its plain
PyTorch version runs.
"""
