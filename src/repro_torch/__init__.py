"""PyTorch + CUDA port of the BitROM serving system (reference: ``src/repro``).

The JAX package ``repro`` stays the reference; this package mirrors its
layout (``core``, ``kernels``, ``models``, ``serving``) so each module has
an obvious counterpart. Plain tensor code is PyTorch; every Pallas TPU
kernel on the ported path is a CUDA C++ kernel for Hopper (``csrc/``),
built with ``nvcc`` on first use and bound through ``ctypes``.

This slice covers the dense packed-ternary serving path of falcon3-1b:
ternary projections, fused-RoPE flash decode and flash prefill over the
contiguous hot/cold tiered KV cache, and the continuous-batching
``serving.engine.Engine``. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``, where every kernel wrapper runs its plain PyTorch
version.
"""
