"""PyTorch + CUDA port of the BitROM serving system (reference: ``src/repro``).

The JAX package ``repro`` stays the reference; this package mirrors its
layout (``core``, ``kernels``, ``models``, ``serving``) so each module has
an obvious counterpart. Plain tensor code is PyTorch; every Pallas TPU
kernel on the ported path is a CUDA C++ kernel for Hopper (``csrc/``),
built with ``nvcc`` on first use and bound through ``ctypes``.

The port covers packed-ternary serving of every decoder family of the
reference's registry (``configs.list_configs()``: dense, MoE with MLA or
sliding-window attention, SSM, hybrid, and the VLM family with its patch
frontend) over the hot/cold tiered KV cache through the
continuous-batching ``serving.engine.Engine``, and the encoder-only audio
family's full-sequence ``models.transformer.forward`` (the engine refuses
it, as the reference's does), on both packed paths (act-quant in the matmul
kernel's prologue, or carried as int8 codes and row scales:
``BitNetConfig.fuse_act_quant``). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``, where every kernel wrapper runs its plain
PyTorch version.
"""
