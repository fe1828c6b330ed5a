"""Act-quant-prologue packed-ternary matmul (reference:
``repro/kernels/ternary_matmul.py::ternary_matmul_actq_pallas`` through
``repro/kernels/ops.py::ternary_matmul_actq``).

RAW float activations x (M, K) and packed trits (ceil(K/g), N) go in;
per-row absmax -> ``scale = qmax / max(absmax, EPS)`` -> int8 codes ->
int8 x trit int32 accumulate -> ``acc_f32 * (col_scale[n] / scale[m])``
comes out as float32 (M, N). The CUDA kernel is
``csrc/ternary_matmul_actq.cu``; ``ternary_matmul_actq_plain`` beside it
is the same function in plain PyTorch, bit-identical to the kernel and to
the reference.

The reference pads M/N/K to its TPU block table; here nothing is padded:
the kernel masks the ragged M and N edges itself and reads activation
columns at or past the true K as zero, so a pack243 weight (K padded to
a multiple of 5 inside the packed bytes) needs no repair bytes.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import packing
from repro_torch.core.ternary import act_qrange, act_quant
from repro_torch.kernels.build import CudaKernel, ptr, stream_of

KERNEL = CudaKernel(
    "ternary_matmul_actq", "ternary_matmul_actq",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)
# largest K/g the kernel's shared-memory tile holds (8 rows of int8 codes
# at 4 or 8 bytes per packed group, plus the 32 KiB split-K reduction)
MAX_GROUPS = {"pack2": 5888, "pack243": 2944}


def ternary_acc_plain(xq: torch.Tensor, packed: torch.Tensor, k: int,
                      codec: str) -> torch.Tensor:
    """int8 (M, K) x packed (K/g, N) -> exact int32 accumulator (M, N).

    The product runs in float64 (every partial sum is an integer below
    2**53, so it is exact): integer ``matmul`` has no CUDA implementation."""
    trits = packing.unpack(packed, codec, k)
    acc = xq.to(torch.float64) @ trits.to(torch.float64)
    return acc.to(torch.int32)


def ternary_matmul_actq_plain(x: torch.Tensor, packed: torch.Tensor,
                              col_scale: torch.Tensor, k: int,
                              codec: str = "pack2", act_bits: int = 8) -> torch.Tensor:
    """Plain version of the kernel: act_quant -> exact accumulate -> rescale."""
    q = act_quant(x, bits=act_bits)
    acc = ternary_acc_plain(q.xq, packed, k, codec)
    return acc.to(torch.float32) * (col_scale.float() / q.scale)


def _launch(x2: torch.Tensor, packed: torch.Tensor, col_scale: torch.Tensor,
            k: int, codec: str, act_bits: int) -> torch.Tensor:
    m, n = x2.shape[0], packed.shape[1]
    kg = packed.shape[0]
    if not (x2.is_cuda and packed.is_cuda and col_scale.is_cuda):
        raise ValueError("ternary_matmul_actq: all operands must be CUDA tensors")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ternary_matmul_actq: x must be f32 or bf16, got {x2.dtype}")
    if packed.dtype != torch.uint8 or col_scale.dtype != torch.float32:
        raise TypeError("ternary_matmul_actq: packed must be uint8, col_scale f32")
    if kg * packing.group_of(codec) < k or x2.shape[1] != k:
        raise ValueError(f"ternary_matmul_actq: x K {x2.shape[1]} vs packed "
                         f"{tuple(packed.shape)} for k={k}, {codec}")
    if col_scale.shape != (n,):
        raise ValueError(f"ternary_matmul_actq: col_scale {tuple(col_scale.shape)} != ({n},)")
    if kg > MAX_GROUPS[codec]:
        raise ValueError(f"ternary_matmul_actq: K/g = {kg} exceeds {MAX_GROUPS[codec]}")
    qmax, _ = act_qrange(act_bits)
    x2 = x2.contiguous()
    packed = packed.contiguous()
    col_scale = col_scale.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    if m == 0 or n == 0:
        return out
    KERNEL.launch(
        ptr(x2), int(x2.dtype == torch.bfloat16), ptr(packed), ptr(col_scale),
        ptr(out), m, k, kg, n, packing.group_of(codec), act_bits, stream_of(x2),
    )
    return out


def ternary_matmul_actq(x: torch.Tensor, packed: torch.Tensor,
                        col_scale: torch.Tensor, *, k: int, codec: str = "pack2",
                        act_bits: int = 8, impl: str = "auto") -> torch.Tensor:
    """RAW float (..., K) x packed (ceil(K/g), N) -> float32 (..., N).

    ``impl="auto"`` launches the CUDA kernel for CUDA tensors and runs the
    plain version for CPU tensors; ``impl="plain"`` runs the plain version."""
    act_qrange(act_bits)  # reject unsupported widths on every path
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if impl == "plain" or (impl == "auto" and not x.is_cuda):
        out = ternary_matmul_actq_plain(x2, packed, col_scale, k, codec, act_bits)
    elif impl == "auto":
        out = _launch(x2, packed, col_scale, k, codec, act_bits)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    return out.reshape(lead + (packed.shape[1],))
