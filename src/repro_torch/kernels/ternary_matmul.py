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

``ternary_matmul_expert`` (reference: ``kernels/ops.py::
ternary_matmul_expert``) is the same function over a leading expert
dimension — x (E, C, K), packed (E, K/g, N), per-column scales (E, N) —
in ONE launch of the same kernel (expert index on the grid's z axis),
with its own launch count. Its plain version walks the experts in chunks:
unpacking all 256 DeepSeek-V3 experts to float64 at once would take 60 GB.
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
EXPERT_KERNEL = CudaKernel(
    "ternary_matmul_actq", "ternary_matmul_actq_expert",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p],
)
# experts unpacked at once by the plain expert version (float64 trits of
# 16 DeepSeek-V3 w_gu experts: 16 x 7168 x 4096 x 8 B = 3.8 GB)
PLAIN_EXPERT_CHUNK = 16
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


def ternary_matmul_expert_plain(x: torch.Tensor, packed: torch.Tensor,
                                col_scale: torch.Tensor, k: int, codec: str = "pack2",
                                act_bits: int = 8) -> torch.Tensor:
    """Plain version of the expert form: per-row act_quant, then for each
    chunk of experts an exact float64 batched accumulate and the rescale."""
    q = act_quant(x, bits=act_bits)  # xq (E, C, K), scale (E, C, 1)
    e, c, _ = x.shape
    out = torch.empty((e, c, packed.shape[-1]), dtype=torch.float32, device=x.device)
    for e0 in range(0, e, PLAIN_EXPERT_CHUNK):
        e1 = min(e0 + PLAIN_EXPERT_CHUNK, e)
        trits = packing.unpack(packed[e0:e1].transpose(0, 1), codec, k).transpose(0, 1)
        acc = torch.bmm(q.xq[e0:e1].to(torch.float64), trits.to(torch.float64))
        out[e0:e1] = acc.to(torch.int32).to(torch.float32) * (
            col_scale[e0:e1, None, :].float() / q.scale[e0:e1])
    return out


def _check(x, packed, col_scale, k, codec, scale_shape, name):
    kg = packed.shape[-2]
    if not (x.is_cuda and packed.is_cuda and col_scale.is_cuda):
        raise ValueError(f"{name}: all operands must be CUDA tensors")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x must be f32 or bf16, got {x.dtype}")
    if packed.dtype != torch.uint8 or col_scale.dtype != torch.float32:
        raise TypeError(f"{name}: packed must be uint8, col_scale f32")
    if kg * packing.group_of(codec) < k or x.shape[-1] != k:
        raise ValueError(f"{name}: x K {x.shape[-1]} vs packed {tuple(packed.shape)} "
                         f"for k={k}, {codec}")
    if tuple(col_scale.shape) != scale_shape:
        raise ValueError(f"{name}: col_scale {tuple(col_scale.shape)} != {scale_shape}")
    if kg > MAX_GROUPS[codec]:
        raise ValueError(f"{name}: K/g = {kg} exceeds {MAX_GROUPS[codec]}")


def _launch(x2: torch.Tensor, packed: torch.Tensor, col_scale: torch.Tensor,
            k: int, codec: str, act_bits: int) -> torch.Tensor:
    m, n = x2.shape[0], packed.shape[1]
    kg = packed.shape[0]
    _check(x2, packed, col_scale, k, codec, (n,), "ternary_matmul_actq")
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


def _launch_expert(x: torch.Tensor, packed: torch.Tensor, col_scale: torch.Tensor,
                   k: int, codec: str, act_bits: int) -> torch.Tensor:
    e, c, _ = x.shape
    kg, n = packed.shape[1], packed.shape[2]
    if packed.shape[0] != e:
        raise ValueError(f"ternary_matmul_expert: {packed.shape[0]} packed experts, x has {e}")
    _check(x, packed, col_scale, k, codec, (e, n), "ternary_matmul_expert")
    x, packed, col_scale = x.contiguous(), packed.contiguous(), col_scale.contiguous()
    out = torch.empty((e, c, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    EXPERT_KERNEL.launch(
        ptr(x), int(x.dtype == torch.bfloat16), ptr(packed), ptr(col_scale), ptr(out),
        e, c, k, kg, n, packing.group_of(codec), act_bits, stream_of(x),
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


def ternary_matmul_expert(x: torch.Tensor, packed: torch.Tensor, col_scale: torch.Tensor,
                          *, k: int, codec: str = "pack2", act_bits: int = 8,
                          impl: str = "auto") -> torch.Tensor:
    """RAW float (E, C, K) x packed (E, ceil(K/g), N), per-expert per-column
    ``col_scale`` (E, N) -> float32 (E, C, N), one launch for all experts.

    ``impl`` as in ``ternary_matmul_actq``."""
    act_qrange(act_bits)
    if impl == "plain" or (impl == "auto" and not x.is_cuda):
        return ternary_matmul_expert_plain(x, packed, col_scale, k, codec, act_bits)
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}")
    return _launch_expert(x, packed, col_scale, k, codec, act_bits)
