"""The quantized LoRA delta ``((xq @ aq) @ bq) * scale`` in a sum order
fixed per output row (CUDA kernel ``csrc/lora.cu``).

Not a TPU kernel: the reference leaves the product to XLA
(``repro/core/lora.py::apply``). On the card a GEMM library picks its
algorithm, and so each row's sum order, by the number of rows, so the
same token's delta differed between grouped admission, chunk waves and
decode. Here a row's value depends on that row alone:

- ``t[r] = sum_k xq[k] aq[k, r]``: lane ``L`` of 32 sums the products of
  ``k = L, L + 32, ...`` in order from +0.0 (zero past K), then a halving
  tree over the 32 lanes;
- ``out[n] = (sum_r t[r] bq[r, n]) * scale``, in order of r from +0.0.

Every product and sum is rounded on its own, in f32 whatever the input
type; the output takes the input type. ``lora_delta_plain`` repeats the
order with tensor ops, so kernel and plain version agree bit for bit,
and so do the plain version's rows at any M.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import CudaKernel, ptr, stream_of

KERNEL = CudaKernel(
    "lora", "lora_delta",
    [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_void_p],
)
LANES = 32
MAX_RANK = 32


def lora_delta_plain(xq: torch.Tensor, aq: torch.Tensor, bq: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Plain version, in the kernel's order: xq (M, K), aq (K, R), bq (R,
    N) -> (M, N) in the dtype of xq."""
    m, k = xq.shape
    r, n = bq.shape
    x32, a32, b32 = xq.float(), aq.float(), bq.float()
    steps = -(-k // LANES)
    pad = steps * LANES - k
    if pad:  # products past K are +0.0 (0 * 0), as the kernel adds them
        x32, a32 = F.pad(x32, (0, pad)), F.pad(a32, (0, 0, 0, pad))
    xs, as_ = x32.reshape(m, steps, LANES), a32.reshape(steps, LANES, r)
    lanes = x32.new_zeros((m, LANES, r))
    for j in range(steps):
        lanes = lanes + xs[:, j, :, None] * as_[j][None]
    while lanes.shape[1] > 1:  # halving tree over the lanes: i + n/2 onto i
        h = lanes.shape[1] // 2
        lanes = lanes[:, :h] + lanes[:, h:]
    t = lanes[:, 0]  # (M, R)
    o = x32.new_zeros((m, n))
    for i in range(r):
        o = o + t[:, i, None] * b32[i][None]
    return (o * scale).to(xq.dtype)


def _launch(xq, aq, bq, scale):
    m, k = xq.shape
    r, n = bq.shape
    if not (xq.is_cuda and aq.is_cuda and bq.is_cuda):
        raise ValueError("lora_delta: all operands must be CUDA tensors")
    if xq.dtype not in (torch.float32, torch.bfloat16) or aq.dtype != xq.dtype or (
            bq.dtype != xq.dtype):
        raise TypeError("lora_delta: xq, aq and bq must share one dtype, f32 or bf16")
    if aq.shape != (k, r) or not 1 <= r <= MAX_RANK:
        raise ValueError(f"lora_delta: xq {tuple(xq.shape)}, aq {tuple(aq.shape)}, bq "
                         f"{tuple(bq.shape)} unsupported (rank 1..{MAX_RANK})")
    xq, aq, bq = xq.contiguous(), aq.contiguous(), bq.contiguous()
    out = torch.empty((m, n), dtype=xq.dtype, device=xq.device)
    if out.numel():
        KERNEL.launch(int(xq.dtype == torch.bfloat16), ptr(xq), ptr(aq), ptr(bq), ptr(out),
                      m, k, n, r, float(scale), stream_of(xq))
    return out


def lora_delta(xq: torch.Tensor, aq: torch.Tensor, bq: torch.Tensor, scale: float,
               impl: str = "auto") -> torch.Tensor:
    """``((xq @ aq) @ bq) * scale`` in the fixed per-row order: xq (..., K)
    -> (..., N). ``impl="auto"`` launches the CUDA kernel for CUDA tensors
    and runs the plain version for CPU tensors; ``impl="plain"`` runs the
    plain version."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    lead = xq.shape[:-1]
    x2 = xq.reshape(-1, xq.shape[-1])
    if impl == "plain" or not xq.is_cuda:
        out = lora_delta_plain(x2, aq, bq, scale)
    else:
        out = _launch(x2, aq, bq, scale)
    return out.reshape(lead + (bq.shape[1],))
