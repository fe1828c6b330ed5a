"""RMSNorm ``x / sqrt(mean(x^2) + eps) * w`` in a sum order fixed per row
(CUDA kernel ``csrc/rms_norm.cu``).

Not a TPU kernel: the reference normalises in XLA
(``repro/models/layers.py::rms_norm``). On the card PyTorch's reduction
picks its thread layout, and so each row's sum order, by the number of
rows, so the same token could be normalised in another order in a decode
step, a chunk wave and a grouped prefill. Here a row's value depends on
that row alone:

- lane ``L`` of 32 sums ``x[k]^2`` for ``k = L, L + 32, ...`` in order from
  +0.0 (nothing past D), then a halving tree over the 32 lanes;
- ``inv = 1 / sqrt(s / D + eps)``, each step correctly rounded;
- ``y = (x * inv) * w``.

All in f32; the output takes the input's type. ``rms_norm_plain`` repeats
the order with tensor ops; every step is correctly rounded (the square
root taken in f64 and rounded to f32, which is the correctly rounded f32
root), so kernel and plain version agree bit for bit, and the plain
version gives the same bits on the CPU and the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import CudaKernel, ptr, stream_of

KERNEL = CudaKernel(
    "rms_norm", "rms_norm",
    [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    + [ctypes.c_float, ctypes.c_void_p],
)
LANES = 32


def rms_norm_plain(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain version, in the kernel's order: x (..., D), w (D,)."""
    d = x.shape[-1]
    x32 = x.reshape(-1, d).float()
    m = x32.shape[0]
    steps = -(-d // LANES)
    sq = F.pad(x32 * x32, (0, steps * LANES - d)).reshape(m, steps, LANES)
    lanes = x32.new_zeros((m, LANES))
    for j in range(steps):
        lanes = lanes + sq[:, j]
    while lanes.shape[1] > 1:  # halving tree over the lanes: i + n/2 onto i
        h = lanes.shape[1] // 2
        lanes = lanes[:, :h] + lanes[:, h:]
    s = lanes[:, 0]
    var = s / torch.full_like(s, float(d))  # tensor / tensor: a true division
    # the f32 root correctly rounded: taken in f64 and rounded once more
    # (torch's f32 sqrt on the CPU is not correctly rounded)
    inv = torch.ones_like(var) / torch.sqrt((var + eps).double()).float()
    return ((x32 * inv[:, None]) * w.float()).to(x.dtype).reshape(x.shape)


def _launch(x, w, eps):
    d = x.shape[-1]
    if not (x.is_cuda and w.is_cuda):
        raise ValueError("rms_norm: x and w must be CUDA tensors")
    types = (torch.float32, torch.bfloat16)
    if x.dtype not in types or w.dtype not in types:
        raise TypeError("rms_norm: x and w must be f32 or bf16")
    if w.shape != (d,):
        raise ValueError(f"rms_norm: w {tuple(w.shape)} != {(d,)}")
    x2 = x.reshape(-1, d).contiguous()
    w = w.contiguous()
    out = torch.empty_like(x2)
    if out.numel():
        KERNEL.launch(int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16), ptr(x2),
                      ptr(w), ptr(out), x2.shape[0], d, float(eps), stream_of(x2))
    return out.reshape(x.shape)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
             impl: str = "auto") -> torch.Tensor:
    """RMSNorm over the last dim in the fixed per-row order. ``impl="auto"``
    launches the CUDA kernel for CUDA tensors and runs the plain version for
    CPU tensors; ``impl="plain"`` runs the plain version."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "plain" or not x.is_cuda:
        return rms_norm_plain(x, w, eps)
    return _launch(x, w, eps)
