"""Packed-ternary matmuls (reference: ``repro/kernels/ternary_matmul.py``
through ``repro/kernels/ops.py``), all on one CUDA source,
``csrc/ternary_matmul.cu``, with a plain PyTorch version beside each
wrapper, bit-identical to the kernel and to the reference.

- ``ternary_matmul_actq`` (``ops.ternary_matmul_actq``): RAW float x
  (M, K) and packed trits (ceil(K/g), N) in; per-row absmax -> ``scale =
  qmax / max(absmax, EPS)`` -> int8 codes -> int8 x trit int32 accumulate
  -> ``acc_f32 * (col_scale[n] / scale[m])`` out, float32 (M, N).
- ``ternary_matmul_fused`` (``ops.ternary_matmul_fused``, the known-scale
  kernel): int8 codes and their per-row scale from the caller (the
  carried-scale path, ``fuse_act_quant=False``) -> the same accumulate
  and epilogue.
- ``ternary_matmul`` (``ops.ternary_matmul``): int8 codes -> the exact
  int32 accumulator, no scales.
- ``ternary_matmul_abft`` (``ops.ternary_matmul_abft``): the known-scale
  kernel plus the ABFT row-sum check in plain PyTorch around it, against
  the pack-time checksum ``abft_wsum`` (reference:
  ``ternary_matmul.abft_wsum``, plain JAX there too).
- ``ternary_matmul_expert`` / ``ternary_matmul_expert_fused``
  (``ops.ternary_matmul_expert`` / ``_expert_fused``): the act-quant and
  the known-scale forms over a leading expert dimension — x (E, C, K),
  packed (E, K/g, N), per-column scales (E, N) — in ONE launch (expert
  index on the grid's z axis). Their plain versions walk the experts in
  chunks: unpacking all 256 DeepSeek-V3 experts to float at once would
  take 30 GB or more.

Each entry point has its own launch count. The reference pads M/N/K to
its TPU block table (padded rows with ``x_scale`` 1, padded columns with
scale 0); here nothing is padded: the kernel masks the ragged M and N
edges itself and reads activation columns at or past the true K as zero,
so a pack243 weight (K padded to a multiple of 5 inside the packed bytes)
needs no repair bytes.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import packing
from repro_torch.core.ternary import act_qrange, act_quant
from repro_torch.kernels.build import CudaKernel, ptr, stream_of

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("ternary_matmul", "ternary_matmul_actq",
                    [_P, _I, _P, _P, _P] + [_I] * 6 + [_P])
EXPERT_KERNEL = CudaKernel("ternary_matmul", "ternary_matmul_actq_expert",
                           [_P, _I, _P, _P, _P] + [_I] * 7 + [_P])
KNOWN_KERNEL = CudaKernel("ternary_matmul", "ternary_matmul_known",
                          [_P] * 5 + [_I] * 5 + [_P])
KNOWN_EXPERT_KERNEL = CudaKernel("ternary_matmul", "ternary_matmul_known_expert",
                                 [_P] * 5 + [_I] * 6 + [_P])
INT32_KERNEL = CudaKernel("ternary_matmul", "ternary_matmul_int32", [_P] * 3 + [_I] * 5 + [_P])
# experts unpacked at once by the plain expert versions (float32 trits of
# 16 DeepSeek-V3 w_gu experts: 16 x 7168 x 4096 x 4 B = 1.9 GB)
PLAIN_EXPERT_CHUNK = 16
FLOATS = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def exact_float(k: int) -> torch.dtype:
    """The narrowest float type whose product of int8 codes and trits over
    K terms is exact in any summation order: every partial sum is an
    integer of magnitude at most 128 K, so float32 (integers up to 2**24)
    holds it up to K = 2**17, float64 (2**53) beyond."""
    return torch.float32 if 128 * k <= 2 ** 24 else torch.float64


def ternary_acc_plain(xq: torch.Tensor, packed: torch.Tensor, k: int,
                      codec: str) -> torch.Tensor:
    """int8 (M, K) x packed (K/g, N) -> exact int32 accumulator (M, N):
    on the CPU an int8 GEMM with an int32 accumulator (``torch._int_mm``),
    on the card (where that GEMM needs M > 16) a float product in
    ``exact_float(k)``. Integer ``matmul`` has no CUDA implementation."""
    trits = packing.unpack(packed, codec, k)
    if not xq.is_cuda:
        return torch._int_mm(xq.to(torch.int8).contiguous(), trits)
    ft = exact_float(k)
    return (xq.to(ft) @ trits.to(ft)).to(torch.int32)


def ternary_matmul_fused_plain(xq: torch.Tensor, packed: torch.Tensor, x_scale: torch.Tensor,
                               col_scale: torch.Tensor, k: int,
                               codec: str = "pack2") -> torch.Tensor:
    """Plain known-scale version: exact accumulate, then ``acc_f32 *
    (col_scale / x_scale)`` — the quotient first, the reference's order."""
    acc = ternary_acc_plain(xq, packed, k, codec)
    return acc.to(torch.float32) * (col_scale.float() / x_scale.float())


def ternary_matmul_actq_plain(x: torch.Tensor, packed: torch.Tensor,
                              col_scale: torch.Tensor, k: int,
                              codec: str = "pack2", act_bits: int = 8) -> torch.Tensor:
    """Plain act-quant version: act_quant, then the known-scale version."""
    q = act_quant(x, bits=act_bits)
    return ternary_matmul_fused_plain(q.xq, packed, q.scale, col_scale, k, codec)


def ternary_matmul_expert_fused_plain(xq: torch.Tensor, packed: torch.Tensor,
                                      x_scale: torch.Tensor, col_scale: torch.Tensor, k: int,
                                      codec: str = "pack2") -> torch.Tensor:
    """Plain known-scale expert version: for each chunk of experts an exact
    batched accumulate (``exact_float``) and the rescale."""
    e, c, _ = xq.shape
    ft = exact_float(k)
    out = torch.empty((e, c, packed.shape[-1]), dtype=torch.float32, device=xq.device)
    for e0 in range(0, e, PLAIN_EXPERT_CHUNK):
        e1 = min(e0 + PLAIN_EXPERT_CHUNK, e)
        trits = packing.unpack(packed[e0:e1].transpose(0, 1), codec, k).transpose(0, 1)
        acc = torch.bmm(xq[e0:e1].to(ft), trits.to(ft))
        out[e0:e1] = acc.to(torch.int32).to(torch.float32) * (
            col_scale[e0:e1, None, :].float() / x_scale[e0:e1].float())
    return out


def ternary_matmul_expert_plain(x: torch.Tensor, packed: torch.Tensor,
                                col_scale: torch.Tensor, k: int, codec: str = "pack2",
                                act_bits: int = 8) -> torch.Tensor:
    """Plain act-quant expert version: per-row act_quant, then the
    known-scale expert version."""
    q = act_quant(x, bits=act_bits)  # xq (E, C, K), scale (E, C, 1)
    return ternary_matmul_expert_fused_plain(q.xq, packed, q.scale, col_scale, k, codec)


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------


def _check(name, x, packed, k, codec, x_dtypes, col_scale=None, col_shape=None,
           x_scale=None, x_scale_shape=None):
    kg = packed.shape[-2]
    operands = [t for t in (x, packed, col_scale, x_scale) if t is not None]
    if not all(t.is_cuda for t in operands):
        raise ValueError(f"{name}: all operands must be CUDA tensors")
    if x.dtype not in x_dtypes:
        raise TypeError(f"{name}: x must be one of {x_dtypes}, got {x.dtype}")
    if packed.dtype != torch.uint8:
        raise TypeError(f"{name}: packed must be uint8, got {packed.dtype}")
    if kg * packing.group_of(codec) < k or x.shape[-1] != k:
        raise ValueError(f"{name}: x K {x.shape[-1]} vs packed {tuple(packed.shape)} "
                         f"for k={k}, {codec}")
    for what, t, shape in (("col_scale", col_scale, col_shape),
                           ("x_scale", x_scale, x_scale_shape)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be f32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} {tuple(t.shape)} != {shape}")


def _launch_actq(x2, packed, col_scale, k, codec, act_bits):
    m, (kg, n) = x2.shape[0], packed.shape
    _check("ternary_matmul_actq", x2, packed, k, codec, FLOATS, col_scale, (n,))
    x2, packed, col_scale = x2.contiguous(), packed.contiguous(), col_scale.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    if out.numel():
        KERNEL.launch(ptr(x2), int(x2.dtype == torch.bfloat16), ptr(packed), ptr(col_scale),
                      ptr(out), m, k, kg, n, packing.group_of(codec), act_bits, stream_of(x2))
    return out


def _launch_actq_expert(x, packed, col_scale, k, codec, act_bits):
    (e, c, _), (ep, kg, n) = x.shape, packed.shape
    if ep != e:
        raise ValueError(f"ternary_matmul_expert: {ep} packed experts, x has {e}")
    _check("ternary_matmul_expert", x, packed, k, codec, FLOATS, col_scale, (e, n))
    x, packed, col_scale = x.contiguous(), packed.contiguous(), col_scale.contiguous()
    out = torch.empty((e, c, n), dtype=torch.float32, device=x.device)
    if out.numel():
        EXPERT_KERNEL.launch(ptr(x), int(x.dtype == torch.bfloat16), ptr(packed),
                             ptr(col_scale), ptr(out), e, c, k, kg, n, packing.group_of(codec),
                             act_bits, stream_of(x))
    return out


def _launch_known(xq2, packed, x_scale, col_scale, k, codec):
    m, (kg, n) = xq2.shape[0], packed.shape
    _check("ternary_matmul_fused", xq2, packed, k, codec, (torch.int8,), col_scale, (n,),
           x_scale, (m, 1))
    xq2, packed = xq2.contiguous(), packed.contiguous()
    x_scale, col_scale = x_scale.contiguous(), col_scale.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=xq2.device)
    if out.numel():
        KNOWN_KERNEL.launch(ptr(xq2), ptr(x_scale), ptr(packed), ptr(col_scale), ptr(out),
                            m, k, kg, n, packing.group_of(codec), stream_of(xq2))
    return out


def _launch_known_expert(xq, packed, x_scale, col_scale, k, codec):
    (e, c, _), (ep, kg, n) = xq.shape, packed.shape
    if ep != e:
        raise ValueError(f"ternary_matmul_expert_fused: {ep} packed experts, x has {e}")
    _check("ternary_matmul_expert_fused", xq, packed, k, codec, (torch.int8,), col_scale,
           (e, n), x_scale, (e, c, 1))
    xq, packed = xq.contiguous(), packed.contiguous()
    x_scale, col_scale = x_scale.contiguous(), col_scale.contiguous()
    out = torch.empty((e, c, n), dtype=torch.float32, device=xq.device)
    if out.numel():
        KNOWN_EXPERT_KERNEL.launch(ptr(xq), ptr(x_scale), ptr(packed), ptr(col_scale), ptr(out),
                                   e, c, k, kg, n, packing.group_of(codec), stream_of(xq))
    return out


def _launch_int32(xq2, packed, k, codec):
    m, (kg, n) = xq2.shape[0], packed.shape
    _check("ternary_matmul", xq2, packed, k, codec, (torch.int8,))
    xq2, packed = xq2.contiguous(), packed.contiguous()
    out = torch.empty((m, n), dtype=torch.int32, device=xq2.device)
    if out.numel():
        INT32_KERNEL.launch(ptr(xq2), ptr(packed), ptr(out), m, k, kg, n,
                            packing.group_of(codec), stream_of(xq2))
    return out


def _plain(impl: str, x: torch.Tensor) -> bool:
    """True for the plain version: ``impl="plain"``, or ``"auto"`` on a
    CPU tensor. ``"auto"`` on a CUDA tensor launches the kernel."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    return impl == "plain" or not x.is_cuda


# ---------------------------------------------------------------------------
# entry points: ``impl="auto"`` launches the CUDA kernel for CUDA tensors
# and runs the plain version for CPU tensors; ``impl="plain"`` runs the
# plain version.
# ---------------------------------------------------------------------------


def ternary_matmul_actq(x: torch.Tensor, packed: torch.Tensor,
                        col_scale: torch.Tensor, *, k: int, codec: str = "pack2",
                        act_bits: int = 8, impl: str = "auto") -> torch.Tensor:
    """RAW float (..., K) x packed (ceil(K/g), N) -> float32 (..., N)."""
    act_qrange(act_bits)  # reject unsupported widths on every path
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _plain(impl, x):
        out = ternary_matmul_actq_plain(x2, packed, col_scale, k, codec, act_bits)
    else:
        out = _launch_actq(x2, packed, col_scale, k, codec, act_bits)
    return out.reshape(lead + (packed.shape[1],))


def ternary_matmul_fused(xq: torch.Tensor, packed: torch.Tensor, x_scale: torch.Tensor,
                         col_scale: torch.Tensor, *, k: int, codec: str = "pack2",
                         impl: str = "auto") -> torch.Tensor:
    """Known scale: int8 (..., K) codes with their per-row scale ``x_scale``
    (..., 1) f32 (act_quant's convention: dequant = xq / scale) and the
    per-column ``col_scale`` (N,) -> float32 (..., N) = ``acc * (col_scale
    / x_scale)``."""
    lead = xq.shape[:-1]
    xq2 = xq.reshape(-1, xq.shape[-1])
    xs2 = x_scale.reshape(-1, 1)
    if _plain(impl, xq):
        out = ternary_matmul_fused_plain(xq2, packed, xs2, col_scale, k, codec)
    else:
        out = _launch_known(xq2, packed, xs2, col_scale, k, codec)
    return out.reshape(lead + (packed.shape[1],))


def ternary_matmul(xq: torch.Tensor, packed: torch.Tensor, *, k: int, codec: str = "pack2",
                   impl: str = "auto") -> torch.Tensor:
    """int8 (..., K) x packed (ceil(K/g), N) -> the exact int32 (..., N)."""
    lead = xq.shape[:-1]
    xq2 = xq.reshape(-1, xq.shape[-1])
    if _plain(impl, xq):
        out = ternary_acc_plain(xq2, packed, k, codec)
    else:
        out = _launch_int32(xq2, packed, k, codec)
    return out.reshape(lead + (packed.shape[1],))


def ternary_matmul_expert(x: torch.Tensor, packed: torch.Tensor, col_scale: torch.Tensor,
                          *, k: int, codec: str = "pack2", act_bits: int = 8,
                          impl: str = "auto") -> torch.Tensor:
    """RAW float (E, C, K) x packed (E, ceil(K/g), N), per-expert per-column
    ``col_scale`` (E, N) -> float32 (E, C, N), one launch for all experts."""
    act_qrange(act_bits)
    if _plain(impl, x):
        return ternary_matmul_expert_plain(x, packed, col_scale, k, codec, act_bits)
    return _launch_actq_expert(x, packed, col_scale, k, codec, act_bits)


def ternary_matmul_expert_fused(xq: torch.Tensor, packed: torch.Tensor, x_scale: torch.Tensor,
                                col_scale: torch.Tensor, *, k: int, codec: str = "pack2",
                                impl: str = "auto") -> torch.Tensor:
    """Known-scale expert form: int8 (E, C, K) codes with ``x_scale``
    (E, C, 1), packed (E, ceil(K/g), N), ``col_scale`` (E, N) -> float32
    (E, C, N), one launch for all experts."""
    if _plain(impl, xq):
        return ternary_matmul_expert_fused_plain(xq, packed, x_scale, col_scale, k, codec)
    return _launch_known_expert(xq, packed, x_scale, col_scale, k, codec)


# ---------------------------------------------------------------------------
# ABFT weight checksums (the SDC scrub's probe)
# ---------------------------------------------------------------------------


def abft_wsum(packed: torch.Tensor, k: int, codec: str, scale: torch.Tensor) -> torch.Tensor:
    """The scale-weighted ABFT checksum of a packed (K/g, N) weight with
    scale ``s`` (scalar or per column): ``wsum[k] = sum_n trit[k, n] *
    s[n]``, f32 (K,). Since ``y = (xq @ trits) * s / x_scale``, the row
    sum of ``y`` is ``(xq @ wsum) / x_scale``: one GEMV checks a matmul.
    A leading expert dimension passes through. Plain PyTorch on the
    leaf's device, as in the reference; its sum order is PyTorch's, so it
    agrees with the reference's to f32 rounding, not bit for bit."""
    if packed.ndim == 3:
        return torch.stack([abft_wsum(p, k, codec, s) for p, s in zip(packed, scale)])
    trits = packing.unpack(packed, codec, k).float()
    s = scale.float()
    if s.ndim == 0:
        return trits.sum(dim=-1) * s
    return trits @ s


def ternary_matmul_abft(xq: torch.Tensor, packed: torch.Tensor, x_scale: torch.Tensor,
                        col_scale: torch.Tensor, wsum: torch.Tensor, *, k: int,
                        codec: str = "pack2", impl: str = "auto", atol: float = 1e-4,
                        eps_factor: float = 64.0):
    """Kernel 4 plus the ABFT row-sum check (reference:
    ``ops.ternary_matmul_abft``): ``y = ternary_matmul_fused(...)`` (the
    kernel on CUDA tensors, its plain version on CPU ones), the predicted
    row sums ``(xq @ wsum) / x_scale``, ``residual = |sum_n y - pred|``
    and ``tol = atol + eps_factor * eps_f32 * mag``, ``mag`` the
    positive-term magnitude of both sums. Returns ``(y, residual, tol)``.
    A flipped trit at k moves the row sum by ``|xq[r, k]| * s``: outside
    ``tol`` wherever the row's code at k is nonzero (rows whose codes are
    zero there are the blind spot the exact crc covers)."""
    y = ternary_matmul_fused(xq, packed, x_scale, col_scale, k=k, codec=codec, impl=impl)
    xqf = xq.float()
    xs = x_scale[..., 0].float()
    w = wsum.float()
    pred = (xqf @ w) / xs
    residual = (y.sum(dim=-1) - pred).abs()
    mag = (xqf.abs() @ w.abs()) / xs.abs() + y.abs().sum(dim=-1)
    tol = atol + eps_factor * torch.finfo(torch.float32).eps * mag
    return y, residual, tol
