"""BitNet b1.58 ternary quantization (reference: ``repro/core/ternary.py``).

Weights: ``scale = mean(|W|)``, ``W_q = clip(round(W / scale), -1, 1)``;
``weight_quant_ste`` is the dequantized ``W_q * scale`` that float-kept
factors (MLA's ``w_uk`` / ``w_uv``) use.
Activations: per-token absmax to int8 (A8, [-128, 127]) or int4 (A4,
[-8, 7]) with ``scale = qmax / max(absmax, EPS)``; dequant divides by it.

``torch.round`` rounds half to even like ``jnp.round``, so on identical
f32 inputs the codes and scales here are bit-identical to the reference.
Scalar-over-tensor divisions are written tensor/tensor on purpose:
``float / tensor`` in PyTorch multiplies by the reciprocal, which is not
the IEEE quotient the reference computes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

EPS = 1e-5


class QuantizedWeight(NamedTuple):
    wq: torch.Tensor  # int8 trits, same shape as the source weight
    scale: torch.Tensor  # f32 scalar absmean


class QuantizedActivation(NamedTuple):
    xq: torch.Tensor  # int8
    scale: torch.Tensor  # f32, shape x.shape[:-1] + (1,); dequant: xq / scale


def act_qrange(bits: int):
    if bits == 8:
        return 127.0, -128.0
    if bits == 4:
        return 7.0, -8.0
    raise ValueError(f"unsupported activation bits: {bits}")


def weight_quant_absmean(w: torch.Tensor) -> QuantizedWeight:
    w32 = w.float()
    scale = torch.clamp(w32.abs().mean(), min=EPS)
    wq = torch.clamp(torch.round(w32 / scale), -1.0, 1.0)
    return QuantizedWeight(wq.to(torch.int8), scale)


def weight_quant_ste(w: torch.Tensor) -> torch.Tensor:
    """Fake-quantized weight: the forward value of the reference's
    straight-through form ``w + stop_gradient(wq * scale - w)`` (serving
    needs no gradient)."""
    q = weight_quant_absmean(w)
    w32 = w.float()
    return (w32 + (q.wq.float() * q.scale - w32)).to(w.dtype)


def act_quant(x: torch.Tensor, bits: int = 8) -> QuantizedActivation:
    """Per-token absmax symmetric quantization to ``bits`` (8 or 4)."""
    qmax, qmin = act_qrange(bits)
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.full_like(absmax, qmax) / torch.clamp(absmax, min=EPS)
    xq = torch.clamp(torch.round(x32 * scale), qmin, qmax)
    return QuantizedActivation(xq.to(torch.int8), scale)


def act_dequant(q: QuantizedActivation) -> torch.Tensor:
    return q.xq.float() / q.scale


def act_quant_ste(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Fake-quantized activation; the forward value of the reference's
    straight-through form ``x + stop_gradient(dequant - x)``."""
    x32 = x.float()
    xdq = act_dequant(act_quant(x, bits=bits))
    return (x32 + (xdq - x32)).to(x.dtype)
