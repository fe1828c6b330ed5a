"""Quantized LoRA adapters (reference: ``repro/core/lora.py``).

The adapter delta ``(x_q @ A_q) @ B_q * (alpha / r)`` with 6-bit
per-output-column weights and A8 activations, in plain PyTorch (the
reference computes it in XLA too; no kernel carries it). The fake-quant
expressions keep the reference's straight-through form so the forward
values match it operation for operation.
"""

from __future__ import annotations

import torch

from repro_torch.core.ternary import act_quant_ste

DEFAULT_RANK = 16
DEFAULT_LORA_BITS = 6
DEFAULT_ACT_BITS = 8


def init(d_in: int, d_out: int, rank: int = DEFAULT_RANK, *,
         generator: torch.Generator, device, dtype=torch.float32) -> dict:
    """LoRA factors: A ~ N(0, 1/r) (d_in, r); B = 0 (r, d_out)."""
    a = torch.randn((d_in, rank), generator=generator, device=device,
                    dtype=dtype) * (1.0 / rank) ** 0.5
    b = torch.zeros((rank, d_out), device=device, dtype=dtype)
    return {"a": a, "b": b}


def _quant_sym_ste(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-output-column symmetric fake quantization (forward value)."""
    qmax = 2.0 ** (bits - 1) - 1.0
    w32 = w.float()
    absmax = w32.abs().amax(dim=0, keepdim=True)
    scale = torch.full_like(absmax, qmax) / torch.clamp(absmax, min=1e-8)
    wq = torch.clamp(torch.round(w32 * scale), -qmax - 1.0, qmax) / scale
    return (w32 + (wq - w32)).to(w.dtype)


def apply(params: dict, x: torch.Tensor, alpha: float = 2.0 * DEFAULT_RANK,
          weight_bits: int = DEFAULT_LORA_BITS,
          act_bits: int = DEFAULT_ACT_BITS) -> torch.Tensor:
    """Quantized LoRA delta: (x_q @ A_q) @ B_q * (alpha / r)."""
    rank = params["a"].shape[-1]
    aq = _quant_sym_ste(params["a"], weight_bits)
    bq = _quant_sym_ste(params["b"], weight_bits)
    xq = act_quant_ste(x, bits=act_bits)
    return ((xq @ aq) @ bq) * (alpha / rank)
