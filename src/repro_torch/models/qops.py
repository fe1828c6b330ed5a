"""Quantized linear primitives (reference: ``repro/models/qops.py``).

Two modes are ported: packed leaves (``PackedLinear`` /
``FusedPackedLinear``, the ternary fast path of
``core/bitlinear.packed_matmul``) and float ``{"w": (K, N)}`` leaves
(plain matmul, used for the unpacked lm_head). ``fused_linear`` serves a
same-input projection group with one act-quant and one kernel launch,
then applies each segment's LoRA adapter after the split. The reference's
QAT mode is not part of this slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core import bitlinear
from repro_torch.core import lora as lora_lib
from repro_torch.core.bitlinear import PACKED_TYPES


def _flatten_x(x: torch.Tensor, k: int):
    """Collapse trailing dims of x whose product is k into the last axis."""
    shape = tuple(x.shape)
    cut, prod = len(shape), 1
    while prod < k:
        cut -= 1
        prod *= shape[cut]
    if prod != k:
        raise ValueError(f"cannot flatten {shape} to a trailing {k}")
    return x.reshape(shape[:cut] + (k,)), shape[:cut]


def _apply_lora(y: torch.Tensor, x: torch.Tensor, lora_leaf: dict,
                cfg: ModelConfig) -> torch.Tensor:
    """Add the quantized-LoRA delta (alpha = 2r, lora_bits weights, A8)."""
    x2l, _ = _flatten_x(x, lora_leaf["a"].shape[0])
    return y + lora_lib.apply(
        lora_leaf, x2l, alpha=2.0 * cfg.bitnet.lora_rank,
        weight_bits=cfg.bitnet.lora_bits, act_bits=8,
    ).to(y.dtype)


def linear(leaf, x: torch.Tensor, cfg: ModelConfig,
           lora_leaf: Optional[dict] = None) -> torch.Tensor:
    """y = x @ W for a packed leaf (ternary fast path) or a float leaf."""
    if isinstance(leaf, PACKED_TYPES):
        x2, lead = _flatten_x(x, leaf.k)
        y = bitlinear.packed_matmul(leaf, x2, act_bits=cfg.bitnet.act_bits,
                                    impl=cfg.bitnet.impl).to(x.dtype)
        n = leaf.packed.shape[-1]
    else:
        w = leaf["w"]
        x2, lead = _flatten_x(x, w.shape[0])
        y = (x2 @ w).to(x.dtype)
        n = w.shape[-1]
    if lora_leaf is not None and cfg.bitnet.lora_rank > 0:
        y = _apply_lora(y, x, lora_leaf, cfg)
    return y.reshape(lead + (n,))


def fused_linear(leaf, x: torch.Tensor, cfg: ModelConfig,
                 out_shapes: Optional[tuple] = None,
                 lora_leaves: Optional[dict] = None) -> tuple:
    """Fused projection group: ONE act-quant + ONE packed matmul, split out.
    ``lora_leaves``: {segment index: lora leaf}."""
    x2, lead = _flatten_x(x, leaf.k)
    y = bitlinear.packed_matmul(leaf, x2, act_bits=cfg.bitnet.act_bits,
                                impl=cfg.bitnet.impl).to(x.dtype)
    parts = []
    off = 0
    for i, w in enumerate(leaf.splits):
        seg = y[..., off:off + w]
        off += w
        lora_leaf = (lora_leaves or {}).get(i)
        if lora_leaf is not None and cfg.bitnet.lora_rank > 0:
            seg = _apply_lora(seg, x, lora_leaf, cfg)
        shape = out_shapes[i] if out_shapes and out_shapes[i] else (w,)
        parts.append(seg.reshape(lead + tuple(shape)))
    return tuple(parts)


def init_linear(d_in: int, d_out: int, *, generator, device, dtype=torch.float32,
                scale: float | None = None) -> dict:
    s = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=generator, device=device, dtype=dtype) * s
    return {"w": w}
