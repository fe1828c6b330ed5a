"""Oracles for the ternary kernels (reference: ``repro/kernels/ref.py``):
the ground truth the kernels and their plain versions are held against.

They decode the packed trits and apply the TriMLA add / subtract / skip
semantics (``core.ternary.ternary_mac_reference``), an arithmetic
independent of the kernels' ``x @ trits`` product.
"""

from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.core.ternary import act_quant, ternary_mac_reference, weight_quant_absmean


def ternary_matmul_ref(xq: torch.Tensor, packed: torch.Tensor, k: int,
                       codec: str) -> torch.Tensor:
    """int8 activations (..., K) x packed trits (K/g, N) -> int32 (..., N)."""
    return ternary_mac_reference(xq, packing.unpack(packed, codec, k))


def ternary_matmul_dense_ref(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The same from unpacked trits (K, N)."""
    return ternary_mac_reference(xq, wq)


def bitlinear_ref(x: torch.Tensor, w: torch.Tensor, act_bits: int = 8) -> torch.Tensor:
    """Float in, float out: the packed BitLinear forward from a float weight."""
    q = weight_quant_absmean(w)
    a = act_quant(x, bits=act_bits)
    acc = ternary_mac_reference(a.xq, q.wq).to(torch.float32)
    return acc * (q.scale / a.scale)
