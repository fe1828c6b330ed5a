"""Packed ternary projections (reference: ``repro/core/bitlinear.py``).

Inference-form weights are packed trits (uint8, 2.0 or 1.6 bits/weight)
plus their absmean scale. ``packed_matmul`` is the one packed fast path:
raw activations in, act-quant -> int8 x trit accumulate -> rescale
``acc_f32 * (col_scale / x_scale)``, float32 out. On CUDA tensors it is
one launch of the act-quant-prologue kernel
(``kernels/ternary_matmul.py``); on CPU tensors, or with
``impl="plain"``, the kernel's plain PyTorch version runs.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.ternary_matmul import ternary_matmul_actq


@dataclasses.dataclass(frozen=True)
class PackedLinear:
    """Packed trits (ceil(K/g), N) uint8 + () f32 absmean scale + true K."""

    packed: torch.Tensor
    scale: torch.Tensor
    k: int
    codec: str

    def to(self, device) -> "PackedLinear":
        return dataclasses.replace(self, packed=self.packed.to(device),
                                   scale=self.scale.to(device))


@dataclasses.dataclass(frozen=True)
class FusedPackedLinear:
    """Same-input projections packed side by side along N (wq‖wk‖wv,
    gate‖up). ``scale`` is per column (each segment's absmean repeated
    over its width); ``splits`` are the segment widths."""

    packed: torch.Tensor
    scale: torch.Tensor
    k: int
    codec: str
    splits: tuple

    def to(self, device) -> "FusedPackedLinear":
        return dataclasses.replace(self, packed=self.packed.to(device),
                                   scale=self.scale.to(device))


PACKED_TYPES = (PackedLinear, FusedPackedLinear)


def packed_matmul(pw, x: torch.Tensor, act_bits: int = 8,
                  impl: str = "auto") -> torch.Tensor:
    """(M, K) raw float x packed weight -> (M, N) float32.

    The scalar scale of a ``PackedLinear`` broadcasts to a per-column
    vector; the epilogue divides the column scale by the row scale before
    the multiply, as the reference's kernel path does, so both leaf kinds
    give bit-identical columns."""
    n = pw.packed.shape[-1]
    col = pw.scale.float().reshape(-1).expand(n).contiguous()
    return ternary_matmul_actq(x, pw.packed, col, k=pw.k, codec=pw.codec,
                               act_bits=act_bits, impl=impl)
