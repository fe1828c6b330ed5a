"""Packed ternary projections (reference: ``repro/core/bitlinear.py``).

Inference-form weights are packed trits (uint8, 2.0 or 1.6 bits/weight)
plus their absmean scale. ``packed_matmul`` is the one packed fast path:
act-quant -> int8 x trit accumulate -> rescale ``acc_f32 * (col_scale /
x_scale)``, float32 out. It takes two routes, as the reference does:

- raw activations with ``fuse_actq`` (``BitNetConfig.fuse_act_quant``, the
  default): one launch of the act-quant-prologue kernel;
- a ``QuantizedActivation`` (codes + row scale from the producer), or
  ``fuse_actq=False``: a separate ``act_quant`` in plain PyTorch, then one
  launch of the known-scale kernel (the carried-scale path).

Both give the same int8 codes, the same int32 accumulator and the same
epilogue, so their outputs are bit-identical. On CPU tensors, or with
``impl="plain"``, the kernels' plain PyTorch versions run
(``kernels/ternary_matmul.py``). ``expert_packed_matmul`` is the
expert-stacked form: leaves with a leading expert dimension (packed
(E, K/g, N), scale (E,) or (E, N)) in one launch over all experts, with
the same two routes.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.ternary import QuantizedActivation, act_quant
from repro_torch.kernels import ternary_matmul as tm


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


def packed_matmul(pw, x, act_bits: int = 8, impl: str = "auto",
                  fuse_actq: bool = True) -> torch.Tensor:
    """(M, K) raw float, or a ``QuantizedActivation`` of it, x packed
    weight -> (M, N) float32.

    The scalar scale of a ``PackedLinear`` broadcasts to a per-column
    vector; the epilogue divides the column scale by the row scale before
    the multiply, as the reference's kernel path does, so both leaf kinds
    give bit-identical columns."""
    n = pw.packed.shape[-1]
    col = pw.scale.float().reshape(-1).expand(n).contiguous()
    if fuse_actq and not isinstance(x, QuantizedActivation):
        return tm.ternary_matmul_actq(x, pw.packed, col, k=pw.k, codec=pw.codec,
                                      act_bits=act_bits, impl=impl)
    q = x if isinstance(x, QuantizedActivation) else act_quant(x, bits=act_bits)
    return tm.ternary_matmul_fused(q.xq, pw.packed, q.scale, col, k=pw.k, codec=pw.codec,
                                   impl=impl)


def expert_packed_matmul(pw, x, act_bits: int = 8, impl: str = "auto",
                         fuse_actq: bool = True) -> torch.Tensor:
    """(E, C, K) raw float, or a ``QuantizedActivation`` of it, x
    expert-stacked packed weight -> (E, C, N) float32. A per-expert scalar
    scale (E,) broadcasts to per-column (E, N); a fused leaf carries (E, N)
    already."""
    e, n = pw.packed.shape[0], pw.packed.shape[-1]
    scale = pw.scale.float()
    col = (scale[:, None] if scale.ndim == 1 else scale).expand(e, n).contiguous()
    if fuse_actq and not isinstance(x, QuantizedActivation):
        return tm.ternary_matmul_expert(x, pw.packed, col, k=pw.k, codec=pw.codec,
                                        act_bits=act_bits, impl=impl)
    q = x if isinstance(x, QuantizedActivation) else act_quant(x, bits=act_bits)
    return tm.ternary_matmul_expert_fused(q.xq, pw.packed, q.scale, col, k=pw.k,
                                          codec=pw.codec, impl=impl)
