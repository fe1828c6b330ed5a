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

A leaf may carry integrity stamps (``models/pack.py::add_integrity``):
``wsum``, the scale-weighted ABFT checksum vector (K,), and ``crc``, the
crc32 of its packed bytes. ``abft_check`` / ``packed_matmul_checked``
run the known-scale kernel (kernel 4) and check every output row sum
against the one ``wsum`` predicts (reference: "ABFT-checked matmul").
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.ternary import QuantizedActivation, act_quant
from repro_torch.kernels import ternary_matmul as tm


@dataclasses.dataclass(frozen=True)
class PackedLinear:
    """Packed trits (ceil(K/g), N) uint8 + () f32 absmean scale + true K;
    optionally the integrity stamps ``wsum`` (K,) f32 and ``crc``."""

    packed: torch.Tensor
    scale: torch.Tensor
    k: int
    codec: str
    wsum: Optional[torch.Tensor] = None
    crc: Optional[int] = None

    def to(self, device) -> "PackedLinear":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class FusedPackedLinear:
    """Same-input projections packed side by side along N (wq‖wk‖wv,
    gate‖up). ``scale`` is per column (each segment's absmean repeated
    over its width); ``splits`` are the segment widths; the stamps as
    for ``PackedLinear``, over the fused words."""

    packed: torch.Tensor
    scale: torch.Tensor
    k: int
    codec: str
    splits: tuple
    wsum: Optional[torch.Tensor] = None
    crc: Optional[int] = None

    def to(self, device) -> "FusedPackedLinear":
        return _to(self, device)


PACKED_TYPES = (PackedLinear, FusedPackedLinear)


def _to(pw, device):
    return dataclasses.replace(pw, packed=pw.packed.to(device), scale=pw.scale.to(device),
                               wsum=None if pw.wsum is None else pw.wsum.to(device))


def _col_scale(pw) -> torch.Tensor:
    """The leaf's scale as a per-column (N,) f32 vector."""
    n = pw.packed.shape[-1]
    return pw.scale.float().reshape(-1).expand(n).contiguous()


def packed_matmul(pw, x, act_bits: int = 8, impl: str = "auto",
                  fuse_actq: bool = True) -> torch.Tensor:
    """(M, K) raw float, or a ``QuantizedActivation`` of it, x packed
    weight -> (M, N) float32.

    The scalar scale of a ``PackedLinear`` broadcasts to a per-column
    vector; the epilogue divides the column scale by the row scale before
    the multiply, as the reference's kernel path does, so both leaf kinds
    give bit-identical columns."""
    col = _col_scale(pw)
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


# ---------------------------------------------------------------------------
# ABFT-checked matmul (reference: "ABFT-checked matmul")
# ---------------------------------------------------------------------------

# The f32 row-sum tolerance: both sides reassociate sums of ~K (the
# prediction) and ~N (the output row sum) f32 terms, so the rounding error
# is a small multiple of eps times the positive-term magnitude of those
# sums; one flipped trit moves a row sum by |xq[r, k]| * s (twice that for
# a -1 <-> +1 flip), far outside it wherever the row's code at k is nonzero.
ABFT_ATOL = 1e-4
ABFT_EPS_FACTOR = 64.0


class AbftError(ValueError):
    """An ABFT row-sum check failed: the packed words disagree with their
    pack-time checksum. Carries the worst row."""

    def __init__(self, msg: str, row: Optional[int] = None):
        super().__init__(msg)
        self.row = row


def abft_check(pw, x, act_bits: int = 8, impl: str = "auto"):
    """The packed matmul with its ABFT row-sum check, on the device:
    ``x`` is quantized once, ``y`` comes from the known-scale kernel
    (``ternary_matmul_fused``, kernel 4) and every output row sum is
    predicted from ``pw.wsum`` (``kernels.ternary_matmul.ternary_matmul_abft``).
    Returns ``(y, residual, tol)``; the check holds where ``residual <=
    tol``. The leaf is 2-D (slice stacked leaves first) and stamped."""
    if pw.wsum is None:
        raise AbftError("packed leaf carries no ABFT checksum: stamp it with "
                        "models.pack.add_integrity")
    q = x if isinstance(x, QuantizedActivation) else act_quant(x, bits=act_bits)
    return tm.ternary_matmul_abft(q.xq, pw.packed, q.scale, _col_scale(pw), pw.wsum,
                                  k=pw.k, codec=pw.codec, impl=impl, atol=ABFT_ATOL,
                                  eps_factor=ABFT_EPS_FACTOR)


def packed_matmul_checked(pw, x, act_bits: int = 8, impl: str = "auto") -> torch.Tensor:
    """``y``, or ``AbftError`` naming the worst row. The comparison syncs
    with the host: for scrub points and tests, not the decode step."""
    y, residual, tol = abft_check(pw, x, act_bits=act_bits, impl=impl)
    bad = residual > tol
    if bool(bad.any()):
        r = int(torch.argmax(residual - tol))
        raise AbftError(f"ABFT row-sum mismatch on {int(bad.sum())} row(s): worst row {r} "
                        f"residual {float(residual[r]):.3e} > tol {float(tol[r]):.3e}: packed "
                        "words disagree with their pack-time checksum (weight SDC)", row=r)
    return y
