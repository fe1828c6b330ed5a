"""Ternary weight packing codecs (reference: ``repro/core/packing.py``).

Both codecs pack along the contraction (K) axis of a (K, N) weight:

  * ``pack2`` — 4 trits per byte, 2 bits each: trit i of group k//4 sits
    at bits 2i..2i+1, LSB = +1 and MSB = -1 (code 0b00 is zero);
  * ``pack243`` — 5 trits per byte as ``sum((t_i + 1) * 3**i)``; the
    all-zero-trit byte is 121.

K is zero-padded (zero trits) to a multiple of the group size.
"""

from __future__ import annotations

import numpy as np
import torch

PACK2_GROUP = 4
PACK243_GROUP = 5
ZERO_CODE_243 = 121  # sum((0 + 1) * 3**i for i in range(5))


def group_of(codec: str) -> int:
    if codec == "pack2":
        return PACK2_GROUP
    if codec == "pack243":
        return PACK243_GROUP
    raise ValueError(f"unknown codec {codec!r}")


def padded_k(k: int, group: int) -> int:
    return (k + group - 1) // group * group


def pad_k(wq: torch.Tensor, group: int) -> torch.Tensor:
    """Zero-pad the K (first) axis of an int8 trit tensor to a group multiple."""
    k = wq.shape[0]
    pk = padded_k(k, group)
    if pk == k:
        return wq
    pad = torch.zeros((pk - k,) + tuple(wq.shape[1:]), dtype=wq.dtype,
                      device=wq.device)
    return torch.cat([wq, pad], dim=0)


def pack2(wq: torch.Tensor) -> torch.Tensor:
    """(K, ...) int8 trits -> (ceil(K/4), ...) uint8."""
    wq = pad_k(wq, PACK2_GROUP)
    codes = torch.where(wq == 1, 1, torch.where(wq == -1, 2, 0)).to(torch.int32)
    codes = codes.reshape((wq.shape[0] // PACK2_GROUP, PACK2_GROUP) + tuple(wq.shape[1:]))
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.int32, device=wq.device)
    shifts = shifts.reshape((1, PACK2_GROUP) + (1,) * (wq.ndim - 1))
    return (codes << shifts).sum(dim=1).to(torch.uint8)


def unpack2(packed: torch.Tensor, k: int | None = None) -> torch.Tensor:
    """(K/4, ...) uint8 -> (K, ...) int8 trits; trims padding to ``k``."""
    parts = []
    for i in range(PACK2_GROUP):
        c = (packed >> (2 * i)) & 0b11
        parts.append((c & 1).to(torch.int8) - ((c >> 1) & 1).to(torch.int8))
    out = torch.stack(parts, dim=1).reshape((-1,) + tuple(packed.shape[1:]))
    return out if k is None else out[:k]


def pack243(wq: torch.Tensor) -> torch.Tensor:
    """(K, ...) int8 trits -> (ceil(K/5), ...) uint8 with value sum (t_i+1)*3^i."""
    wq = pad_k(wq, PACK243_GROUP)
    digits = (wq.to(torch.int32) + 1).reshape(
        (wq.shape[0] // PACK243_GROUP, PACK243_GROUP) + tuple(wq.shape[1:]))
    weights = torch.tensor([1, 3, 9, 27, 81], dtype=torch.int32, device=wq.device)
    weights = weights.reshape((1, PACK243_GROUP) + (1,) * (wq.ndim - 1))
    return (digits * weights).sum(dim=1).to(torch.uint8)


def unpack243(packed: torch.Tensor, k: int | None = None) -> torch.Tensor:
    """(K/5, ...) uint8 -> (K, ...) int8 trits via repeated divmod 3."""
    v = packed.to(torch.int32)
    parts = []
    for _ in range(PACK243_GROUP):
        parts.append((v % 3 - 1).to(torch.int8))
        v = v // 3
    out = torch.stack(parts, dim=1).reshape((-1,) + tuple(packed.shape[1:]))
    return out if k is None else out[:k]


def pack(wq: torch.Tensor, codec: str) -> torch.Tensor:
    return pack2(wq) if codec == "pack2" else pack243(wq)


def unpack(packed: torch.Tensor, codec: str, k: int | None = None) -> torch.Tensor:
    return unpack2(packed, k) if codec == "pack2" else unpack243(packed, k)


def decode_table_243() -> np.ndarray:
    """(243, 5) int8 lookup table: byte value -> its five trits."""
    tbl = np.zeros((243, PACK243_GROUP), dtype=np.int8)
    for v in range(243):
        x = v
        for i in range(PACK243_GROUP):
            tbl[v, i] = x % 3 - 1
            x //= 3
    return tbl
