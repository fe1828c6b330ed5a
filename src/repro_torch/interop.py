"""Carry weights from the reference package into the port.

The input is the reference's parameter tree with every array already
turned into numpy (the caller does that; this module sees numpy only).
Packed projection leaves arrive as plain dicts ``{"packed", "scale",
"k", "codec"}`` plus ``"splits"`` for a fused leaf — the fields of the
reference's ``PackedLinear`` / ``FusedPackedLinear``. They are carried
as they are, bytes and scales, never re-packed: the port's absmean can
differ from the reference's by one ulp, which would flip trits.

The reference stacks the layers along a leading axis of ``blocks``; the
port keeps one dict per layer, so ``blocks`` is unstacked here. LoRA
factors, norms, the embedding and the lm_head come across unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitlinear import FusedPackedLinear, PackedLinear

_PACKED_FIELDS = {"packed", "scale", "k", "codec"}


def _is_packed(node) -> bool:
    return isinstance(node, dict) and _PACKED_FIELDS <= set(node)


def to_tensor(a, device="cpu") -> torch.Tensor:
    """numpy -> torch; bfloat16 arrays cross through their uint16 bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _take(node, i: int):
    """Layer ``i`` of a stacked subtree (every array's leading axis)."""
    if _is_packed(node):
        return {**node, "packed": node["packed"][i], "scale": node["scale"][i]}
    if isinstance(node, dict):
        return {k: _take(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def _convert(node, device):
    if _is_packed(node):
        packed = to_tensor(node["packed"], device)
        scale = to_tensor(node["scale"], device).float()
        if node.get("splits") is not None:
            return FusedPackedLinear(packed=packed, scale=scale, k=int(node["k"]),
                                     codec=str(node["codec"]),
                                     splits=tuple(int(s) for s in node["splits"]))
        return PackedLinear(packed=packed, scale=scale, k=int(node["k"]),
                            codec=str(node["codec"]))
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()}
    return to_tensor(node, device)


def params_from_reference(tree: dict, device="cpu") -> dict:
    """The reference's (packed or float) parameter tree, as numpy, -> the
    port's tree on ``device``."""
    out = {k: _convert(v, device) for k, v in tree.items() if k != "blocks"}
    blocks = tree["blocks"]
    n_layers = np.asarray(blocks["attn"]["ln"]).shape[0]
    out["blocks"] = [_convert(_take(blocks, i), device) for i in range(n_layers)]
    return out
