"""Carry weights from the reference package into the port.

The input is the reference's parameter tree with every array already
turned into numpy (the caller does that; this module sees numpy only).
Packed projection leaves arrive as plain dicts ``{"packed", "scale",
"k", "codec"}`` plus ``"splits"`` for a fused leaf — the fields of the
reference's ``PackedLinear`` / ``FusedPackedLinear``. They are carried
as they are, bytes and scales, never re-packed: the port's absmean can
differ from the reference's by one ulp, which would flip trits.

The reference stacks the layers along a leading axis of each layer
stack (``blocks``; ``dense_blocks`` and ``moe_blocks`` for the MoE
family); the port keeps one dict per layer, so the stacks are unstacked
here. Expert-stacked packed leaves keep their expert dimension (packed
(E, K/g, N), scale (E,) or per-column (E, N) for a fused w_gu). LoRA
factors, norms, the embedding, the lm_head and the float dict leaves
(``router``; MLA's ``w_uk`` / ``w_uv``, as ``{"w"}`` or already
fake-quantized ``{"fq"}``) come across unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitlinear import FusedPackedLinear, PackedLinear

_PACKED_FIELDS = {"packed", "scale", "k", "codec"}
LAYER_STACKS = ("blocks", "dense_blocks", "moe_blocks")


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


def from_reference(node, device="cpu"):
    """One unstacked subtree of the reference (a layer, a block's
    attention), as numpy -> the port's leaves on ``device``."""
    return _convert(node, device)


def params_from_reference(tree: dict, device="cpu") -> dict:
    """The reference's (packed or float) parameter tree, as numpy, -> the
    port's tree on ``device``."""
    out = {k: _convert(v, device) for k, v in tree.items() if k not in LAYER_STACKS}
    for name in LAYER_STACKS:
        if name in tree:
            blocks = tree[name]
            n_layers = np.asarray(blocks["attn"]["ln"]).shape[0]
            out[name] = [_convert(_take(blocks, i), device) for i in range(n_layers)]
    return out
