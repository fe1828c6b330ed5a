"""Carry weights from the reference package into the port.

The input is the reference's parameter tree, its arrays as numpy or
anything ``np.asarray`` takes (this module imports no other array
library). Packed projection leaves arrive as plain dicts ``{"packed",
"scale", "k", "codec"}`` plus ``"splits"`` for a fused leaf, or as the
reference's ``PackedLinear`` / ``FusedPackedLinear`` objects, which
carry those fields as attributes. They are carried
as they are, bytes and scales, never re-packed: the port's absmean can
differ from the reference's by one ulp, which would flip trits.

The reference stacks the layers along a leading axis of each layer
stack (``blocks``; ``dense_blocks`` and ``moe_blocks`` for the MoE
family; ``mamba_tail`` for the hybrid family); the port keeps one dict
per layer, so the stacks are unstacked here. The hybrid family's
``mamba_groups`` is stacked twice, (n_groups, every, ...): it becomes a
list of groups, each a list of blocks. Its ``shared`` block is one block,
not stacked, and ``shared_lora_v`` (one v adapter per group, (n_groups,
...)) becomes a list of adapters, one per group. Expert-stacked packed
leaves keep their expert dimension (packed (E, K/g, N), scale (E,) or
per-column (E, N) for a fused w_gu). LoRA
factors, norms, the embedding, the lm_head (none in a model that ties
its embeddings, such as a speculative draft) and the float dict leaves
(``router``; MLA's ``w_uk`` / ``w_uv`` and the ``frontend``'s
projections, as ``{"w"}`` or already fake-quantized ``{"fq"}``) come
across unchanged. The reference keeps the last two float and ternarizes
them at each use, so a caller carries them as the reference's own
``weight_quant_ste`` values (``{"fq"}``): the port's ``pack_params``
would otherwise quantize the floats with its own absmean.

Integrity stamps come across too: ``wsum`` sliced per layer like the
scale, and ``crc``, which the reference stamps over a whole stacked leaf,
as each layer's own crc, after checking that the layers' bytes chained in
order give the reference's stamp (``models.pack.stack_crc32``); a stamp
that does not match its bytes raises.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.bitlinear import FusedPackedLinear, PackedLinear
from repro_torch.models.pack import iter_packed_leaves, stack_crc32

_PACKED_FIELDS = ("packed", "scale", "k", "codec")
_OPTIONAL_FIELDS = ("splits", "wsum", "crc")
LAYER_STACKS = ("blocks", "dense_blocks", "moe_blocks", "mamba_tail")
# stacked twice: (n_groups, every, ...)
GROUP_STACKS = ("mamba_groups",)
# one entry per group, each a subtree of its own (no packed leaf)
PER_GROUP = ("shared_lora_v",)


def _packed_fields(node):
    """A packed leaf's fields as a dict (``splits`` too for a fused leaf),
    given as the dict or as the reference's leaf object; None for any
    other node."""
    if isinstance(node, dict):
        return node if set(_PACKED_FIELDS) <= set(node) else None
    if all(hasattr(node, f) for f in _PACKED_FIELDS):
        return {f: getattr(node, f) for f in (*_PACKED_FIELDS, *_OPTIONAL_FIELDS)
                if getattr(node, f, None) is not None}
    return None


def to_tensor(a, device="cpu") -> torch.Tensor:
    """numpy -> torch; bfloat16 and float8_e4m3fn arrays (the reference's
    fp8 KV tiers) cross through their bits, found by dtype name and item
    size (their numpy dtypes come from an extension this module does not
    import)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    if a.dtype.name == "float8_e4m3fn" and a.dtype.itemsize == 1:
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _take(node, i: int):
    """Layer ``i`` of a stacked subtree (every array's leading axis)."""
    fields = _packed_fields(node)
    if fields is not None:
        out = {**fields, "packed": fields["packed"][i], "scale": fields["scale"][i]}
        if fields.get("wsum") is not None:
            out["wsum"] = fields["wsum"][i]
        if fields.get("crc") is not None:
            # the stack's crc does not hold for one layer: the layer is
            # stamped from its own bytes, and params_from_reference checks
            # the stack's stamp
            del out["crc"]
            out["stamped"] = True
        return out
    if isinstance(node, dict):
        return {k: _take(v, i) for k, v in node.items()}
    return np.asarray(node)[i]


def _stack_crcs(node, path=()):
    """{dotted path: crc} of the stamped packed leaves of a reference
    subtree."""
    fields = _packed_fields(node)
    if fields is not None:
        return {".".join(path): int(fields["crc"])} if fields.get("crc") is not None else {}
    if isinstance(node, dict):
        out = {}
        for k in sorted(node):
            out.update(_stack_crcs(node[k], path + (str(k),)))
        return out
    return {}


def _convert(node, device):
    fields = _packed_fields(node)
    if fields is not None:
        packed = to_tensor(fields["packed"], device)
        kw = dict(packed=packed, scale=to_tensor(fields["scale"], device).float(),
                  k=int(fields["k"]), codec=str(fields["codec"]))
        if fields.get("wsum") is not None:
            kw["wsum"] = to_tensor(fields["wsum"], device).float()
        if fields.get("crc") is not None or fields.get("stamped"):
            kw["crc"] = packing.packed_crc32(packed)
            if fields.get("crc") is not None and kw["crc"] != int(fields["crc"]):
                raise ValueError("a packed leaf's crc stamp does not match its bytes")
        if fields.get("splits") is not None:
            return FusedPackedLinear(splits=tuple(int(s) for s in fields["splits"]), **kw)
        return PackedLinear(**kw)
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()}
    return to_tensor(node, device)


def from_reference(node, device="cpu"):
    """One unstacked subtree of the reference (a layer, a block's
    attention), as numpy -> the port's leaves on ``device``."""
    return _convert(node, device)


def _n_stacked(node) -> int:
    """The length of a stacked subtree's leading axis (of its first array)."""
    fields = _packed_fields(node)
    if fields is not None:
        return np.asarray(fields["packed"]).shape[0]
    if isinstance(node, dict):
        return _n_stacked(node[sorted(node)[0]])
    return np.asarray(node).shape[0]


def _unstack(node, device, depth: int):
    """A subtree stacked ``depth`` times -> nested lists of the port's
    layers."""
    if depth == 0:
        return _convert(node, device)
    return [_unstack(_take(node, i), device, depth - 1) for i in range(_n_stacked(node))]


def params_from_reference(tree: dict, device="cpu") -> dict:
    """The reference's (packed or float) parameter tree, as numpy, -> the
    port's tree on ``device``."""
    depth = {**dict.fromkeys(LAYER_STACKS, 1), **dict.fromkeys(GROUP_STACKS, 2),
             **dict.fromkeys(PER_GROUP, 1)}
    out = {}
    for name, node in tree.items():
        out[name] = _unstack(node, device, depth.get(name, 0))
        want = _stack_crcs(node) if name in LAYER_STACKS + GROUP_STACKS else {}
        for path, stack in iter_packed_leaves(out[name]):
            if path in want and stack_crc32(stack) != want[path]:
                raise ValueError(f"the crc stamp of {name}.{path} does not match its "
                                 "layers' bytes")
    return out
