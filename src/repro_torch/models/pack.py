"""Freeze float params into ROM form: packed ternary (reference:
``repro/models/pack.py``; the integrity stamps are not part of this slice).

``pack_params`` replaces every quantizable projection leaf
``{"w": (K, N)}`` named in ``PACK_KEYS`` by a ``PackedLinear`` (packed
trits + absmean scale; an expert-stacked ``(E, K, N)`` leaf packs expert
by expert, one absmean each), then merges the same-input groups of
``FUSE_GROUPS`` — wq‖wk‖wv, gate‖up, shared_gate‖shared_up, MLA's
w_dq‖w_dkv and the experts' w_gate‖w_up — into ``FusedPackedLinear``s
with per-column scales: one act-quant and one kernel launch per group.
MLA's float-kept factors ``w_uk`` / ``w_uv`` become ``{"fq":
weight_quant_ste(w)}``, the value the reference computes at every use;
the router, embedding and lm_head stay float (``SKIP_KEYS``). Leaves that
are already packed or fake-quantized pass through, so packing a packed
tree is a no-op: that is how weights packed by the reference and carried
across by ``interop`` enter the engine unchanged.

The absmean here is a float32 mean summed in PyTorch's order, which can
differ from the reference's by up to two ulps (and then flip a trit at the
rounding boundary); parity tests therefore carry the reference's packed
leaves rather than re-packing its float weights.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core import packing
from repro_torch.core.bitlinear import FusedPackedLinear, PackedLinear
from repro_torch.core.ternary import weight_quant_absmean, weight_quant_ste

PACK_KEYS = {
    "wq", "wk", "wv", "wo",  # attention
    "gate", "up", "down",  # mlp
    "w_gate", "w_up", "w_down",  # routed experts (E-stacked)
    "shared_gate", "shared_up", "shared_down",  # shared expert
    "w_dq", "w_uq", "w_dkv",  # MLA projections
}
FQ_KEYS = {"w_uk", "w_uv"}  # MLA factors: float-kept, ternarized at use
SKIP_KEYS = {"embed", "lm_head", "router"} | FQ_KEYS

# Same-input sibling projections merged by the fusion pass (the order fixes
# the segment order of the fused output).
FUSE_GROUPS = (
    (("wq", "wk", "wv"), "wqkv"),
    (("gate", "up"), "wgu"),
    (("shared_gate", "shared_up"), "shared_gu"),
    (("w_dq", "w_dkv"), "w_dqkv"),  # the per-branch norms apply after the split
    (("w_gate", "w_up"), "w_gu"),  # expert-stacked: the E dim passes through
)


def pack_weight(w: torch.Tensor, codec: str) -> PackedLinear:
    """w: (K, N) float -> PackedLinear; (E, K, N) packs one expert at a time
    (scale (E,))."""
    if w.ndim == 3:
        return stack_packed([pack_weight(we, codec) for we in w])
    q = weight_quant_absmean(w)
    return PackedLinear(packed=packing.pack(q.wq, codec), scale=q.scale, k=w.shape[0],
                        codec=codec)


def stack_packed(pws: Sequence[PackedLinear]) -> PackedLinear:
    """Per-expert PackedLinears -> one with a leading expert dimension."""
    return PackedLinear(packed=torch.stack([pw.packed for pw in pws]),
                        scale=torch.stack([pw.scale for pw in pws]), k=pws[0].k,
                        codec=pws[0].codec)


def fuse_packed(pws: Sequence[PackedLinear]) -> FusedPackedLinear:
    """Concatenate same-K PackedLinears along N; each segment's scale
    (scalar, or (E,) for expert-stacked leaves) is repeated over its
    width, so the fused scale is per column: (N,) or (E, N)."""
    k, codec = pws[0].k, pws[0].codec
    if any(pw.k != k or pw.codec != codec for pw in pws):
        raise ValueError([(pw.k, pw.codec) for pw in pws])
    splits = tuple(int(pw.packed.shape[-1]) for pw in pws)
    packed = torch.cat([pw.packed for pw in pws], dim=-1)
    scale = torch.cat([pw.scale.float()[..., None].expand(tuple(pw.scale.shape) + (w,))
                       for pw, w in zip(pws, splits)], dim=-1)
    return FusedPackedLinear(packed=packed, scale=scale, k=k, codec=codec, splits=splits)


def _fuse_tree(tree):
    if isinstance(tree, list):
        return [_fuse_tree(v) for v in tree]
    if not isinstance(tree, dict):
        return tree
    out = {k: _fuse_tree(v) for k, v in tree.items()}
    for keys, fused_name in FUSE_GROUPS:
        members = [out.get(kk) for kk in keys]
        if not all(isinstance(m, PackedLinear) for m in members):
            continue
        if len({(m.k, m.codec) for m in members}) != 1:
            continue
        for kk in keys:
            del out[kk]
        out[fused_name] = fuse_packed(members)
    return out


def pack_params(params, cfg: ModelConfig, codec: str | None = None):
    """Convert a float parameter tree to the packed-inference tree, on the
    tree's own device."""
    codec = codec or cfg.bitnet.codec

    def walk(tree, name=None):
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        if isinstance(tree, dict):
            if set(tree) == {"w"} and name in PACK_KEYS:
                return pack_weight(tree["w"], codec)
            if set(tree) == {"w"} and name in FQ_KEYS:
                return {"fq": weight_quant_ste(tree["w"])}
            if name in SKIP_KEYS:
                return tree
            return {k: walk(v, k) for k, v in tree.items()}
        return tree

    return _fuse_tree(walk(params))


def tree_to(tree, device):
    """Move every tensor (and packed leaf) of a parameter tree to ``device``."""
    if isinstance(tree, (PackedLinear, FusedPackedLinear)):
        return tree.to(device)
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
