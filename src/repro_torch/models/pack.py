"""Freeze float params into ROM form: packed ternary, and the integrity
stamps the serving SDC scrub verifies (reference: ``repro/models/pack.py``).

``pack_params`` replaces every quantizable projection leaf
``{"w": (K, N)}`` named in ``PACK_KEYS`` by a ``PackedLinear`` (packed
trits + absmean scale; an expert-stacked ``(E, K, N)`` leaf packs expert
by expert, one absmean each), then merges the same-input groups of
``FUSE_GROUPS`` — wq‖wk‖wv, gate‖up, shared_gate‖shared_up, MLA's
w_dq‖w_dkv and the experts' w_gate‖w_up — into ``FusedPackedLinear``s
with per-column scales: one act-quant and one kernel launch per group.
MLA's float-kept factors ``w_uk`` / ``w_uv`` and every projection of
the ``frontend`` (an audio model's one, a vision model's ``proj1`` and
``proj2``) become ``{"fq": weight_quant_ste(w)}``, the value the reference
computes at every use (it keeps them unpacked and ternarizes them in
``qops.linear``);
the router, embedding and lm_head stay float (``SKIP_KEYS``), and so do a
Mamba2 block's norms, conv, ``a_log``, ``d_skip``, ``dt_bias`` and LoRA
factors (only its ``in_proj`` and ``out_proj`` pack). Leaves that
are already packed or fake-quantized pass through, so packing a packed
tree is a no-op: that is how weights packed by the reference and carried
across by ``interop`` enter the engine unchanged.

The absmean here is a float32 mean summed in PyTorch's order, which can
differ from the reference's by up to two ulps (and then flip a trit at the
rounding boundary); parity tests therefore carry the reference's packed
leaves rather than re-packing its float weights.

Integrity (``add_integrity``, ``pack_params(integrity=True)``) stamps
every packed leaf with its ABFT checksum ``wsum`` and the crc32 of its
bytes. The reference stacks the layers of a model, so its leaves, dotted
paths, crcs and fault addresses are per STACKED leaf
(``blocks.attn.wqkv`` is (L, K/g, N)); the port keeps one dict per layer.
``iter_packed_leaves`` therefore yields the reference's paths, in its
sorted-key order, each with a ``LeafStack`` of the layers' leaves (the
hybrid family's ``mamba_groups``, stacked twice in the reference, is a
list of groups of blocks here, walked group by group, so the layers
come in the order of the stacked leaf's bytes; ``shared`` is one block):
``stack_crc32`` chains the layers' bytes in order (the crc of the stacked
bytes), ``size`` is the stacked byte count and flat byte ``i`` of the
stack lies in layer ``i // per_layer``. Each layer leaf carries its own
crc, so ``verify_packed`` names a path when any of its layers mismatches.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core import packing
from repro_torch.core.bitlinear import FusedPackedLinear, PackedLinear
from repro_torch.core.ternary import weight_quant_absmean, weight_quant_ste
from repro_torch.kernels.ternary_matmul import abft_wsum

PACK_KEYS = {
    "wq", "wk", "wv", "wo",  # attention
    "gate", "up", "down",  # mlp
    "w_gate", "w_up", "w_down",  # routed experts (E-stacked)
    "shared_gate", "shared_up", "shared_down",  # shared expert
    "in_proj", "out_proj",  # Mamba2 blocks (unfused: they take different inputs)
    "w_dq", "w_uq", "w_dkv",  # MLA projections
}
# float-kept, ternarized at use: MLA's factors, and the frontend's
# projections (every {"w"} leaf of its subtree)
FQ_KEYS = {"w_uk", "w_uv", "frontend"}
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


def _fake_quant(tree):
    """Every float ``{"w"}`` leaf of a subtree as ``{"fq":
    weight_quant_ste(w)}``; ``{"fq"}`` leaves pass through."""
    if set(tree) == {"w"}:
        return {"fq": weight_quant_ste(tree["w"])}
    if set(tree) == {"fq"}:
        return tree
    return {k: _fake_quant(v) for k, v in tree.items()}


def pack_params(params, cfg: ModelConfig, codec: str | None = None,
                integrity: bool = False):
    """Convert a float parameter tree to the packed-inference tree, on the
    tree's own device; ``integrity`` stamps every packed leaf
    (``add_integrity``)."""
    if integrity:
        return add_integrity(pack_params(params, cfg, codec))
    codec = codec or cfg.bitnet.codec

    def walk(tree, name=None):
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        if isinstance(tree, dict):
            if set(tree) == {"w"} and name in PACK_KEYS:
                return pack_weight(tree["w"], codec)
            if name in FQ_KEYS:
                return _fake_quant(tree)
            if name in SKIP_KEYS:
                return tree
            return {k: walk(v, k) for k, v in tree.items()}
        return tree

    return _fuse_tree(walk(params))


# ---------------------------------------------------------------------------
# integrity stamps (serving/sdc.py)
# ---------------------------------------------------------------------------


def stamp_integrity(pw):
    """``pw`` with its ABFT ``wsum`` and the crc32 of its packed bytes,
    both computed from its own words (reference: ``_stamp_integrity``)."""
    return dataclasses.replace(pw, wsum=abft_wsum(pw.packed, pw.k, pw.codec, pw.scale),
                               crc=packing.packed_crc32(pw.packed))


def add_integrity(tree):
    """Stamp every packed leaf that lacks a stamp; everything else passes
    through (reference: ``add_integrity``)."""
    if isinstance(tree, (PackedLinear, FusedPackedLinear)):
        return stamp_integrity(tree) if tree.crc is None else tree
    if isinstance(tree, list):
        return [add_integrity(v) for v in tree]
    if isinstance(tree, dict):
        return {k: add_integrity(v) for k, v in tree.items()}
    return tree


@dataclasses.dataclass(frozen=True)
class LeafStack:
    """The leaves of every layer at one of the reference's stacked paths,
    in layer order (one leaf for a path outside a layer stack)."""

    layers: tuple

    @property
    def per_layer(self) -> int:
        """Packed bytes of one layer's leaf."""
        return int(self.layers[0].packed.numel())

    @property
    def size(self) -> int:
        """Packed bytes of the stack, the reference's leaf size."""
        return self.per_layer * len(self.layers)

    @property
    def stamped(self) -> bool:
        return all(pw.crc is not None for pw in self.layers)


def stack_crc32(stack: LeafStack) -> int:
    """crc32 of the stack's bytes in layer order: the reference's
    ``packed_crc32`` of its stacked leaf."""
    crc = 0
    for pw in stack.layers:
        crc = packing.packed_crc32(pw.packed, crc)
    return crc


def iter_packed_leaves(tree) -> Iterator[Tuple[str, LeafStack]]:
    """``(dotted_path, LeafStack)`` for every packed leaf of the tree, in
    the reference's sorted-key order and with its paths: a layer list
    stands where the reference has a stacked subtree, so its index is not
    part of the path. The enumeration the fault injectors and the weight
    scrub share."""

    def walk(node, path):
        if isinstance(node, (PackedLinear, FusedPackedLinear)):
            yield path, (node,)
        elif isinstance(node, dict):
            for key in sorted(node):
                yield from walk(node[key], path + (str(key),))
        elif isinstance(node, list) and node:
            per_layer = [dict(walk(layer, path)) for layer in node]
            for p in per_layer[0]:
                yield p, tuple(pw for layer in per_layer for pw in layer[p])

    for path, layers in walk(tree, ()):
        yield ".".join(path), LeafStack(layers)


def stack_corrupt(stack: LeafStack) -> bool:
    """True when a stamped layer's bytes no longer match its crc."""
    return any(pw.crc is not None and packing.packed_crc32(pw.packed) != pw.crc
               for pw in stack.layers)


def verify_packed(tree) -> List[str]:
    """Re-crc every stamped leaf against its pack-time crc and return the
    dotted paths where a layer mismatches (empty: clean). The exact
    weight check: it sees flips the ABFT row sums cannot (rows whose codes
    are zero). Unstamped leaves are skipped."""
    return [path for path, stack in iter_packed_leaves(tree) if stack_corrupt(stack)]


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
