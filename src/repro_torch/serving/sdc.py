"""Silent-data-corruption (SDC) fault model and the serving integrity knobs
(reference: ``repro/serving/sdc.py``).

BitROM's storage planes fail differently, and each gets a seeded,
deterministic injector here, with the typed errors and the config that the
engine's detect -> contain -> repair ladder (``Engine._scrub``) is built
around:

- ROM stuck-at faults (``RomFaultInjector``): a packed word that reads
  wrong does so persistently. The injector draws (leaf, byte, bit)
  addresses from a seeded stream and re-asserts each stuck bit after the
  engine repairs the leaf from its golden copy, so repeated faults at one
  address strike a replica out and the ``Router`` retires it;
- DR-eDRAM retention decay (``RetentionInjector``): every crc-stamped
  pool page ages, and flips a bit with probability ``1 - (1 - rate)^age``;
- transient activation upsets (``inject_activation_nan``): a NaN poked
  into a slot's hot-tier K, which no checksum sees and the NaN sentinel of
  the decode step latches.

Same seed, same serve: same faults. The numpy generators draw exactly as
the reference's do, over the reference's stacked leaf paths and sizes
(``models/pack.py::iter_packed_leaves``), so a seeded fault lands on the
same byte in both packages. The port's caches are written in place, so
the injectors and ``clear_hot_slot`` write the device tensors of
``ctx.state`` rather than returning a rebuilt state; the packed weights
stay functional (``flip_packed_bit`` returns a tree that shares every leaf
but the flipped layer's), as in the reference.

Detection lives elsewhere: the crc32 and the ABFT probe (``models/pack``,
``core/bitlinear``), the scrub in ``serving/engine.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bitlinear, kv_cache
from repro_torch.models import pack as pack_lib
from repro_torch.models.pack import LeafStack


class NumericsError(RuntimeError):
    """Non-finite logits surfaced by the decode-step sentinel; carries the
    offending slot."""

    def __init__(self, msg: str, slot: Optional[int] = None):
        super().__init__(msg)
        self.slot = slot


class WeightFaultError(RuntimeError):
    """Packed weights failed their crc32 at load: the ROM image is corrupt
    before serving starts, and the engine refuses to come up."""


@dataclasses.dataclass
class IntegrityConfig:
    """The engine's SDC scrub (``Engine(integrity=...)``). Every scrub
    checks the crc32 of every packed leaf and, on a paged engine, of every
    stamped full KV page. ``scrub_every`` is the cadence in loop
    iterations; a slot ripe for harvest forces a scrub too, so no request
    retires with unverified weights or KV behind it (harvest gating)."""

    scrub_every: int = 4  # iterations between scrubs (ripe slots force one)
    abft_probe: bool = True  # the ABFT checked-matmul probe of every leaf
    on_numerics: str = "contain"  # "contain" (retire the slot) | "raise"
    max_weight_strikes: int = 3  # repeated weight faults -> unhealthy


# ---------------------------------------------------------------------------
# dotted-path access into the packed tree (paths of iter_packed_leaves)
# ---------------------------------------------------------------------------


def get_leaf(tree, path: str) -> LeafStack:
    """The ``LeafStack`` at a dotted path of ``iter_packed_leaves``: a
    layer list contributes every layer's leaf."""

    def walk(node, parts):
        if isinstance(node, list):
            return tuple(pw for layer in node for pw in walk(layer, parts))
        if not parts:
            return (node,)
        return walk(node[_child_key(node, parts[0])], parts[1:])

    return LeafStack(walk(tree, path.split(".")))


def set_leaf(tree, path: str, stack: LeafStack):
    """A copy of ``tree`` with the leaves at ``path`` replaced by
    ``stack``'s, layer by layer; only the dicts and lists along the path
    are rebuilt, every other leaf is shared."""
    layers = iter(stack.layers)

    def rebuild(node, parts):
        if isinstance(node, list):
            return [rebuild(layer, parts) for layer in node]
        if not parts:
            return next(layers)
        key = _child_key(node, parts[0])
        out = dict(node)
        out[key] = rebuild(node[key], parts[1:])
        return out

    out = rebuild(tree, path.split("."))
    if next(layers, None) is not None:
        raise ValueError(f"{path}: more leaves given than the tree holds")
    return out


def _child_key(node: dict, part: str):
    for k in node:
        if str(k) == part:
            return k
    raise KeyError(f"no child {part!r} in packed tree")


# ---------------------------------------------------------------------------
# the ABFT probe: the checked matmul against every packed leaf
# ---------------------------------------------------------------------------


def _leaf_slices(stack: LeafStack):
    """2-D (K, N) leaves of a stack: each layer, each expert of an
    expert-stacked layer, scale and wsum sliced with it."""
    for pw in stack.layers:
        if pw.packed.ndim == 2:
            yield pw
            continue
        for e in range(pw.packed.shape[0]):
            yield dataclasses.replace(pw, packed=pw.packed[e], scale=pw.scale[e],
                                      wsum=None if pw.wsum is None else pw.wsum[e])


def abft_verify_tree(params, impl: str = "auto") -> List[str]:
    """ABFT-probe every stamped leaf with the all-ones activation and
    return the dotted paths whose checked matmul trips (reference:
    ``abft_verify_tree``). Every input quantizes to qmax, so a trit change
    moves its row sum by one column scale (two for -1 <-> +1): far above
    the tolerance at smoke widths, but inside it at falcon3-1b's (the
    envelope grows with the row's magnitude), where the crc is the exact
    check. One kernel-4 launch of one row per 2-D slice (falcon3-1b: 18
    layers x 4 paths = 72), and one host sync for the whole tree."""
    flags, paths = [], []
    for path, stack in pack_lib.iter_packed_leaves(params):
        if any(pw.wsum is None for pw in stack.layers):
            continue
        bad = []
        for sub in _leaf_slices(stack):
            x = torch.ones((1, sub.k), dtype=torch.float32, device=sub.packed.device)
            _, residual, tol = bitlinear.abft_check(sub, x, impl=impl)
            bad.append((residual > tol).any())
        flags.append(torch.stack(bad).any())
        paths.append(path)
    if not flags:
        return []
    hit = torch.stack(flags).cpu().tolist()
    return [p for p, h in zip(paths, hit) if h]


# ---------------------------------------------------------------------------
# the ROM plane: persistent stuck-at faults in packed ternary words
# ---------------------------------------------------------------------------


def flip_packed_bit(params, path: str, index: int, bit: int):
    """Flip one bit of one packed byte of the stack at ``path`` (``index``
    flat into the stacked bytes, as the reference's leaf) and return the
    rebuilt tree: the flipped layer's words are a copy of the same shape
    and dtype on the same device, every other leaf is shared."""
    stack = get_leaf(params, path)
    flat = index % stack.size
    li, off = divmod(flat, stack.per_layer)
    pw = stack.layers[li]
    words = pw.packed.clone()
    words.view(-1)[off] ^= 1 << (bit % 8)
    layers = list(stack.layers)
    layers[li] = dataclasses.replace(pw, packed=words)
    return set_leaf(params, path, LeafStack(tuple(layers)))


class RomFaultInjector:
    """Seeded stuck-at adversary over an engine's packed weights
    (reference: ``RomFaultInjector``). Each firing mints a (leaf, byte,
    bit) address and flips it in ``engine.params``; after the scrub
    repairs the leaf from its golden copy, the next ``on_iteration``
    asserts the bit again (``reassert`` times per address; None: forever,
    which strikes a replica out)."""

    def __init__(self, seed: int, rate: float, reassert: Optional[int] = 1):
        self._rng = np.random.default_rng(seed)
        self.rate = rate
        self.reassert = reassert
        # live stuck addresses: (path, flat index, bit, asserts left)
        self.stuck: List[Tuple[str, int, int, Optional[int]]] = []
        self.injected = 0  # bit assertions applied
        self.addresses = 0  # distinct addresses minted

    def on_iteration(self, engine, ctx) -> None:
        del ctx
        if self._rng.random() < self.rate:
            leaves = list(pack_lib.iter_packed_leaves(engine.params))
            if leaves:
                path, stack = leaves[int(self._rng.integers(len(leaves)))]
                addr = (path, int(self._rng.integers(stack.size)), int(self._rng.integers(8)),
                        self.reassert)
                self.stuck.append(addr)
                self.addresses += 1
        self._assert_stuck(engine)

    def _assert_stuck(self, engine) -> None:
        """Re-apply every live stuck bit whose leaf reads clean again (the
        engine repaired it); a leaf still failing its crc is left alone, so
        one address is one fault per detection cycle."""
        keep = []
        for path, index, bit, remaining in self.stuck:
            if pack_lib.stack_corrupt(get_leaf(engine.params, path)):
                keep.append((path, index, bit, remaining))
                continue  # still corrupt from an earlier assert
            if remaining is not None and remaining <= 0:
                continue  # the address burned out (bounded mode)
            engine.params = flip_packed_bit(engine.params, path, index, bit)
            self.injected += 1
            keep.append((path, index, bit, None if remaining is None else remaining - 1))
        self.stuck = keep


# ---------------------------------------------------------------------------
# the DR-eDRAM plane: retention decay of KV pages
# ---------------------------------------------------------------------------


class RetentionInjector:
    """Seeded retention-decay adversary over stamped pool pages
    (reference: ``RetentionInjector``): every page the scrub has stamped
    ages by one each iteration, keyed by ``(page, born)`` so a reallocated
    page starts a new life; a page of age ``a`` flips one random bit with
    probability ``1 - (1 - rate)^a``."""

    def __init__(self, seed: int, rate: float):
        self._rng = np.random.default_rng(seed)
        self.rate = rate
        self._age: Dict[Tuple[int, int], int] = {}
        self.injected = 0  # bit flips applied
        self.pages_hit: set = set()  # distinct (page, born) lives corrupted

    def on_iteration(self, engine, ctx) -> None:
        del engine
        stamped = getattr(ctx, "page_crc", None)
        if not stamped or ctx.pool is None:
            return
        live = {(p, born) for p, (born, _) in stamped.items()}
        self._age = {k: v + 1 for k, v in self._age.items() if k in live}
        for key in sorted(live - set(self._age)):
            self._age[key] = 0
        victims = []
        for key in sorted(self._age):
            p_fail = 1.0 - (1.0 - self.rate) ** max(self._age[key], 0)
            if self._rng.random() < p_fail:
                victims.append(key)
        for key in victims:
            p, born = key
            # a stamp can outlive its page by one iteration (freed at
            # harvest, dropped at the next scrub): decay of a dead page is
            # unobservable and its bytes may belong to the next tenant
            if int(ctx.pool.born[p]) != born or ctx.pool.refs[p] <= 0:
                del self._age[key]
                continue
            self._flip_page(ctx, p)
            self.injected += 1
            self.pages_hit.add(key)
            del self._age[key]  # one decay event per page life

    def _flip_page(self, ctx, page: int) -> None:
        """Flip one bit of page ``page`` of one paged stack through the
        gather / write surface the handoff path uses, in place."""
        caches = ctx.state.cache
        keys = sorted(k for k in caches if isinstance(caches[k], kv_cache.PagedKVCache))
        if not keys:
            return
        cache = caches[keys[int(self._rng.integers(len(keys)))]]
        kp, vp = kv_cache.gather_pool_pages(cache, [page])
        hit_k = bool(self._rng.random() < 0.5)
        target = kp if hit_k else vp
        raw = bytearray(target.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
        raw[int(self._rng.integers(len(raw)))] ^= 1 << int(self._rng.integers(8))
        flipped = torch.frombuffer(raw, dtype=torch.uint8).view(target.dtype).reshape(
            target.shape)
        kp, vp = (flipped, vp) if hit_k else (kp, flipped)
        kv_cache.write_pool_pages(cache, [page], kp, vp)


# ---------------------------------------------------------------------------
# the activation plane: transient non-finite values
# ---------------------------------------------------------------------------


def _fill_rows(t: torch.Tensor, idx, value: float) -> None:
    """``t[idx] = value`` in place, an fp8 tier through its bytes (the
    reference's cast: NaN is 0x7f, zero 0x00)."""
    if t.dtype == kv_cache.FP8:
        t.view(torch.uint8)[idx] = 0x7F if value != value else 0
    else:
        t[idx] = value


def _stacked(cache) -> bool:
    return cache.lengths.ndim == 2


@torch.inference_mode()
def inject_activation_nan(ctx, slot: int) -> bool:
    """Poison one live slot's hot-tier K with NaN (reference:
    ``inject_activation_nan``), in every layer of the first cache stack: a
    transient upset that no checksum covers. The decode step's sentinel
    latches it into ``numerics_bad`` and the scrub contains the slot.
    True when a poke landed."""
    caches = ctx.state.cache
    keys = sorted(caches)
    if not keys:
        return False
    cache = caches[keys[0]]
    hot_k = getattr(cache, "hot_k", None)
    if hot_k is None:
        return False
    _fill_rows(hot_k, (slice(None), slot) if _stacked(cache) else slot, float("nan"))
    return True


@torch.inference_mode()
def clear_hot_slot(ctx, slot: int) -> None:
    """Zero one slot's poisonable KV storage (reference:
    ``clear_hot_slot``), the repair of the transient plane: containment
    alone leaves the NaN behind the cancelled request. The hot tier (the
    slot's next tenant would read stale rows) and the slot's sole-owned
    pool pages (a freed page carries its bytes to its next allocation)
    are zeroed; tree-shared pages (refcount > 1) are full prompt pages
    written before any upset and read by others, so they stay."""
    caches = ctx.state.cache
    own_pages: List[int] = []
    pool = getattr(ctx, "pool", None)
    slot_pages = getattr(ctx, "slot_pages", None)
    if pool is not None and slot_pages is not None:
        own_pages = [p for p in slot_pages[slot] if pool.refs[p] == 1]
    for key in sorted(caches):
        cache = caches[key]
        stacked = _stacked(cache)
        for field in ("hot_k", "hot_v"):
            buf = getattr(cache, field, None)
            if buf is not None:
                _fill_rows(buf, (slice(None), slot) if stacked else slot, 0.0)
        if own_pages and isinstance(cache, kv_cache.PagedKVCache):
            idx = torch.as_tensor(own_pages, dtype=torch.long, device=cache.pool_k.device)
            for buf in (cache.pool_k, cache.pool_v):
                _fill_rows(buf, (slice(None), idx) if stacked else idx, 0.0)
