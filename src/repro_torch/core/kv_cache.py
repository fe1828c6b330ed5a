"""Two-tier (DR eDRAM-style) KV cache with per-slot lengths (reference:
``repro/core/kv_cache.py``), with a contiguous or a paged cold tier.

  hot_k/hot_v   : (batch, hot_cap, g, d)   the first ``hot_cap`` tokens
  cold_k/cold_v : (batch, cold_cap, g, d)  the rest
  lengths       : (batch,) int32           tokens written, per slot

``PagedKVCache`` keeps the hot tier and replaces the cold one by a pool
shared by every slot: ``pool_k/pool_v`` (n_pages, page_size, g, d) and a
``page_table`` (batch, pages_per_slot) int32; cold row r of slot b lives
at row ``r % page_size`` of pool page ``page_table[b, r // page_size]``.
Slots that share a prompt prefix map the same pool pages (the host-side
refcounts and prefix tree are ``serving/paging.py``); ``paged_admit``
installs a slot's table and restores its hot tier, ``save_hot`` snapshots
one into the pool. ``as_tiered`` gathers the cold tier back into a
contiguous view for the plain references.

The MLA latent cache keeps one row (c_kv ‖ k_rope) per token in the
k-slot, (batch, cap, kv_lora_rank + rope dims), and an empty v-slot
(batch, cap, 0).

Sliding-window archs (SWA) keep a RING cold tier: position p >= hot_cap
lands at cold row ``(p - hot_cap) % cold_cap``, so the tier holds the last
``cold_cap`` tokens (``append(ring=True)``, ``append_decode_ring``,
``fill_fresh(ring=True)``); the serving layout has no hot tier and a ring
of ``min(window, max_len)`` rows. A paged cache refuses the ring, as the
reference does.

The serving path stacks one cache per layer along a leading axis
(``layer`` returns a view of one layer). Unlike the reference, whose
arrays are immutable, the appends here write the tier buffers and
``lengths`` IN PLACE: a decode step then moves one row per slot instead
of copying the cache.

Tiers are f32, bf16 or fp8 (e4m3, ``FP8``; ``BitNetConfig.kv_fp8``).
Every write into a tier goes through ``to_tier``, the reference's cast,
and fp8 tiers are indexed and written through their bytes (``raw``), so
no fp8 arithmetic or indexing kernel is needed on either device. The
plain reads upcast a tier row to f32, which is exact for all three.

The traffic ledger (``step_traffic_tokens``, ``prompt_traffic_tokens``)
counts KV accesses in token units per slot; summed over a sequence it
reconciles exactly with ``dr_edram.closed_form_reduction``.

The handoff wire format (``export_slot_state`` / ``import_slot_state``,
``pack_slot_state`` / ``unpack_slot_state``, ``write_pool_pages`` /
``gather_pool_pages``) serializes one slot's rows for warm migration
between replicas; its payload is the reference's byte for byte.
``pool_page_crcs`` stamps pool pages for the SDC scrub over the same
gather.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

NEG_INF = torch.finfo(torch.float32).min
FP8 = torch.float8_e4m3fn
FP8_OVERFLOW = 464.0  # |x| above it (or non-finite) casts to NaN


def raw(t: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor as its bytes (a uint8 view), any other as it is."""
    return t.view(torch.uint8) if t.dtype == FP8 else t


def to_tier(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` in a tier's dtype: ``.to(dtype)`` for f32 and bf16 tiers; for
    an fp8 tier the reference's cast (jax's ``astype(float8_e4m3fn)``):
    round to nearest even, and NaN with the sign kept where |x| > 464 or x
    is not finite (torch's own cast saturates to 448 there). Inputs in
    bf16 give what the reference gives them too, since the reference's
    bf16 -> fp8 cast equals its f32 -> fp8 cast of the same value. Built
    from integer ops, so the result does not depend on the device's cast;
    the CUDA kernels' emit (``to_e4m3`` in ``csrc/fp8.cuh``) repeats it."""
    if dtype != FP8:
        return x.to(dtype)
    if x.dtype == FP8:
        return x
    x32 = x.float().contiguous()
    bits = x32.view(torch.int32)
    sign = (bits >> 24) & 0x80
    a = x32.abs()
    # normal range (|x| >= 2^-6): rebias the exponent (127 -> 7) and round
    # the 23-bit mantissa to 3 bits, half to even; the carry moves into the
    # exponent as it should
    r = (bits & 0x7FFFFFFF) - (120 << 23)
    normal = (r + 0x7FFFF + ((r >> 20) & 1)) >> 20
    # subnormals: whole multiples of 2^-9, half to even (an exact product)
    sub = torch.round(a * 512.0).to(torch.int32)
    mag = torch.where(a < 2.0 ** -6, sub, normal)
    byte = torch.where(a <= FP8_OVERFLOW, mag, torch.full_like(mag, 0x7F)) | sign
    return byte.to(torch.uint8).view(FP8)


class TieredKVCache(NamedTuple):
    hot_k: torch.Tensor
    hot_v: torch.Tensor
    cold_k: torch.Tensor
    cold_v: torch.Tensor
    lengths: torch.Tensor  # (batch,) int32

    # the capacity axis follows the stacking and batch axes of ``lengths``
    # (a row is (g, d) under GQA, one latent vector under MLA)
    @property
    def hot_cap(self) -> int:
        return self.hot_k.shape[self.lengths.ndim]

    @property
    def cold_cap(self) -> int:
        return self.cold_k.shape[self.lengths.ndim]

    @property
    def capacity(self) -> int:
        return self.hot_cap + self.cold_cap


def init_cache(batch: int, hot_cap: int, cold_cap: int, kv_shape: Sequence[int],
               dtype=torch.float32, device=None, lead: tuple = (),
               v_shape: Optional[Sequence[int]] = None) -> TieredKVCache:
    """Zeroed cache; ``lead`` prepends stacking dims (one cache per layer).
    ``v_shape`` defaults to ``kv_shape``; ``(0,)`` gives the empty v-slot of
    the MLA latent cache, whose k-slot row (c_kv ‖ k_rope) serves as both."""
    lead = tuple(lead)
    v_shape = tuple(kv_shape) if v_shape is None else tuple(v_shape)

    def zeros(cap, shape):
        return _zeros(lead + (batch, cap) + shape, dtype, device)

    return TieredKVCache(
        hot_k=zeros(hot_cap, tuple(kv_shape)),
        hot_v=zeros(hot_cap, v_shape),
        cold_k=zeros(cold_cap, tuple(kv_shape)),
        cold_v=zeros(cold_cap, v_shape),
        lengths=torch.zeros(lead + (batch,), dtype=torch.int32, device=device),
    )


class PagedKVCache(NamedTuple):
    """Tiered cache with a paged cold tier (reference: ``PagedKVCache``).

    Unused table entries hold a VALID pool index (convention: 0): reads
    are bounded by ``lengths``, never by the table."""

    hot_k: torch.Tensor
    hot_v: torch.Tensor
    pool_k: torch.Tensor  # (n_pages, page_size, ...)
    pool_v: torch.Tensor
    page_table: torch.Tensor  # (batch, pages_per_slot) int32
    lengths: torch.Tensor  # (batch,) int32

    # axes follow the stacking axes of ``lengths``, as in TieredKVCache
    @property
    def hot_cap(self) -> int:
        return self.hot_k.shape[self.lengths.ndim]

    @property
    def page_size(self) -> int:
        return self.pool_k.shape[self.lengths.ndim]

    @property
    def n_pages(self) -> int:
        return self.pool_k.shape[self.lengths.ndim - 1]

    @property
    def pages_per_slot(self) -> int:
        return self.page_table.shape[-1]

    @property
    def cold_cap(self) -> int:
        return self.pages_per_slot * self.page_size

    @property
    def capacity(self) -> int:
        return self.hot_cap + self.cold_cap


def init_paged_cache(batch: int, hot_cap: int, cold_cap: int, kv_shape: Sequence[int],
                     dtype=torch.float32, page_size: int = 32, n_pages: Optional[int] = None,
                     device=None, lead: tuple = (),
                     v_shape: Optional[Sequence[int]] = None) -> PagedKVCache:
    """Zeroed paged cache. ``cold_cap`` rounds up to whole pages; the pool
    defaults to one private page set per slot and the table to the
    identity (slot b's page j = pool page b * pps + j, clipped to the
    pool), so an unshared paged cache is the contiguous one re-addressed.
    ``lead`` prepends stacking dims (one cache per layer)."""
    if cold_cap <= 0:
        raise ValueError("a paged cache needs a non-empty cold tier")
    lead = tuple(lead)
    v_shape = tuple(kv_shape) if v_shape is None else tuple(v_shape)
    pps = -(-cold_cap // page_size)
    n_pages = batch * pps if n_pages is None else n_pages
    if n_pages < 1:
        raise ValueError("a paged cache needs at least one page")
    table = (torch.arange(batch, dtype=torch.int32, device=device)[:, None] * pps
             + torch.arange(pps, dtype=torch.int32, device=device)[None]).clamp(max=n_pages - 1)

    def zeros(*shape):
        return _zeros(lead + shape, dtype, device)

    return PagedKVCache(
        hot_k=zeros(batch, hot_cap, *kv_shape),
        hot_v=zeros(batch, hot_cap, *v_shape),
        pool_k=zeros(n_pages, page_size, *kv_shape),
        pool_v=zeros(n_pages, page_size, *v_shape),
        page_table=table.expand(lead + table.shape).contiguous(),
        lengths=torch.zeros(lead + (batch,), dtype=torch.int32, device=device),
    )


def cold_view(cache: PagedKVCache) -> tuple:
    """The paged cold tier gathered into contiguous (batch, cold_cap, ...)
    k / v copies: the indirection the paged kernels do per row, done at
    once for the plain references."""
    b = cache.page_table.shape[0]
    table = cache.page_table.long()
    tail = cache.pool_k.shape[2:]
    return (rows_of(cache.pool_k, table).reshape((b, cache.cold_cap) + tail),
            rows_of(cache.pool_v, table).reshape((b, cache.cold_cap) + cache.pool_v.shape[2:]))


def as_tiered(cache: PagedKVCache) -> TieredKVCache:
    """Contiguous view of a paged cache (gathers the cold tier; a copy)."""
    ck, cv = cold_view(cache)
    return TieredKVCache(cache.hot_k, cache.hot_v, ck, cv, cache.lengths)


def layer(stack, i: int):
    """View of layer ``i`` of a stacked cache, tiered or paged (writes go
    to the stack)."""
    return type(stack)(*(t[i] for t in stack))


def _zeros(shape, dtype, device) -> torch.Tensor:
    """Zeroed tier; an fp8 one as zero bytes (+0.0)."""
    if dtype == FP8:
        return torch.zeros(shape, dtype=torch.uint8, device=device).view(FP8)
    return torch.zeros(shape, dtype=dtype, device=device)


def rows_of(t: torch.Tensor, *idx) -> torch.Tensor:
    """``t[idx]`` (advanced indexing), an fp8 tier through its bytes."""
    return raw(t)[idx].view(t.dtype)


def _put_rows(flat: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
              write: torch.Tensor) -> None:
    """``flat[rows[i]] = vals[i]`` where ``write[i]``, in place, with no
    host sync. The entries that do not write repeat the first writer's
    (row, value), or, when none writes, write back ``flat``'s own value at
    their first row, so every index that occurs twice carries one value.
    The writers' rows are distinct (one writer per page row)."""
    rows = rows.reshape(-1).long().clamp(0, flat.shape[0] - 1)
    write = write.reshape(-1)
    if rows.numel() == 0 or flat.numel() == 0:
        return
    vals = raw(to_tier(vals.reshape((rows.shape[0],) + flat.shape[1:]), flat.dtype))
    flat = raw(flat)
    first = torch.argmax(write.to(torch.int32))  # first writer, or 0
    r0 = rows[first]
    bshape = (-1,) + (1,) * (flat.ndim - 1)
    v0 = torch.where(write[first], vals[first], flat[r0])
    flat.index_put_((torch.where(write, rows, r0),),
                    torch.where(write.reshape(bshape), vals, v0[None]))


def paged_cold_rows(cache: PagedKVCache, cold_pos: torch.Tensor) -> torch.Tensor:
    """Pool row of each cold position (b, ...) of its slot (reference:
    ``_paged_cold_rows``): page ``page_table[b, pos // ps]`` (the page index
    clipped to the table), row ``pos % ps``."""
    ps = cache.page_size
    pg = (cold_pos // ps).clamp(0, cache.pages_per_slot - 1)
    page = torch.gather(cache.page_table.long(), 1, pg.reshape(pg.shape[0], -1)).reshape(pg.shape)
    return page * ps + cold_pos % ps


def pool_flat(cache: PagedKVCache):
    """The k and v pools as views of (n_pages * page_size, ...) rows."""
    n_rows = cache.n_pages * cache.page_size
    return (cache.pool_k.view((n_rows,) + cache.pool_k.shape[2:]),
            cache.pool_v.view((n_rows,) + cache.pool_v.shape[2:]))


def _paged_append(cache: PagedKVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                  valid: Optional[torch.Tensor]) -> PagedKVCache:
    """Bulk append into a paged cache, in place (reference:
    ``_paged_append``): hot rows as in the contiguous append, cold rows to
    their pool rows through the page table. Each writable page has one
    writer slot (shared pages are only read; ``serving/paging.py``)."""
    t = k_new.shape[1]
    start = cache.lengths.long()
    t_idx = torch.arange(t, device=start.device)
    pos = start[:, None] + t_idx[None]  # (b, t)
    n_new = (torch.full_like(start, t) if valid is None else valid.long())
    write = t_idx[None] < n_new[:, None]
    for tier, new in ((cache.hot_k, k_new), (cache.hot_v, v_new)):
        _write_rows(tier, new, pos, write & (pos < cache.hot_cap))
    in_cold = write & (pos >= cache.hot_cap)
    rows = paged_cold_rows(cache, pos - cache.hot_cap)
    for flat, new in zip(pool_flat(cache), (k_new, v_new)):
        _put_rows(flat, rows, new, in_cold)
    cache.lengths.add_(n_new.to(cache.lengths.dtype))
    return cache


def _paged_append_one(cache: PagedKVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                      active: Optional[torch.Tensor]) -> PagedKVCache:
    """Decode append (one token per slot) into a paged cache, in place."""
    b = cache.lengths.shape[0]
    pos = cache.lengths.long()
    act = (torch.ones(b, dtype=torch.bool, device=pos.device) if active is None
           else active.bool())
    in_hot = pos < cache.hot_cap
    for tier, new in ((cache.hot_k, k_new), (cache.hot_v, v_new)):
        _write_rows(tier, new[:, None], pos[:, None], (in_hot & act)[:, None])
    rows = paged_cold_rows(cache, pos - cache.hot_cap)
    for flat, new in zip(pool_flat(cache), (k_new, v_new)):
        _put_rows(flat, rows, new, ~in_hot & act)
    cache.lengths.add_(act.to(cache.lengths.dtype))
    return cache


def _refuse_paged_ring(cache, ring: bool) -> None:
    if ring and isinstance(cache, PagedKVCache):
        raise NotImplementedError("a paged cache has no ring layout (as in the reference)")


def _append_one(cache: TieredKVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                active: Optional[torch.Tensor], ring: bool) -> TieredKVCache:
    """Append one token (batch, g, d) per slot at its own length, in place
    (reference: ``_append_one``). ``ring``: a cold position lands at row
    ``(pos - hot_cap) % cold_cap``; else positions past the capacity clip to
    the last row, as in the reference."""
    _refuse_paged_ring(cache, ring)
    if isinstance(cache, PagedKVCache):
        return _paged_append_one(cache, k_new, v_new, active)
    b = cache.lengths.shape[0]
    pos = cache.lengths.long()
    act = (torch.ones(b, dtype=torch.bool, device=pos.device) if active is None
           else active.bool())
    rows = torch.arange(b, device=pos.device)
    in_hot = pos < cache.hot_cap

    def upd(tier, new, tier_pos, write):
        cap = tier.shape[1]
        if tier.numel() == 0:  # zero-capacity tier or the empty latent v-slot
            return
        idx = tier_pos % cap if ring else tier_pos.clamp(0, cap - 1)
        mask = (write & act).reshape((b,) + (1,) * (tier.ndim - 2))
        t = raw(tier)
        t[rows, idx] = torch.where(mask, raw(to_tier(new, tier.dtype)), t[rows, idx])

    upd(cache.hot_k, k_new, pos, in_hot)
    upd(cache.hot_v, v_new, pos, in_hot)
    upd(cache.cold_k, k_new, pos - cache.hot_cap, ~in_hot)
    upd(cache.cold_v, v_new, pos - cache.hot_cap, ~in_hot)
    cache.lengths.add_(act.to(cache.lengths.dtype))
    return cache


def append_decode(cache: TieredKVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                  active: Optional[torch.Tensor] = None) -> TieredKVCache:
    """Append one token (batch, g, d) per slot at its own length, in place.

    ``active`` (batch,) bool gates the write per slot: inactive slots keep
    their rows and length. Positions past the capacity clip to the last
    row, as in the reference."""
    return _append_one(cache, k_new, v_new, active, ring=False)


def append_decode_ring(cache: TieredKVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                       active: Optional[torch.Tensor] = None) -> TieredKVCache:
    """Decode append over a ring cold tier (sliding-window archs), in place:
    position p >= hot_cap lands at cold row ``(p - hot_cap) % cold_cap``, so
    the tier keeps the last ``cold_cap`` tokens (reference:
    ``append_decode_ring``)."""
    return _append_one(cache, k_new, v_new, active, ring=True)


def _scattered(x: torch.Tensor) -> torch.Tensor:
    """A value as the reference's bulk scatter writes it: that scatter is a
    one-hot product summed from +0.0, so a -0.0 arrives as +0.0 (fp8:
    byte 0x80 as 0x00); every other value as it is."""
    if x.dtype == FP8:
        b = raw(x)
        return torch.where(b == 0x80, torch.zeros_like(b), b).view(FP8)
    return x + 0.0


def _write_rows(tier: torch.Tensor, new: torch.Tensor, tier_pos: torch.Tensor,
                write: torch.Tensor) -> None:
    """Row ``tier_pos[b, t]`` of slot b takes ``new[b, t]`` (as the
    reference's bulk scatter writes it, ``_scattered``) where ``write``,
    in place. Consecutive positions of a slot are distinct modulo the
    capacity, so each write goes in groups of at most ``cap`` rows to the
    indices ``tier_pos % cap``; the rows not written take back their own
    values, and no two entries of a group share a row."""
    b, cap = tier.shape[:2]
    if tier.numel() == 0:  # zero-capacity tier or the empty latent v-slot
        return
    rows = torch.arange(b, device=tier.device)[:, None]
    new, tier = raw(_scattered(to_tier(new, tier.dtype))), raw(tier)
    for s0 in range(0, new.shape[1], cap):
        idx = tier_pos[:, s0:s0 + cap] % cap
        mask = write[:, s0:s0 + cap].reshape(idx.shape + (1,) * (tier.ndim - 2))
        tier[rows, idx] = torch.where(mask, new[:, s0:s0 + cap], tier[rows, idx])


def append(cache: TieredKVCache, k_new: torch.Tensor, v_new: torch.Tensor,
           valid: Optional[torch.Tensor] = None, ring: bool = False) -> TieredKVCache:
    """Append up to ``t`` tokens (batch, t, ...) per slot at its own
    length, in place (reference: ``kv_cache.append``).

    ``valid`` (batch,) caps the real rows per slot: slot b writes its first
    ``valid[b]`` rows, at positions ``lengths[b] + i``, to the hot tier
    below ``hot_cap`` and to the cold tier at ``pos - hot_cap`` above it;
    then ``lengths`` grows by ``valid``. A slot with ``valid = 0`` keeps its
    rows and length. Positions past the capacity are not written (the
    engine never makes them).

    ``ring=True`` (sliding-window archs): a cold position lands at row
    ``(pos - hot_cap) % cold_cap`` and only each slot's last ``cold_cap``
    valid rows write (the earlier ones would be evicted within this call),
    so every ring row has one writer, as in the reference. A paged cache
    refuses the ring."""
    _refuse_paged_ring(cache, ring)
    if isinstance(cache, PagedKVCache):
        return _paged_append(cache, k_new, v_new, valid)
    t = k_new.shape[1]
    start = cache.lengths.long()
    t_idx = torch.arange(t, device=start.device)
    pos = start[:, None] + t_idx[None]  # (b, t)
    n_new = (torch.full_like(start, t) if valid is None else valid.long())
    write = t_idx[None] < n_new[:, None]
    in_hot = write & (pos < cache.hot_cap)
    if ring:
        in_cold = write & (pos >= cache.hot_cap) & (
            n_new[:, None] - 1 - t_idx[None] < cache.cold_cap)
    else:
        in_cold = write & (pos >= cache.hot_cap) & (pos < cache.capacity)
    for tier, new in ((cache.hot_k, k_new), (cache.hot_v, v_new)):
        _write_rows(tier, new, pos, in_hot)
    for tier, new in ((cache.cold_k, k_new), (cache.cold_v, v_new)):
        _write_rows(tier, new, pos - cache.hot_cap, in_cold)
    cache.lengths.add_(n_new.to(cache.lengths.dtype))
    return cache


def fill_fresh(cache: TieredKVCache, k_new: torch.Tensor, v_new: torch.Tensor,
               ring: bool = False) -> TieredKVCache:
    """Place an aligned full prompt (batch, s, g, d) — already rotated and
    in the tier dtype — into a fresh cache with static slices, in place.

    ``ring`` with s > cold_cap: the reference's ring realign — the last
    ``cold_cap`` rows go to the cold tier with position p at row
    ``p % cold_cap`` (the SWA layout, hot_cap = 0), and ``lengths`` is s."""
    s = k_new.shape[1]
    if ring and s > cache.cold_cap:
        w = cache.cold_cap
        order = torch.argsort(torch.arange(s - w, s, device=k_new.device) % w)
        for tier, new in ((cache.cold_k, k_new), (cache.cold_v, v_new)):
            raw(tier).copy_(raw(to_tier(new[:, s - w:], tier.dtype))[:, order])
        cache.lengths.fill_(s)
        return cache
    n_h = min(s, cache.hot_cap)
    n_c = min(s - n_h, cache.cold_cap)
    for tier, new in ((cache.hot_k, k_new), (cache.hot_v, v_new)):
        if n_h:
            raw(tier)[:, :n_h] = raw(to_tier(new[:, :n_h], tier.dtype))
    for tier, new in ((cache.cold_k, k_new), (cache.cold_v, v_new)):
        if n_c:
            raw(tier)[:, :n_c] = raw(to_tier(new[:, n_h:n_h + n_c], tier.dtype))
    cache.lengths.fill_(s)
    return cache


# ---------------------------------------------------------------------------
# Paged-serving admission ops (device side of serving/paging.py)
# ---------------------------------------------------------------------------


def paged_admit(cache: PagedKVCache, reset: torch.Tensor, new_lengths: torch.Tensor,
                new_table: torch.Tensor, hot_src: torch.Tensor, cow_src: torch.Tensor,
                cow_dst: torch.Tensor) -> PagedKVCache:
    """(Re)initialise the ``reset`` slots (b,) for new requests, in place
    (reference: ``paged_admit``): install each one's page-table row and
    prefix length M, copy the partially matched boundary page ``cow_src``
    into the slot's private ``cow_dst`` (copy-on-write; -1 = none), then
    restore hot rows i < min(M, hot_cap) from the snapshot pages
    ``hot_src`` (b, n_hot_pages) (row i at row i % ps of page
    ``hot_src[b, i // ps]``; -1 = none). Other slots are untouched."""
    reset = reset.bool()
    new_lengths = new_lengths.to(cache.lengths.dtype)
    cache.page_table.copy_(torch.where(reset[:, None], new_table.to(cache.page_table.dtype),
                                       cache.page_table))
    cache.lengths.copy_(torch.where(reset, new_lengths, cache.lengths))
    ps = cache.page_size
    pk, pv = pool_flat(cache)
    j = torch.arange(ps, device=reset.device)[None]  # (1, ps)
    cow_src, cow_dst = cow_src.long(), cow_dst.long()
    cow_ok = (reset & (cow_src >= 0) & (cow_dst >= 0))[:, None].expand(-1, ps)
    src_rows = (cow_src.clamp(min=0)[:, None] * ps + j).clamp(max=pk.shape[0] - 1)
    dst_rows = cow_dst.clamp(min=0)[:, None] * ps + j
    for flat in (pk, pv):
        _put_rows(flat, dst_rows, rows_of(flat, src_rows.reshape(-1)), cow_ok)
    if cache.hot_cap:
        i = torch.arange(cache.hot_cap, device=reset.device)[None]  # (1, hc)
        pg = (i // ps).clamp(max=hot_src.shape[1] - 1).expand(hot_src.shape[0], -1)
        src_pages = torch.gather(hot_src.long(), 1, pg)  # (b, hc)
        rows = (src_pages.clamp(min=0) * ps + i % ps).clamp(max=pk.shape[0] - 1)
        ok = (reset[:, None] & (src_pages >= 0)
              & (i < new_lengths.long().clamp(max=cache.hot_cap)[:, None]))
        for hot, flat in ((cache.hot_k, pk), (cache.hot_v, pv)):
            if hot.numel():
                m = ok.reshape(ok.shape + (1,) * (hot.ndim - 2))
                raw(hot).copy_(torch.where(m, raw(to_tier(rows_of(flat, rows), hot.dtype)),
                                           raw(hot)))
    return cache


def save_hot(cache: PagedKVCache, slot: int, page_ids: torch.Tensor) -> PagedKVCache:
    """Snapshot slot ``slot``'s hot tier into pool pages ``page_ids``
    ((n_hot_pages,), -1 = skip), in place (reference: ``save_hot``): hot
    row i lands at row i % ps of page ``page_ids[i // ps]``."""
    ps = cache.page_size
    i = torch.arange(cache.hot_cap, device=cache.hot_k.device)
    pages = page_ids.long()[(i // ps).clamp(max=page_ids.shape[0] - 1)]
    rows = pages.clamp(min=0) * ps + i % ps
    for flat, hot in zip(pool_flat(cache), (cache.hot_k, cache.hot_v)):
        _put_rows(flat, rows, hot[slot], pages >= 0)
    return cache


def release_slots(cache, released: torch.Tensor):
    """Truncate the ``released`` slots ((b,) bool) to length 0, in place
    (reference: ``release_slots``): slot retirement without
    reinitialisation, when serving preempts or cancels a request
    mid-flight. Tiered and paged caches alike, stacked or not (the mask
    broadcasts against the trailing batch axis). Rows and page-table
    entries stay: a zero-length slot reads nothing, and the freed pool
    pages belong to the host-side ``PagePool`` refcounts."""
    cache.lengths.masked_fill_(released.bool().expand_as(cache.lengths), 0)
    return cache


def truncate(cache, new_lengths: torch.Tensor):
    """Roll each slot back to ``min(lengths, new_lengths)`` tokens, in place
    (reference: ``truncate``): the speculative reject path, which commits a
    whole verified chunk and then drops the rejected suffix. Tiered and
    paged caches alike, stacked or not (``new_lengths`` (b,) broadcasts
    against the stacked (L, b) lengths); a slot already at or below its
    target keeps its length. Rows past the new length stay (reads are
    bounded by ``lengths`` and the next append overwrites them), and so do
    page-table entries: the host decides which pages the rollback strands
    and decrefs them. Not valid on a ring that has wrapped, whose append
    overwrote the window's oldest rows."""
    torch.minimum(cache.lengths, new_lengths.to(cache.lengths.dtype), out=cache.lengths)
    return cache


# ---------------------------------------------------------------------------
# Plain tiered attention read: per-tier partials + streaming-softmax merge
# ---------------------------------------------------------------------------


def valid_masks(cache: TieredKVCache):
    """Per-slot validity of each tier row: (b, hot_cap), (b, cold_cap) bool.
    The cold count clamps at cold_cap, which also covers a wrapped ring:
    every row is valid once the window has wrapped."""
    lengths = cache.lengths.long()
    dev = lengths.device
    hot_valid = torch.arange(cache.hot_cap, device=dev)[None] < lengths[:, None]
    n_cold = (lengths - cache.hot_cap).clamp(0, cache.cold_cap)
    cold_valid = torch.arange(cache.cold_cap, device=dev)[None] < n_cold[:, None]
    return hot_valid, cold_valid


def tier_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor, scale: float):
    """Partial attention over one tier.

    q: (b, h, d); k/v: (b, s, g, d); valid: (b, s) bool. Returns
    (numerator (b, h, dv), denominator (b, h), max (b, h)), all f32. v is
    zeroed at invalid rows before the product: p = 0 there, but 0 * NaN
    is NaN, and a masked row may hold anything."""
    b, s, g, d = k.shape
    h = q.shape[1]
    dv = v.shape[-1]
    if s == 0:
        return (q.new_zeros((b, h, dv), dtype=torch.float32),
                q.new_zeros((b, h), dtype=torch.float32),
                q.new_full((b, h), NEG_INF, dtype=torch.float32))
    rep = h // g
    qg = q.reshape(b, g, rep, d).float()
    kf = k.float()
    vf = torch.where(valid[:, :, None, None], v.float(), 0.0)
    logits = torch.einsum("bgrd,bsgd->bgrs", qg, kf) * scale
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None]) * valid[:, None, None, :]
    denom = p.sum(dim=-1)
    num = torch.einsum("bgrs,bsgd->bgrd", p, vf)
    return num.reshape(b, h, dv), denom.reshape(b, h), m.reshape(b, h)


def merge_partials(parts):
    """Streaming-softmax merge of (num, den, max) partials -> (b, h, dv)."""
    num, den, m = parts[0]
    for n2, d2, m2 in parts[1:]:
        m_new = torch.maximum(m, m2)
        a1 = torch.exp(m - m_new) * (den > 0)
        a2 = torch.exp(m2 - m_new) * (d2 > 0)
        num = num * a1[..., None] + n2 * a2[..., None]
        den = den * a1 + d2 * a2
        m = m_new
    return num / torch.clamp(den, min=1e-30)[..., None]


def tiered_decode_attention(q: torch.Tensor, cache: TieredKVCache,
                            scale: float | None = None) -> torch.Tensor:
    """One-token attention over both tiers. q: (b, h, d) -> (b, h, d).
    A slot with length 0 returns zeros. A paged cache is read through
    ``as_tiered`` (a reference for the tests; no card path calls it)."""
    if isinstance(cache, PagedKVCache):
        cache = as_tiered(cache)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    hot_valid, cold_valid = valid_masks(cache)
    out = merge_partials([
        tier_partial(q, cache.hot_k, cache.hot_v, hot_valid, scale),
        tier_partial(q, cache.cold_k, cache.cold_v, cold_valid, scale),
    ])
    return out.to(q.dtype)


def tiered_decode_attention_latent(q: torch.Tensor, cache: TieredKVCache,
                                   value_dim: int, scale: float) -> torch.Tensor:
    """MLA absorbed-form attention over a tiered latent cache, masked over
    the full capacity (the reference's XLA path).

    q: (b, h, D); the k-slot rows (b, s, D) hold (c_kv ‖ k_rope) and the
    v-slot is empty: values are the first ``value_dim`` dims of each row.
    Returns the per-head latent context (b, h, value_dim) f32."""
    hot_valid, cold_valid = valid_masks(cache)
    parts = []
    for kbuf, valid in ((cache.hot_k, hot_valid), (cache.cold_k, cold_valid)):
        lat = kbuf[..., :value_dim][:, :, None]  # (b, s, 1, dv): one shared "head"
        parts.append(tier_partial(q, kbuf[:, :, None], lat, valid, scale))
    return merge_partials(parts)


def ring_slot_positions(offset: torch.Tensor, cold_cap: int) -> torch.Tensor:
    """Absolute position held by each ring row, (b, cold_cap) (reference:
    ``ring_slot_positions``; the SWA layout, hot_cap = 0): row j holds the
    largest p < offset with p = j (mod cold_cap), negative where no token
    has been written yet."""
    j = torch.arange(cold_cap, dtype=torch.int32, device=offset.device)[None]
    off = offset.to(torch.int32)[:, None]
    return off - 1 - torch.remainder(off - 1 - j, cold_cap)


def tiered_chunk_attention(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                           cache: Optional[TieredKVCache],
                           valid: Optional[torch.Tensor] = None,
                           scale: float | None = None, window: int = 0,
                           ring: bool = False) -> torch.Tensor:
    """Causal chunk attention over [tiered cache prefix ‖ own chunk], in
    f32 (reference: ``kv_cache.tiered_chunk_attention``). ``window`` masks
    keys at or past ``window`` positions behind a row (SWA); ``ring``: the
    cold tier is the ring layout, its rows' positions from
    ``ring_slot_positions``.

    q (b, C, h, dk), k_new (b, C, g, dk), RoPE already applied; v_new (b,
    C, g, dv). Chunk row t of slot b sits at position ``lengths[b] + t``
    and attends to the slot's cached tokens (both tiers) and to the chunk
    rows 0..t that are among its first ``valid[b]``. Per-tier partials
    merge as in the decode read; the tiers are never concatenated. A paged
    cache is read through ``as_tiered`` (a reference for the tests)."""
    _refuse_paged_ring(cache, ring)
    if isinstance(cache, PagedKVCache):
        cache = as_tiered(cache)
    b, c, h, dk = q.shape
    g, dv = k_new.shape[2], v_new.shape[-1]
    rep = h // g
    scale = scale if scale is not None else dk ** -0.5
    dev = q.device
    offset = (cache.lengths.long() if cache is not None
              else torch.zeros((b,), dtype=torch.long, device=dev))
    n_new = (valid.long() if valid is not None
             else torch.full((b,), c, dtype=torch.long, device=dev))
    q_pos = offset[:, None] + torch.arange(c, device=dev)[None]  # (b, C)
    qg = q.reshape(b, c, g, rep, dk).permute(0, 2, 3, 1, 4).float()  # (b, g, rep, C, dk)

    def partial(kbuf, vbuf, kpos, kvalid):
        # kbuf (b, S, g, dk), vbuf (b, S, g, dv), kpos / kvalid (b, S)
        if kbuf.shape[1] == 0:
            return (q.new_zeros((b, g, rep, c, dv), dtype=torch.float32),
                    q.new_zeros((b, g, rep, c), dtype=torch.float32),
                    q.new_full((b, g, rep, c), NEG_INF, dtype=torch.float32))
        vf = torch.where(kvalid[:, :, None, None], vbuf.float(), 0.0)
        logits = torch.einsum("bgrcd,bsgd->bgrcs", qg, kbuf.float()) * scale
        mask = kvalid[:, None, :] & (q_pos[:, :, None] >= kpos[:, None, :])
        if window:
            mask = mask & (q_pos[:, :, None] - kpos[:, None, :] < window)
        mask = mask[:, None, None]
        logits = torch.where(mask, logits, NEG_INF)
        m = logits.amax(dim=-1)
        p = torch.exp(logits - m[..., None]) * mask
        return torch.einsum("bgrcs,bsgd->bgrcd", p, vf), p.sum(dim=-1), m

    parts = []
    if cache is not None and cache.hot_cap:
        hpos = torch.arange(cache.hot_cap, device=dev)[None].expand(b, -1)
        parts.append(partial(cache.hot_k, cache.hot_v, hpos,
                             hpos < offset.clamp(max=cache.hot_cap)[:, None]))
    if cache is not None and cache.cold_cap:
        if ring:
            cpos = ring_slot_positions(offset, cache.cold_cap).long()
            cvalid = cpos >= 0
        else:
            j = torch.arange(cache.cold_cap, device=dev)[None].expand(b, -1)
            n_cold = (offset - cache.hot_cap).clamp(0, cache.cold_cap)
            cpos, cvalid = cache.hot_cap + j, j < n_cold[:, None]
        parts.append(partial(cache.cold_k, cache.cold_v, cpos, cvalid))
    parts.append(partial(k_new, v_new, q_pos,
                         torch.arange(c, device=dev)[None] < n_new[:, None]))
    out = merge_partials(parts)  # (b, g, rep, C, dv)
    return out.permute(0, 3, 1, 2, 4).reshape(b, c, h, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# DR-traffic ledger (token units)
# ---------------------------------------------------------------------------

TRAFFIC_KEYS = ("ondie_read", "ext_read", "ondie_write", "ext_write")


def external_reduction(traffic: dict) -> float:
    """Fraction of accesses kept on-die, from a 4-key traffic ledger."""
    ext = traffic["ext_read"] + traffic["ext_write"]
    total = ext + traffic["ondie_read"] + traffic["ondie_write"]
    return 1.0 - ext / total if total else 0.0


def step_traffic_tokens(lengths: torch.Tensor, hot_cap: int) -> dict:
    """Per-slot ledger of one decode step at the pre-append ``lengths``."""
    lengths = lengths.to(torch.int32)
    ext_w = (lengths >= hot_cap).to(torch.int32)
    return {
        "ondie_read": torch.clamp(lengths, max=hot_cap),
        "ext_read": torch.clamp(lengths - hot_cap, min=0),
        "ondie_write": 1 - ext_w,
        "ext_write": ext_w,
    }


def spec_traffic_tokens(lengths: torch.Tensor, chunk_valid: torch.Tensor,
                        committed: torch.Tensor, hot_cap: int) -> dict:
    """Per-slot ledger of one speculative draft-verify round (reference:
    ``spec_traffic_tokens``): ``lengths`` before the round, ``chunk_valid``
    rows verified, ``committed`` rows appended. The cached prefix streams
    once per round, and chunk row i also reads rows 0..i-1 of the chunk
    on-die; the draft's own cache is outside this ledger. A speculative
    serve therefore undercuts the sequential closed form when it accepts."""
    lengths = lengths.to(torch.int32)
    m = chunk_valid.to(torch.int32)
    w = committed.to(torch.int32)
    ondie_w = torch.minimum((hot_cap - lengths).clamp(min=0), w)
    return {
        "ondie_read": torch.clamp(lengths, max=hot_cap) + m * (m - 1) // 2,
        "ext_read": torch.clamp(lengths - hot_cap, min=0),
        "ondie_write": ondie_w,
        "ext_write": w - ondie_w,
    }


def prompt_traffic_tokens(prompt_len: int, hot_cap: int) -> dict:
    """Closed-form prompt-phase ledger: the sum of ``step_traffic_tokens``
    over lengths 0..prompt_len-1."""
    p, b = prompt_len, hot_cap
    if p <= b:
        ondie_read = p * (p - 1) // 2
        ext_read = 0
    else:
        ondie_read = b * (b - 1) // 2 + (p - b) * b
        ext_read = (p - b - 1) * (p - b) // 2
    return {
        "ondie_read": ondie_read,
        "ext_read": ext_read,
        "ondie_write": min(p, b),
        "ext_write": max(p - b, 0),
    }


def prompt_traffic_tokens_resumed(prompt_len: int, prefix_len: int,
                                  hot_cap: int) -> dict:
    """Prompt-phase ledger when the first ``prefix_len`` tokens were
    restored from a shared prefix instead of prefilled; the hot part of
    the restored prefix is reloaded from external memory."""
    full = prompt_traffic_tokens(prompt_len, hot_cap)
    skipped = prompt_traffic_tokens(min(prefix_len, prompt_len), hot_cap)
    out = {k: full[k] - skipped[k] for k in TRAFFIC_KEYS}
    reload_hot = min(prefix_len, hot_cap)
    out["ext_read"] += reload_hot
    out["ondie_write"] += reload_hot
    return out


# ---------------------------------------------------------------------------
# Slot-state serialization (replica KV handoff; serving/replica.py)
# ---------------------------------------------------------------------------
#
# Warm migration between replicas ships ONE slot's live KV rows in the tier
# storage dtype: with kv_fp8 on, one byte per element, 4x smaller than f32
# and 2x smaller than bf16. The frame is the reference's byte for byte: a
# crc32 per ``page_size`` rows of every array and a whole-payload trailer,
# so a corrupted or torn handoff raises ``HandoffError`` and the receiver
# recomputes from the prefix instead of serving wrong tokens. numpy holds
# neither bf16 nor fp8, so the rows travel as torch tensors on the host and
# cross the wire as their bytes; the payload names each dtype as numpy (and
# ml_dtypes) spell it, through ``_WIRE_DTYPES``.


class HandoffError(RuntimeError):
    """A serialized slot-state payload failed verification: torn framing,
    an unknown dtype, a per-page or whole-payload checksum mismatch, or a
    dtype that does not match the receiving cache. Receivers treat it as
    "no handoff" and recompute the request from its prompt."""

    def __init__(self, msg: str, key: Optional[str] = None, page: Optional[int] = None):
        super().__init__(msg)
        self.key = key
        self.page = page


_HANDOFF_MAGIC = b"KVH1"
_HANDOFF_ARRAYS = ("hot_k", "hot_v", "cold_k", "cold_v")
# storage dtypes by the name the payload carries (numpy's / ml_dtypes')
_WIRE_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                "bfloat16": torch.bfloat16, "float8_e4m3fn": FP8}
_WIRE_NAMES = {v: k for k, v in _WIRE_DTYPES.items()}


def _wire_dtype(name: str) -> torch.dtype:
    """The torch dtype of a payload's dtype name."""
    if name not in _WIRE_DTYPES:
        raise HandoffError(f"unknown storage dtype {name!r} in handoff")
    return _WIRE_DTYPES[name]


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous()


def _wire_name(t: torch.Tensor) -> str:
    if t.dtype not in _WIRE_NAMES:
        raise HandoffError(f"no wire name for storage dtype {t.dtype}")
    return _WIRE_NAMES[t.dtype]


def _bytes_of(t: torch.Tensor) -> bytes:
    """The bytes of a contiguous host tensor, as numpy's ``tobytes`` gives
    them for the same values."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _stack_view(cache):
    """(stacked, lead-axed tensors): a stacked cache as it is, an unstacked
    one with a leading layer axis of 1 (views)."""
    stacked = cache.lengths.ndim == 2
    return stacked, (lambda t: t if stacked else t[None])


def slot_state_length(cache) -> np.ndarray:
    """Per-slot cached length, collapsed over a stacked layer axis."""
    lengths = cache.lengths.cpu().numpy()
    return lengths.max(axis=0) if lengths.ndim == 2 else lengths


def export_slot_state(cache, slot: int) -> dict:
    """Host copy of one slot's live KV rows, in the tier storage dtype
    (reference: ``export_slot_state``). Tiered or paged, stacked or not;
    the arrays always carry a leading layer axis (1 when unstacked):
    ``hot_k`` / ``hot_v`` the first ``min(length, hot_cap)`` rows,
    ``cold_k`` / ``cold_v`` the ``length - hot_cap`` rows past them. A paged
    cache's cold rows are gathered through the slot's page-table row (read
    from the device once), so the export does not depend on the layout."""
    stacked, lead = _stack_view(cache)
    lengths = cache.lengths.cpu()
    length = int(lengths[:, slot].max()) if stacked else int(lengths[slot])
    hc = cache.hot_cap
    n_hot, n_cold = min(length, hc), max(length - hc, 0)

    def rows(t, *idx):
        return raw(lead(t))[idx].cpu().view(t.dtype)

    state = {"length": length, "stacked": stacked,
             "hot_k": rows(cache.hot_k, slice(None), slot, slice(0, n_hot)),
             "hot_v": rows(cache.hot_v, slice(None), slot, slice(0, n_hot))}
    if isinstance(cache, PagedKVCache):
        ps = cache.page_size
        table = (cache.page_table[0] if stacked else cache.page_table)[slot]
        kp = -(-n_cold // ps) if n_cold else 0
        ids = table[:kp].cpu().long().to(cache.pool_k.device)
        for name, pool in (("cold_k", cache.pool_k), ("cold_v", cache.pool_v)):
            pages = rows(pool, slice(None), ids)  # (layers, kp, ps, ...)
            state[name] = pages.reshape((pages.shape[0], kp * ps) + pages.shape[3:])[:, :n_cold]
    else:
        for name, tier in (("cold_k", cache.cold_k), ("cold_v", cache.cold_v)):
            state[name] = rows(tier, slice(None), slot, slice(0, n_cold))
    return state


def pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """Host rows (layers, r, ...) zero-padded to (layers, rows, ...)."""
    pad = rows - t.shape[1]
    if pad <= 0:
        return t
    return torch.cat([t, _zeros((t.shape[0], pad) + tuple(t.shape[2:]), t.dtype, None)], 1)


def _put(tier: torch.Tensor, idx, vals: torch.Tensor) -> None:
    """``tier[idx] = vals`` through the bytes (fp8 tiers have no indexing
    kernel), ``vals`` already in the tier's dtype."""
    raw(tier)[idx] = raw(vals.to(tier.device))


def _check_dtype(cache, arr, key: str) -> None:
    want, got = _wire_name(cache.hot_k), _wire_name(arr)
    if want != got:
        raise HandoffError(f"handoff dtype {got} does not match cache storage dtype {want} for "
                           f"{key!r}: refusing to cast KV bits", key=key)


@torch.inference_mode()
def import_slot_state(cache, slot: int, state: dict):
    """Write an exported slot state into ``slot`` of ``cache``, in place
    (reference: ``import_slot_state``; the round trip is bit-identical, and
    a dtype that differs from the cache's raises ``HandoffError`` rather
    than cast). A paged cache's cold rows go through the slot's CURRENT
    page-table row, overwriting whole pages: the caller must have pointed
    it at pages the slot owns alone, as an admission does."""
    stacked, lead = _stack_view(cache)
    length = int(state["length"])
    hc = cache.hot_cap
    n_hot, n_cold = min(length, hc), max(length - hc, 0)
    for name in _HANDOFF_ARRAYS:
        _check_dtype(cache, state[name], name)
    for name, tier in (("hot_k", cache.hot_k), ("hot_v", cache.hot_v)):
        _put(lead(tier), (slice(None), slot, slice(0, n_hot)), _host(state[name]))
    lead(cache.lengths)[:, slot] = length
    if isinstance(cache, PagedKVCache):
        ps = cache.page_size
        kp = -(-n_cold // ps) if n_cold else 0
        if kp:
            row = (cache.page_table[0] if stacked else cache.page_table)[slot, :kp]
            ids = row.cpu().long().to(cache.pool_k.device)
            for name, pool in (("cold_k", cache.pool_k), ("cold_v", cache.pool_v)):
                c = pad_rows(_host(state[name]), kp * ps)
                _put(lead(pool), (slice(None), ids),
                     c.reshape((c.shape[0], kp, ps) + c.shape[2:]))
    else:
        for name, tier in (("cold_k", cache.cold_k), ("cold_v", cache.cold_v)):
            _put(lead(tier), (slice(None), slot, slice(0, n_cold)), _host(state[name]))
    return cache


@torch.inference_mode()
def write_pool_pages(cache: PagedKVCache, page_ids, k_pages, v_pages) -> PagedKVCache:
    """Write whole pages into the shared pool, in place (reference:
    ``write_pool_pages``): ``k_pages`` / ``v_pages`` are (layers, n,
    page_size, ...) rows for pool pages ``page_ids`` (n,). The receiving
    side of warm migration: imported cold pages land in freshly allocated
    pages, which the prefix tree then adopts by id. Pages of another dtype
    than the pool's raise ``HandoffError`` (the reference would cast)."""
    _, lead = _stack_view(cache)
    ids = torch.as_tensor(np.asarray(page_ids, np.int64), device=cache.pool_k.device)
    for name, pool, pages in (("cold_k", cache.pool_k, k_pages), ("cold_v", cache.pool_v, v_pages)):
        _check_dtype(cache, pages, name)
        _put(lead(pool), (slice(None), ids), _host(pages))
    return cache


def gather_pool_pages(cache: PagedKVCache, page_ids):
    """Read whole pages out of the pool (reference: ``gather_pool_pages``):
    ``(k_pages, v_pages)`` host tensors of (layers, n, page_size, ...) in
    the storage dtype, layers 1 for an unstacked cache."""
    _, lead = _stack_view(cache)
    ids = torch.as_tensor(np.asarray(page_ids, np.int64), device=cache.pool_k.device)
    return tuple(raw(lead(pool))[:, ids].cpu().view(pool.dtype)
                 for pool in (cache.pool_k, cache.pool_v))


def pool_page_crcs(caches: dict, pages) -> dict:
    """crc32 of each pool page's bytes across every paged cache stack
    (reference: ``pool_page_crcs``): the DR-eDRAM retention stamp the
    serving scrub verifies. ``caches`` is the engine's ``{key: cache}``;
    a page's digest chains its K, then its V bytes (every layer) of each
    paged stack in sorted-key order, so one bit flip anywhere in the
    page's storage changes it. Returns ``{page_id: crc}``; one gather per
    stack and tier, whatever the page count."""
    ids = sorted(int(p) for p in pages)
    if not ids:
        return {}
    crcs = {p: 0 for p in ids}
    for key in sorted(caches):
        cache = caches[key]
        if not isinstance(cache, PagedKVCache):
            continue
        kp, vp = gather_pool_pages(cache, ids)
        for i, p in enumerate(ids):
            for pages in (kp, vp):
                crcs[p] = zlib.crc32(_host(pages[:, i]).reshape(-1).view(torch.uint8).numpy(),
                                     crcs[p])
    return {p: c & 0xFFFFFFFF for p, c in crcs.items()}


def pack_slot_state(states: dict, page_size: int) -> bytes:
    """Serialize ``{cache_key: export_slot_state(...)}`` into one framed
    payload (reference: ``pack_slot_state``, whose bytes it gives for the
    same rows): arrays in their storage dtype, a crc32 per ``page_size``
    rows and a whole-payload crc32 trailer."""
    ps = max(int(page_size), 1)
    out = [_HANDOFF_MAGIC, struct.pack("<II", len(states), ps)]
    for key in sorted(states):
        st = states[key]
        kb = key.encode()
        out += [struct.pack("<H", len(kb)), kb,
                struct.pack("<IB", int(st["length"]), 1 if st["stacked"] else 0)]
        for name in _HANDOFF_ARRAYS:
            dt = _wire_name(st[name]).encode()
            arr = _host(st[name])
            rows = arr.shape[1]
            n_pages = -(-rows // ps) if rows else 0
            out += [struct.pack("<H", len(dt)), dt, struct.pack("<B", arr.ndim),
                    struct.pack(f"<{arr.ndim}I", *arr.shape), struct.pack("<I", n_pages)]
            for p in range(n_pages):
                chunk = _bytes_of(arr[:, p * ps:(p + 1) * ps])
                out += [struct.pack("<II", len(chunk), zlib.crc32(chunk) & 0xFFFFFFFF), chunk]
    body = b"".join(out)
    return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)


def unpack_slot_state(buf: bytes) -> dict:
    """Parse and verify a ``pack_slot_state`` payload (reference:
    ``unpack_slot_state``; a payload of either package). Raises
    ``HandoffError`` on torn framing, an unknown dtype, a page's crc
    mismatch (``.key`` / ``.page`` name the damage) or the trailer's: it
    never returns unverified rows. Arrays come back as host tensors."""
    try:
        pos = [0]

        def take(n):
            a, b = pos[0], pos[0] + n
            if b > len(buf):
                raise HandoffError("torn handoff payload: truncated frame")
            pos[0] = b
            return buf[a:b]

        if take(4) != _HANDOFF_MAGIC:
            raise HandoffError("not a slot-state handoff payload (bad magic)")
        n_entries, ps = struct.unpack("<II", take(8))
        states = {}
        for _ in range(n_entries):
            klen, = struct.unpack("<H", take(2))
            key = take(klen).decode()
            length, stacked = struct.unpack("<IB", take(5))
            st = {"length": int(length), "stacked": bool(stacked)}
            for name in _HANDOFF_ARRAYS:
                dlen, = struct.unpack("<H", take(2))
                dtype = _wire_dtype(take(dlen).decode())
                ndim, = struct.unpack("<B", take(1))
                shape = struct.unpack(f"<{ndim}I", take(4 * ndim))
                n_pages, = struct.unpack("<I", take(4))
                arr = _zeros(shape, dtype, None)
                rows = shape[1] if ndim > 1 else 0
                row_elems = int(np.prod(shape[2:], dtype=np.int64))
                for p in range(n_pages):
                    nbytes, crc = struct.unpack("<II", take(8))
                    chunk = take(nbytes)
                    if (zlib.crc32(chunk) & 0xFFFFFFFF) != crc:
                        raise HandoffError(f"handoff page checksum mismatch: {key}.{name} page {p}",
                                           key=key, page=p)
                    a, b = p * ps, min((p + 1) * ps, rows)
                    want = shape[0] * (b - a) * row_elems * arr.element_size()
                    if nbytes != want:
                        raise HandoffError(f"torn handoff payload: {key}.{name} page {p} holds "
                                           f"{nbytes} bytes, its rows {want}")
                    if nbytes:
                        rows_u8 = arr.reshape(shape[0], rows, row_elems).view(torch.uint8)
                        rows_u8[:, a:b] = torch.frombuffer(bytearray(chunk), dtype=torch.uint8
                                                           ).reshape(shape[0], b - a, -1)
                st[name] = arr
            states[key] = st
        trailer, = struct.unpack("<I", take(4))
        if (zlib.crc32(buf[:pos[0] - 4]) & 0xFFFFFFFF) != trailer:
            raise HandoffError("handoff payload checksum mismatch (corrupted framing)")
        if pos[0] != len(buf):
            raise HandoffError("torn handoff payload: trailing bytes")
        return states
    except HandoffError:
        raise
    except Exception as e:  # struct.error, shape and reshape mismatches
        raise HandoffError(f"torn handoff payload: {e}") from None
