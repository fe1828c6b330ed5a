"""GQA flash decode over the tiered KV cache (reference:
``repro/kernels/flash_decode.py``), in two forms of one CUDA kernel
template, ``csrc/flash_decode.cuh`` (entry points in ``csrc/flash_decode.cu``;
the paged and ring forms' in ``flash_decode_paged.cu`` and
``flash_decode_ring.cu``):

- fused RoPE (``_flash_gqa_fused`` through ``flash_decode_attention(
  k_new=..., rope_theta=...)``): q (b, h, d) and the pending token's k
  (b, g, d) arrive UNROTATED; both rotate at position ``cache.lengths[b]``.
  Its contiguous f32 / bf16 form also takes d 112 (``FUSED_HEAD_DIMS``),
  whose dot products are halving trees over 128 dims, the last 16 zero:
  ``tree_sum``'s own zero padding, so the plain version is unchanged.
  Each slot attends over its cached keys and — when ``active`` — the
  pending (k, v) at position ``lengths[b]``. The cache is the PRE-append
  state; the call returns ``(o, k_rot)`` and the caller appends. Plain
  version ``flash_decode_fused_plain``.
- post-append (``_flash_gqa`` through ``flash_decode_attention(q,
  cache)``): q is already rotated and the cache already holds the new
  token; returns ``o`` alone, zeros for a length-0 slot. Plain version
  ``flash_decode_plain``.

The plain versions repeat the kernel's arithmetic — the same 32-key
tiles, halving-tree sums and separately rounded products — so the two agree
bit for bit, which keeps greedy tokens of the kernel and plain runs equal
at full width. Both fold ABSOLUTE tiles (``fold_positions``): tile i holds
positions 32 i .. 32 i + 31, whichever tier each row comes from, and the
pending token sits at lane p % 32 of tile p // 32, inside that tile's max
and sums. That is the chunked prefill form's fold of a one-row chunk, so a
decoded row equals the prefill's row at its position bit for bit, and
recompute-from-prefix after a preemption gives the same greedy tokens.

``flash_decode_attention_latent`` is the MLA absorbed form (reference:
``_flash_latent`` through ``flash_decode_attention_latent``): q (b, h, D)
over the POST-append latent cache, whose k-slot rows (c_kv ‖ k_rope) also
give the values (their first ``value_dim`` dims); CUDA kernel
``csrc/flash_latent.cu``, plain version ``flash_decode_latent_plain`` in
the same reproducible arithmetic.

Both GQA forms also take a ``PagedKVCache`` (the reference's paged forms):
cold row r of slot b is pool row ``page_table[b, r // ps] * ps + r % ps``,
and the kernel (``gqa_decode_paged_kernel``, entry points
``flash_decode_gqa_fused_paged`` / ``flash_decode_gqa_paged``, counters
``PAGED_KERNEL`` / ``GQA_PAGED_KERNEL``) resolves that address per row. The
tiles and every sum stay those of the contiguous form (``tier_rows`` reads
a paged tier's rows through the table for the plain versions), so paging
is invisible in the result.

Ring form (the reference's ``_flash_gqa_fused(..., ring=True)`` through
``flash_decode_attention_ring``; entry point ``flash_decode_gqa_fused_ring``,
kernel ``gqa_decode_ring_kernel``, counter ``RING_KERNEL``): the cold tier
is the sliding-window ring of ``kv_cache.append_decode_ring``, where cold
position p sits at row ``(p - hot_cap) % cold_cap`` while the ring holds
it. It folds absolute tiles too (``fold_positions(..., ring=True)``),
over the positions the ring holds, with the pending token at its
position; over the pre-append
cache an active slot whose window has wrapped also leaves out its oldest
cold position (the evictee: the append that follows overwrites its row,
and it has left the window of the token being decoded), while an inactive
slot keeps every row, as the reference does. Tiles wholly before the window
are skipped, as the chunked ring form skips them, so at ``hot_cap`` 0
(every SWA cache the engine builds) a decoded row is the one-row ring
chunk's row bit for bit (``flash_prefill_plain(..., ring=True)`` at
``window = cold_cap``; an inactive slot's at ``valid`` 0 and no window),
and a speculative verify chunk over the ring gives the decode's rows.
Without ``k_new`` the ring entry point is the post-append form (kernel 6)
as it is: over a wrapped ring the length clip marks every row valid, as
the reference's clamp does.

fp8 (e4m3) tiers (``BitNetConfig.kv_fp8``; the reference upcasts each
fp8 tile to f32 in all three kernel functions): every form above also
takes tiers of ``kv_cache.FP8`` beside f32 or bf16 activations (q, k_new,
v_new, o and k_rot keep the activation dtype). The CUDA template reads
its tiers as a type of their own (``DecodeArgs<T, TT>``), and the fp8
forms are separate entry points of ``csrc/flash_decode_fp8.cu`` (the
paged ones of ``flash_decode_paged_fp8.cu``) with counters of their own
(``FP8_KERNEL``, ``FP8_GQA_KERNEL``, ``FP8_PAGED_KERNEL``,
``FP8_GQA_PAGED_KERNEL``, ``FP8_RING_KERNEL``; the latent form's
``LATENT_FP8_KERNEL`` in ``csrc/flash_latent.cu``). fp8 ->
f32 is exact, so the tiles, the sums and their order stay those of the
f32 forms, and the plain versions read an fp8 tier through the same
``.float()`` upcast.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import kv_cache as kvc
from repro_torch.core.kv_cache import NEG_INF
from repro_torch.kernels.build import CudaKernel, ptr, stream_of
from repro_torch.models.layers import apply_rope, rope_cos_sin

KERNEL = CudaKernel(
    "flash_decode", "flash_decode_gqa_fused",
    [ctypes.c_int] + [ctypes.c_void_p] * 13
    + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
)
GQA_KERNEL = CudaKernel(
    "flash_decode", "flash_decode_gqa",
    [ctypes.c_int] + [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
)
RING_KERNEL = CudaKernel(
    "flash_decode_ring", "flash_decode_gqa_fused_ring",
    [ctypes.c_int] + [ctypes.c_void_p] * 13
    + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
)
PAGED_KERNEL = CudaKernel(
    "flash_decode_paged", "flash_decode_gqa_fused_paged",
    [ctypes.c_int] + [ctypes.c_void_p] * 14
    + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p],
)
GQA_PAGED_KERNEL = CudaKernel(
    "flash_decode_paged", "flash_decode_gqa_paged",
    [ctypes.c_int] + [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p],
)
# the fp8-tier forms: the same arguments, entry points of their own
FP8_KERNEL = CudaKernel("flash_decode_fp8", "flash_decode_gqa_fused_fp8", KERNEL.argtypes)
FP8_GQA_KERNEL = CudaKernel("flash_decode_fp8", "flash_decode_gqa_fp8", GQA_KERNEL.argtypes)
FP8_RING_KERNEL = CudaKernel("flash_decode_fp8", "flash_decode_gqa_fused_ring_fp8",
                             RING_KERNEL.argtypes)
FP8_PAGED_KERNEL = CudaKernel("flash_decode_paged_fp8", "flash_decode_gqa_fused_paged_fp8",
                              PAGED_KERNEL.argtypes)
FP8_GQA_PAGED_KERNEL = CudaKernel("flash_decode_paged_fp8", "flash_decode_gqa_paged_fp8",
                                  GQA_PAGED_KERNEL.argtypes)
MAX_REP = 8
HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's instantiations
# and the fused contiguous form's (f32 and bf16 tiers): zamba2-7b's heads
# of 112, carried in a lane layout 128 wide (csrc/flash_decode.cuh)
FUSED_HEAD_DIMS = HEAD_DIMS + (112,)
LATENT_KERNEL = CudaKernel(
    "flash_latent", "flash_decode_latent",
    [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_void_p],
)
# fp8 latent tiers: the same arguments but the tier flag
LATENT_FP8_KERNEL = CudaKernel("flash_latent", "flash_decode_latent_fp8",
                               LATENT_KERNEL.argtypes[1:])
# (row width, value width) pairs of the latent kernel's instantiations:
# DeepSeek-V3 and its smoke config
LATENT_DIMS = ((576, 512), (24, 16))


TILE = 32  # keys per tile of the online softmax, as in the kernels


def tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Halving-tree sum along ``dim``: element i + n/2 is added to element
    i, level by level (the length is zero-padded to a power of two). The
    attention kernels sum in exactly this order, so the plain versions
    repeat them bit for bit."""
    dim = dim % x.ndim
    n = x.shape[dim]
    p2 = 1 << max(n - 1, 0).bit_length()
    if p2 != n:
        pad = list(x.shape)
        pad[dim] = p2 - n
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    while x.shape[dim] > 1:
        h = x.shape[dim] // 2
        x = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
    return x.squeeze(dim)


def tile_of(t: torch.Tensor, start: int, dim: int = 1) -> torch.Tensor:
    """Rows [start, start + TILE) of ``t`` along ``dim`` in f32 (exact for
    every tier dtype), zero-padded to TILE."""
    part = t.narrow(dim, start, min(TILE, t.shape[dim] - start)).float()
    if part.shape[dim] == TILE:
        return part
    pad = list(part.shape)
    pad[dim] = TILE - part.shape[dim]
    return torch.cat([part, part.new_zeros(pad)], dim=dim)


def tier_rows(cache, hot: bool, rel: torch.Tensor):
    """Rows ``rel`` of every slot's hot or cold tier, as k and v (b, n,
    ...): ``rel`` (n,) or (b, n) in-tier positions; a paged cold tier's rows
    are read through the page table one by one."""
    b = cache.lengths.shape[0]
    rel = rel.long()
    rel = rel[None].expand(b, -1) if rel.ndim == 1 else rel
    if hot or not isinstance(cache, kvc.PagedKVCache):
        kt, vt = (cache.hot_k, cache.hot_v) if hot else (cache.cold_k, cache.cold_v)
        slots = torch.arange(b, device=rel.device)[:, None]
        return kvc.rows_of(kt, slots, rel), kvc.rows_of(vt, slots, rel)
    rows = kvc.paged_cold_rows(cache, rel)  # (b, n)
    pk, pv = kvc.pool_flat(cache)
    return kvc.rows_of(pk, rows), kvc.rows_of(pv, rows)


def fold_tile(state, logits, valid, v):
    """One key tile of the online softmax in the kernels' arithmetic.

    state: (m, l, acc) with shapes (...), (...), (..., dv); logits (..., J)
    f32; valid broadcastable to logits; v (..., J, dv) f32, zero at
    invalid keys. Every product and sum is rounded on its own."""
    return fold_tiles(state, logits[..., None, :], valid[..., None, :], v[..., None, :, :])


FOLD_TILES = 32  # tiles whose products the plain decode forms at once


def fold_tiles(state, logits, valid, v):
    """``fold_tile`` over n consecutive tiles at once, with the same
    values: logits (..., n, J), valid broadcastable to them, v (..., n, J,
    dv). The running max is a cumulative max (exact), so every tile's
    products and sums are formed together; only l and acc chain from tile
    to tile, in order: m_t = max(m_{t-1}, max_j logit), alpha = exp(m_{t-1}
    - m_t), p = exp(logit - m_t), l = l alpha + sum p, acc = acc alpha +
    sum p v, each sum a halving tree."""
    m, l, acc = state
    tmax = torch.where(valid, logits, NEG_INF).amax(dim=-1)  # (..., n)
    ms = torch.cummax(torch.cat([m[..., None], tmax], dim=-1), dim=-1).values
    m_prev, m_new = ms[..., :-1], ms[..., 1:]
    alpha = torch.exp(m_prev - m_new)
    p = torch.where(valid, torch.exp(logits - m_new[..., None]), 0.0)
    p_sum, pv = tree_sum(p, -1), tree_sum(p[..., None] * v, -2)  # (..., n), (..., n, dv)
    for t in range(logits.shape[-2]):
        l = l * alpha[..., t] + p_sum[..., t]
        acc = acc * alpha[..., t, None] + pv[..., t, :]
    return m_new[..., -1], l, acc


def _fold_keys(state, qg, kt, vt, valid, scale):
    """Fold n consecutive 32-key tiles of keys kt / values vt (b, n T, g, d)
    under ``valid`` (b, n T) into ``state`` (``fold_tiles``)."""
    b, g, _, _, d = qg.shape
    n = kt.shape[1] // TILE
    vt = torch.where(valid[:, :, None, None], vt.float(), 0.0)

    def tiles(x):  # (b, n T, g, d) -> (b, g, 1, n, T, d)
        return x.float().reshape(b, n, TILE, g, d).permute(0, 3, 1, 2, 4)[:, :, None]

    logits = tree_sum(qg[:, :, :, :, None] * tiles(kt), -1) * scale  # (b, g, rep, n, T)
    return fold_tiles(state, logits, valid.reshape(b, n, TILE)[:, None, None], tiles(vt))


def fold_positions(qg: torch.Tensor, cache, scale: float, pending=None, ring: bool = False):
    """Online-softmax state after the slot's keys in ABSOLUTE 32-key tiles,
    as the chunked prefill forms fold them and in the kernel's walk
    (``decode_body``): tile i holds positions 32 i .. 32 i + 31; slot b's
    keys are the positions below n_hot[b] and those in [lo[b], n_keys[b]),
    position p < hot_cap from hot row p and the rest from cold row
    ``row(p)`` (through the page table when paged), so a tile may hold rows
    of both tiers. ``pending`` = (k (b, g, d), v (b, g, d) f32, active
    (b,)): an active slot's pending token is the key at position
    n_keys[b], inside its tile.

    Linear tiers: n_hot = lo = 0, n_keys = min(length, hot_cap +
    cold_cap), row(p) = p - hot_cap. Ring cold tier (``ring``): n_hot =
    min(length, hot_cap), lo = max(hot_cap, length - cold_cap + active)
    clipped to length, n_keys = length and row(p) = (p - hot_cap) %
    cold_cap, the ring row that holds p; an active slot's oldest held
    position is the evictee, which the coming append overwrites.

    Tiles holding no key of any slot are skipped, and one that holds none
    of a slot's keys leaves that slot's state as it was, as the chunked
    forms' tiles do (``flash_prefill_plain``), so a decoded row is the
    one-row chunk's row bit for bit. qg: (b, g, rep, 1, d) f32 (rotated)
    queries; returns (m, l, acc) of shapes (b, g, rep) and (b, g, rep,
    d)."""
    b, g, rep, _, d = qg.shape
    hc, cc = cache.hot_cap, cache.cold_cap
    length = cache.lengths.long()
    act = pending[2].long() if pending is not None else torch.zeros_like(length)
    if ring:
        n_hot = length.clamp(max=hc)
        lo = torch.minimum((length - cc + act).clamp(min=hc), length)
    else:
        length = length.clamp(max=hc + cc)
        n_hot = lo = torch.zeros_like(length)
    n_end = length + act
    state = (qg.new_full((b, g, rep), NEG_INF), qg.new_zeros((b, g, rep)),
             qg.new_zeros((b, g, rep, d)))
    n_tiles = -(-int(n_end.max()) // TILE) if b else 0
    t0 = torch.arange(n_tiles, device=qg.device) * TILE
    need = ((t0[None] < n_hot[:, None])
            | ((t0[None] + TILE > lo[:, None]) & (t0[None] < n_end[:, None]))).any(0)
    starts = t0[need]
    lanes = torch.arange(TILE, device=qg.device)
    for i in range(0, starts.shape[0], FOLD_TILES):
        pos = (starts[i:i + FOLD_TILES, None] + lanes).reshape(-1)  # (n T,)
        valid = (pos[None] < n_hot[:, None]) | ((pos[None] >= lo[:, None])
                                                & (pos[None] < length[:, None]))  # (b, n T)
        # rows past a tier repeat its last one: masked, as every invalid key
        rows = [(pos < hc, tier_rows(cache, True, pos.clamp(max=hc - 1)))] if hc else []
        if cc:
            row = torch.remainder(pos - hc, cc) if ring else pos - hc
            rows.append((pos >= hc, tier_rows(cache, False, row.clamp(0, cc - 1))))
        kt, vt = (x.float() for x in rows[-1][1])  # (b, n T, g, d)
        if len(rows) == 2:
            sel = rows[0][0][None, :, None, None]
            kt = torch.where(sel, rows[0][1][0].float(), kt)
            vt = torch.where(sel, rows[0][1][1].float(), vt)
        if pending is not None:
            k_p, v_p, _ = pending
            at = act.bool()[:, None] & (pos[None] == length[:, None])  # (b, n T)
            kt = torch.where(at[:, :, None, None], k_p[:, None], kt)
            vt = torch.where(at[:, :, None, None], v_p[:, None], vt)
            valid = valid | at
        state = _fold_keys(state, qg, kt, vt, valid, scale)
    return state


def _finish(state):
    _, l, acc = state
    return acc / torch.clamp(l, min=1e-30)[..., None]


def flash_decode_plain(q, cache: kvc.TieredKVCache, scale: float):
    """Plain post-append version, in the kernel's arithmetic: fold the
    absolute tiles of the tiers (which already hold the new token) for the
    rotated q."""
    b, h, d = q.shape
    g = cache.hot_k.shape[2]
    qg = q.float().reshape(b, g, h // g, 1, d)
    return _finish(fold_positions(qg, cache, scale)).reshape(b, h, d).to(q.dtype)


def flash_decode_fused_plain(q, cache: kvc.TieredKVCache, k_new, v_new,
                             active, scale: float, theta: float, ring: bool = False):
    """Plain fused version, in the kernel's arithmetic: rotate q and k_new
    at ``lengths`` (in f32) and fold the absolute tiles with, for active
    slots, the pending token at its position (``fold_positions``; the ring
    form over the positions the ring holds)."""
    b, h, d = q.shape
    g = k_new.shape[1]
    pos = cache.lengths.long()[:, None]  # (b, 1)
    q_rot = apply_rope(q.float()[:, None], pos, theta)[:, 0]
    k_rot = apply_rope(k_new.float()[:, None], pos, theta)[:, 0]  # (b, g, d) f32
    qg = q_rot.reshape(b, g, h // g, 1, d)
    act = (torch.ones(b, dtype=torch.bool, device=q.device) if active is None
           else active.bool())
    state = fold_positions(qg, cache, scale, (k_rot, v_new.float(), act), ring=ring)
    return _finish(state).reshape(b, h, d).to(q.dtype), k_rot.to(k_new.dtype)


def _check_gqa(q, cache, extra=(), head_dims=HEAD_DIMS):
    """Operands the GQA kernel takes; raises on anything else. A paged
    cache passes its pools where the cold tiers go. ``head_dims``: the
    form's instantiations."""
    b, h, d = q.shape
    g = cache.hot_k.shape[2]
    rep = h // g
    paged = isinstance(cache, kvc.PagedKVCache)
    cold_k, cold_v = (cache.pool_k, cache.pool_v) if paged else (cache.cold_k, cache.cold_v)
    tensors = (q, cache.hot_k, cache.hot_v, cold_k, cold_v) + tuple(extra)
    if not all(t.is_cuda for t in tensors + (cache.lengths,)):
        raise ValueError("flash_decode_attention: all operands must be CUDA tensors")
    tier_dt = cache.hot_k.dtype
    if (q.dtype not in (torch.float32, torch.bfloat16) or tier_dt not in (q.dtype, kvc.FP8)
            or any(t.dtype != q.dtype for t in extra)
            or any(t.dtype != tier_dt for t in (cache.hot_v, cold_k, cold_v))):
        raise TypeError("flash_decode_attention: q and k/v_new must share one dtype, f32 or "
                        "bf16, and the four tiers that dtype or fp8 (e4m3)")
    if rep * g != h or rep > MAX_REP or d not in head_dims:
        raise ValueError(f"flash_decode_attention: h={h}, g={g}, d={d} unsupported "
                         f"(rep <= {MAX_REP}, d in {head_dims} for this form)")
    cold_shape = (cache.n_pages, cache.page_size, g, d) if paged else (b, cache.cold_cap, g, d)
    for name, t, shape in (("hot", cache.hot_k, (b, cache.hot_cap, g, d)),
                           ("cold", cold_k, cold_shape)):
        if t.shape != shape:
            raise ValueError(f"flash_decode_attention: {name} tier {tuple(t.shape)} != {shape}")
    if cache.hot_v.shape != cache.hot_k.shape or cold_v.shape != cold_k.shape:
        raise ValueError("flash_decode_attention: v shapes must match k shapes")
    if paged and (cache.page_table.shape != (b, cache.pages_per_slot)
                  or not cache.page_table.is_cuda):
        raise ValueError(f"flash_decode_attention: page table {tuple(cache.page_table.shape)} "
                         f"!= {(b, cache.pages_per_slot)} on the card")
    return tuple(t.contiguous() for t in tensors), cache.lengths.to(torch.int32).contiguous()


def _paged_args(cache):
    """The paged forms' trailing operands: (page table, ps, pps)."""
    table = cache.page_table.to(torch.int32).contiguous()
    return table, cache.page_size, cache.pages_per_slot


def _fp8(cache) -> bool:
    return cache.hot_k.dtype == kvc.FP8


def _launch(q, cache, k_new, v_new, active, scale, theta, ring=False):
    b, h, d = q.shape
    g = cache.hot_k.shape[2]
    if k_new.shape != (b, g, d) or v_new.shape != (b, g, d):
        raise ValueError(f"flash_decode_attention: k/v_new must be {(b, g, d)}")
    contiguous = not (ring or _fp8(cache) or isinstance(cache, kvc.PagedKVCache))
    tensors, lengths = _check_gqa(q, cache, (k_new, v_new),
                                  FUSED_HEAD_DIMS if contiguous else HEAD_DIMS)
    act = (torch.ones(b, dtype=torch.int32, device=q.device) if active is None
           else active.to(torch.int32).contiguous())
    cos, sin = rope_cos_sin(lengths.long()[:, None], d, theta)  # (b, 1, d/2)
    cos, sin = cos[:, 0].contiguous(), sin[:, 0].contiguous()
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    k_rot = torch.empty((b, g, d), dtype=k_new.dtype, device=q.device)
    if b == 0:
        return out, k_rot
    bf16 = int(q.dtype == torch.bfloat16)
    fp8 = _fp8(cache)
    if isinstance(cache, kvc.PagedKVCache):
        table, ps, pps = _paged_args(cache)
        (FP8_PAGED_KERNEL if fp8 else PAGED_KERNEL).launch(
            bf16, *(ptr(t) for t in tensors), ptr(lengths), ptr(act), ptr(cos), ptr(sin),
            ptr(out), ptr(k_rot), ptr(table), b, g, h // g, d, cache.hot_cap, ps, pps,
            float(scale), stream_of(q),
        )
        return out, k_rot
    kernel = (FP8_RING_KERNEL if fp8 else RING_KERNEL) if ring else (
        FP8_KERNEL if fp8 else KERNEL)
    kernel.launch(
        bf16, *(ptr(t) for t in tensors), ptr(lengths),
        ptr(act), ptr(cos), ptr(sin), ptr(out), ptr(k_rot),
        b, g, h // g, d, cache.hot_cap, cache.cold_cap, float(scale), stream_of(q),
    )
    return out, k_rot


def _launch_gqa(q, cache, scale):
    b, h, d = q.shape
    g = cache.hot_k.shape[2]
    tensors, lengths = _check_gqa(q, cache)
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if not out.numel():
        return out
    bf16 = int(q.dtype == torch.bfloat16)
    fp8 = _fp8(cache)
    if isinstance(cache, kvc.PagedKVCache):
        table, ps, pps = _paged_args(cache)
        (FP8_GQA_PAGED_KERNEL if fp8 else GQA_PAGED_KERNEL).launch(
            bf16, *(ptr(t) for t in tensors), ptr(lengths), ptr(out), ptr(table), b, g, h // g,
            d, cache.hot_cap, ps, pps, float(scale), stream_of(q),
        )
        return out
    (FP8_GQA_KERNEL if fp8 else GQA_KERNEL).launch(
        bf16, *(ptr(t) for t in tensors), ptr(lengths),
        ptr(out), b, g, h // g, d, cache.hot_cap, cache.cold_cap, float(scale),
        stream_of(q),
    )
    return out


def _decode_entry(q, cache, scale, k_new, v_new, active, rope_theta, impl, ring):
    if ring and isinstance(cache, kvc.PagedKVCache):
        raise NotImplementedError("a paged cache has no ring layout (as in the reference)")
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    plain = impl == "plain" or not q.is_cuda
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if k_new is None:
        if v_new is not None or active is not None or rope_theta is not None:
            raise ValueError("flash_decode_attention: v_new, active and rope_theta belong "
                             "to the fused form, which needs k_new")
        return flash_decode_plain(q, cache, scale) if plain else _launch_gqa(q, cache, scale)
    if v_new is None or rope_theta is None:
        raise ValueError("flash_decode_attention: the fused form needs k_new, v_new "
                         "and rope_theta")
    if plain:
        return flash_decode_fused_plain(q, cache, k_new, v_new, active, scale,
                                        float(rope_theta), ring)
    return _launch(q, cache, k_new, v_new, active, scale, float(rope_theta), ring)


def flash_decode_attention(
    q: torch.Tensor,  # (b, h, d) — UNROTATED with k_new, rotated without
    cache,  # TieredKVCache or PagedKVCache: PRE-append with k_new, POST-append without
    scale: Optional[float] = None,
    *,
    k_new: Optional[torch.Tensor] = None,  # (b, g, d) — UNROTATED pending token
    v_new: Optional[torch.Tensor] = None,  # (b, g, d)
    active: Optional[torch.Tensor] = None,  # (b,) bool
    rope_theta: Optional[float] = None,
    impl: str = "auto",
):
    """One-token GQA attention over the tiered cache.

    With ``k_new``: the fused-RoPE form -> ``(o (b, h, d), k_rot (b, g,
    d))``. Without: the post-append form -> ``o (b, h, d)``.
    ``impl="auto"`` launches the CUDA kernel for CUDA tensors and runs the
    plain version for CPU tensors; ``impl="plain"`` runs the plain version."""
    return _decode_entry(q, cache, scale, k_new, v_new, active, rope_theta, impl, False)


def flash_decode_attention_ring(
    q: torch.Tensor,
    cache: kvc.TieredKVCache,  # ring cold tier: PRE-append with k_new, POST-append without
    scale: Optional[float] = None,
    *,
    k_new: Optional[torch.Tensor] = None,
    v_new: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
    rope_theta: Optional[float] = None,
    impl: str = "auto",
):
    """GQA decode over a ring cold tier (sliding-window archs; reference:
    ``flash_decode_attention_ring``). The fused form (``k_new``) folds the
    positions the ring holds in absolute tiles, without the row the coming
    append evicts (``fold_positions``), and launches
    ``flash_decode_gqa_fused_ring``; the post-append form is
    ``flash_decode_attention``'s, since a wrapped ring is valid in every
    row."""
    return _decode_entry(q, cache, scale, k_new, v_new, active, rope_theta, impl, True)


# ---------------------------------------------------------------------------
# MLA absorbed form over the latent cache
# ---------------------------------------------------------------------------


def flash_decode_latent_plain(q, cache: kvc.TieredKVCache, value_dim: int, scale: float):
    """Plain version, in the kernel's arithmetic: fold the hot tier's and
    the cold tier's 32-key tiles; every head reads the one latent row
    stream, values are the rows' first ``value_dim`` dims."""
    b, h, _ = q.shape
    qf = q.float()[:, :, None, :]  # (b, h, 1, D)
    lengths = cache.lengths.long()
    state = (q.new_full((b, h), NEG_INF, dtype=torch.float32),
             q.new_zeros((b, h), dtype=torch.float32),
             q.new_zeros((b, h, value_dim), dtype=torch.float32))
    tiers = ((cache.hot_k, lengths.clamp(max=cache.hot_cap)),
             (cache.cold_k, (lengths - cache.hot_cap).clamp(0, cache.cold_cap)))
    keys = torch.arange(TILE, device=q.device)
    for buf, n_valid in tiers:
        for start in range(0, buf.shape[1], TILE):
            valid = (start + keys)[None] < n_valid[:, None]  # (b, TILE)
            k_t = tile_of(buf, start)  # (b, TILE, D) f32
            v_t = torch.where(valid[:, :, None], k_t[..., :value_dim], 0.0)
            logits = tree_sum(qf * k_t[:, None], -1) * scale  # (b, h, TILE)
            state = fold_tile(state, logits, valid[:, None, :], v_t[:, None])
    _, l, acc = state
    return acc / torch.clamp(l, min=1e-30)[..., None]


def _launch_latent(q, cache, value_dim, scale):
    b, h, d = q.shape
    if not all(t.is_cuda for t in (q, cache.hot_k, cache.cold_k, cache.lengths)):
        raise ValueError("flash_decode_attention_latent: all operands must be CUDA tensors")
    dt = cache.hot_k.dtype
    if dt not in (torch.float32, torch.bfloat16, kvc.FP8) or cache.cold_k.dtype != dt:
        raise TypeError("flash_decode_attention_latent: the latent tiers must share one "
                        "dtype, f32, bf16 or fp8 (e4m3)")
    if (d, value_dim) not in LATENT_DIMS:
        raise ValueError(f"flash_decode_attention_latent: D={d}, value_dim={value_dim} "
                         f"unsupported (one of {LATENT_DIMS})")
    for name, t, cap in (("hot", cache.hot_k, cache.hot_cap),
                         ("cold", cache.cold_k, cache.cold_cap)):
        if t.shape != (b, cap, d):
            raise ValueError(f"flash_decode_attention_latent: {name} tier "
                             f"{tuple(t.shape)} != {(b, cap, d)}")
    q = q.float().contiguous()
    hot, cold = cache.hot_k.contiguous(), cache.cold_k.contiguous()
    lengths = cache.lengths.to(torch.int32).contiguous()
    out = torch.empty((b, h, value_dim), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    args = (ptr(q), ptr(hot), ptr(cold), ptr(lengths), ptr(out),
            b, h, cache.hot_cap, cache.cold_cap, d, value_dim, float(scale), stream_of(q))
    if dt == kvc.FP8:
        LATENT_FP8_KERNEL.launch(*args)
    else:
        LATENT_KERNEL.launch(int(dt == torch.bfloat16), *args)
    return out


def flash_decode_attention_latent(
    q: torch.Tensor,  # (b, h, D) — D = latent + rope dims
    cache: kvc.TieredKVCache,  # POST-append latent cache, empty v-slot
    value_dim: int,
    scale: float,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """MLA absorbed-form attention -> the per-head latent context
    (b, h, value_dim) f32.

    ``impl="auto"`` launches the CUDA kernel for CUDA tensors and runs the
    plain version for CPU tensors; ``impl="plain"`` runs the plain version."""
    if impl == "plain" or (impl == "auto" and not q.is_cuda):
        return flash_decode_latent_plain(q, cache, value_dim, float(scale))
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}")
    return _launch_latent(q, cache, value_dim, float(scale))
