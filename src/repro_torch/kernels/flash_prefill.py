"""Causal GQA flash prefill, fresh or over a live tiered cache (reference:
``repro/kernels/flash_prefill.py::_flash_prefill`` through
``flash_prefill_attention(emit_kv=True)``).

q (b, s, h, d), k and v (b, s, g, d) arrive UNROTATED. Returns ``(o,
k_cast, v_cast)``: the causal attention output and the rows' rotated k and
their v in the input dtype, with rows at or past ``valid[b]`` zeroed.

- Fresh form (``cache=None``, entry point ``flash_prefill_fresh``): RoPE
  at positions 0..s-1; ``kv_cache.fill_fresh`` places the emitted rows.
- Chunked form (``cache`` given, entry point ``flash_prefill_chunk``): a
  chunk of s rows per slot continues the slot's cached prefix. Row t
  rotates at ``cache.lengths[b] + t`` and attends over the slot's key
  sequence [cached prefix ‖ chunk]: the tier rows (already rotated, in the
  tier dtype), then the chunk's own causal keys among its first
  ``valid[b]``; ``kv_cache.append(valid=)`` places the emitted rows. Slots
  with ``valid = 0`` ride along: they attend over their tiers and emit
  zeros.
- Paged chunked form (``cache`` a ``PagedKVCache``, entry point
  ``flash_prefill_chunk_paged``, kernel ``gqa_chunk_paged_kernel``, counter
  ``CHUNK_PAGED_KERNEL``): the same, with cold row r of slot b at pool row
  ``page_table[b, r // ps] * ps + r % ps``, resolved per row; the tiles
  and sums are the chunked form's, so paging is invisible in the result.

The CUDA kernels are in ``csrc/flash_prefill.cuh`` (entry points in
``csrc/flash_prefill.cu``, the sliding-window forms' in
``flash_prefill_swa.cu``); ``flash_prefill_plain``
is the plain PyTorch version of every form. It repeats the kernels'
arithmetic (32-key tiles, tiles with no key of the slot skipped,
halving-tree sums, separately rounded products), so the two agree bit for
bit. The chunked forms tile the key sequence at absolute positions (tile i
holds positions 32 i .. 32 i + 31, from the tiers below the offset and
from the chunk above it), so every tile is the fresh form's: a prompt
streamed in f32 chunks of any size, or resumed mid-tile after a shared
prefix, gives the fresh form's output bit for bit. (The reference folds
the tiers' tiles and the chunk's apart; that is the same fold when the
offsets are multiples of 32, and within TOL otherwise.)

The MLA form (``rope_dims`` < the key width, ``emit_kv=False``; the
reference's call in ``models/attention.py::mla_prefill``) has its own
entry point, launch count and kernel (``mla_prefill_kernel``, the same
block body as the GQA forms): g = h (rep 1), keys of width dk whose
trailing ``rope_dims`` rotate, values of another width dv, and only ``o``
(b, s, h, dv) returned. It is fresh only, as in the reference, which
never chunks MLA.

Sliding-window forms (the reference's ``window`` and ``ring`` arguments):
a row at position P sees the keys P - window < p <= P, and key tiles that
lie wholly before every row's window are skipped (a skipped tile and a
folded fully masked one leave the state as it was). The fresh form with a
window has its own entry point and kernel (``flash_prefill_window``,
``gqa_window_kernel``, counter ``WINDOW_KERNEL``); the chunked form over a
ring cold tier too (``flash_prefill_chunk_ring``, ``gqa_chunk_ring_kernel``,
counter ``CHUNK_RING_KERNEL``): cold position p is held at ring row (p -
hot_cap) % cold_cap while p >= offset - cold_cap (the reference's
``ring_slot_positions`` at hot_cap = 0) and is no key once evicted. The
chunked form still folds absolute tiles, so a prompt admitted in chunks
over the ring gives the fresh windowed form's output bit for bit.

fp8 (e4m3) tiers (``BitNetConfig.kv_fp8``): every GQA form emits k_cast /
v_cast in the tier dtype, ``kv_dtype`` (default the cache's, else the
input's), as the reference does: each row rounds to the input dtype, then
through the reference's fp8 cast (``kv_cache.to_tier``; round to nearest
even, NaN past 464). The chunked forms (contiguous, paged, ring) read fp8
tiers, upcast exactly to f32. A GQA form with fp8 tiers or an fp8 emit is
an entry point of ``csrc/flash_prefill_fp8.cu`` with a counter of its own
(``FP8_KERNEL``, ``FP8_CHUNK_KERNEL``, ``FP8_CHUNK_PAGED_KERNEL``,
``FP8_WINDOW_KERNEL``, ``FP8_CHUNK_RING_KERNEL``); the kernels' emit
rounds by hand (``to_e4m3`` in ``csrc/fp8.cuh``), bit for bit with
``to_tier``. Tiers and emit share one dtype: the input's or fp8. The MLA
form emits nothing and takes no tiers.

Not ported, and raising here: a window or ring over a paged cache (the
reference has neither).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import kv_cache as kvc
from repro_torch.core.kv_cache import NEG_INF
from repro_torch.kernels.flash_decode import TILE, fold_tile, tier_rows, tree_sum
from repro_torch.kernels.build import CudaKernel, ptr, stream_of
from repro_torch.models.layers import apply_rope, rope_cos_sin

KERNEL = CudaKernel(
    "flash_prefill", "flash_prefill_fresh",
    [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_void_p],
)
CHUNK_KERNEL = CudaKernel(
    "flash_prefill", "flash_prefill_chunk",
    [ctypes.c_int] + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
)
WINDOW_KERNEL = CudaKernel(
    "flash_prefill_swa", "flash_prefill_window",
    [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_void_p],
)
CHUNK_RING_KERNEL = CudaKernel(
    "flash_prefill_swa", "flash_prefill_chunk_ring",
    [ctypes.c_int] + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_void_p],
)
CHUNK_PAGED_KERNEL = CudaKernel(
    "flash_prefill", "flash_prefill_chunk_paged",
    [ctypes.c_int] + [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_void_p],
)
MLA_KERNEL = CudaKernel(
    "flash_prefill", "flash_prefill_mla",
    [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_void_p],
)
# the fp8 forms (fp8 tiers and emit): the same arguments, entry points of their own
FP8_KERNEL = CudaKernel("flash_prefill_fp8", "flash_prefill_fresh_fp8", KERNEL.argtypes)
FP8_CHUNK_KERNEL = CudaKernel("flash_prefill_fp8", "flash_prefill_chunk_fp8",
                              CHUNK_KERNEL.argtypes)
FP8_CHUNK_PAGED_KERNEL = CudaKernel("flash_prefill_fp8", "flash_prefill_chunk_paged_fp8",
                                    CHUNK_PAGED_KERNEL.argtypes)
FP8_WINDOW_KERNEL = CudaKernel("flash_prefill_fp8", "flash_prefill_window_fp8",
                               WINDOW_KERNEL.argtypes)
FP8_CHUNK_RING_KERNEL = CudaKernel("flash_prefill_fp8", "flash_prefill_chunk_ring_fp8",
                                   CHUNK_RING_KERNEL.argtypes)
MAX_REP = 32
HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's instantiations
# (key width, value width, rotated dims) of the MLA form's instantiations:
# DeepSeek-V3 and its smoke config
MLA_DIMS = ((192, 128, 64), (24, 16, 8))


def rope_trailing(x: torch.Tensor, positions: torch.Tensor, rope_dims: int,
                  theta: float) -> torch.Tensor:
    """Rotate the trailing ``rope_dims`` dims of x (..., T, H, D) at
    ``positions`` (..., T); the rest passes through."""
    d = x.shape[-1]
    if rope_dims == d:
        return apply_rope(x, positions, theta)
    rot = apply_rope(x[..., d - rope_dims:], positions, theta)
    return torch.cat([x[..., : d - rope_dims], rot], dim=-1)


PLAIN_ROWS = 256  # query rows per pass of the plain version (rows are independent)


def flash_prefill_plain(q, k_new, v_new, valid, scale: float, theta: float,
                        rope_dims: Optional[int] = None, cache=None, window: int = 0,
                        ring: bool = False, kv_dtype=None):
    """Plain version of every form, in the kernels' arithmetic: rotate q
    and k (the trailing ``rope_dims``, default all, in f32) at the slot's
    offset (``cache.lengths``, 0 without a cache) and fold the 32-key tiles
    of the slot's key sequence under the causal, valid and window masks,
    skipping a tile that holds no key any of the rows sees; emit the
    rotated k / v zeroed at rows past ``valid``, in the input dtype and
    then in ``kv_dtype`` (default the input's) through ``to_tier``.
    Without a cache the sequence is the chunk's own keys; with one it is [cached prefix ‖
    chunk], tiled at ABSOLUTE positions (tile i holds positions 32 i .. 32
    i + 31, whichever tier or the chunk each comes from), so a prompt
    streamed in chunks folds exactly the fresh form's tiles, whatever the
    offsets. ``ring``: a cold position p is held at row (p - hot_cap) %
    cold_cap while p >= offset - cold_cap, and is no key once evicted.
    ``window`` > 0: row at position P sees keys P - window < p <= P.
    Rows are independent, so they are folded in passes of ``PLAIN_ROWS``."""
    b, s, h, d = q.shape
    g, dv = k_new.shape[2], v_new.shape[-1]
    rep = h // g
    dev = q.device
    offset = (cache.lengths.long() if cache is not None
              else torch.zeros((b,), dtype=torch.long, device=dev))
    tok = torch.arange(s, device=dev)
    pos = offset[:, None] + tok[None]  # (b, s)
    q_rot = rope_trailing(q.float(), pos, rope_dims or d, theta)
    k_rot = rope_trailing(k_new.float(), pos, rope_dims or d, theta)  # (b, s, g, d) f32
    qg_all = q_rot.reshape(b, s, g, rep, d).permute(0, 2, 3, 1, 4)[..., None, :]  # (b, g, rep, s, 1, d)
    keys = torch.arange(TILE, device=dev)
    slots = torch.arange(b, device=dev)[:, None]
    nv = valid.long().clamp(max=s)
    end = offset + nv  # one past the slot's last key

    def tile_keys(start):
        """Keys at positions start .. start + 31 of every slot: k (b, T, g, d)
        and v (b, T, g, dv) f32, v zero where no key exists, and exists (b,
        T). Tier rows are rotated already, in the tier dtype; chunk rows are
        k_rot / v_new; a tile may hold both."""
        kpos = start + keys  # (TILE,)
        chunk_i = (kpos[None] - offset[:, None]).clamp(0, s - 1)  # (b, TILE)
        k_t, v_t = k_rot[slots, chunk_i], v_new[slots, chunk_i].float()
        exists = kpos[None] < end[:, None]  # (b, TILE)
        if cache is not None:
            tier = kpos[None] < offset[:, None]
            hot = kpos[None] < offset.clamp(max=cache.hot_cap)[:, None]
            cold = tier & ~hot
            if ring:  # rows still held by the ring: the last cold_cap positions
                cold = cold & (kpos[None] >= (offset - cache.cold_cap)[:, None])
                exists = exists & (cold | hot | ~tier)
                rel_cold = torch.remainder(kpos - cache.hot_cap, max(cache.cold_cap, 1))
            else:
                rel_cold = kpos - cache.hot_cap
            for is_hot, sel, rel in ((False, cold, rel_cold), (True, hot, kpos)):
                if not bool(sel.any()):
                    continue
                rel = rel.clamp(0, (cache.hot_cap if is_hot else cache.cold_cap) - 1)
                tk, tv = tier_rows(cache, is_hot, rel)
                m = sel[:, :, None, None]
                k_t, v_t = torch.where(m, tk.float(), k_t), torch.where(m, tv.float(), v_t)
        v_t = torch.where(exists[:, :, None, None], v_t, 0.0)
        return kpos, k_t, v_t, exists

    outs = []
    for r0 in range(0, s, PLAIN_ROWS):
        qg = qg_all[:, :, :, r0:r0 + PLAIN_ROWS]
        rpos = pos[:, r0:r0 + PLAIN_ROWS]  # (b, R)
        n_r = rpos.shape[1]
        state = (q.new_full((b, g, rep, n_r), NEG_INF, dtype=torch.float32),
                 q.new_zeros((b, g, rep, n_r), dtype=torch.float32),
                 q.new_zeros((b, g, rep, n_r, dv), dtype=torch.float32))
        lo = max(int(rpos[:, 0].min()) - window + 1, 0) if window and b else 0
        hi = int(torch.minimum(rpos[:, -1] + 1, end).max()) if b else 0
        for start in range(lo - lo % TILE, hi, TILE):
            kpos, k_t, v_t, exists = tile_keys(start)
            ok = exists[:, None, :] & (kpos[None, None, :] <= rpos[:, :, None])  # (b, R, T)
            if window:
                ok = ok & (rpos[:, :, None] - kpos[None, None, :] < window)
            logits = tree_sum(qg * k_t.permute(0, 2, 1, 3)[:, :, None, None], -1) * scale
            new = fold_tile(state, logits, ok[:, None, None],
                            v_t.permute(0, 2, 1, 3)[:, :, None, None])
            live = ok.flatten(1).any(1)  # (b,): a row of the slot sees a key of the tile
            state = tuple(torch.where(live.reshape((b,) + (1,) * (o.ndim - 1)), n, o)
                          for n, o in zip(new, state))
        _, l, acc = state
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])  # (b, g, rep, R, dv)
    out = torch.cat(outs, dim=3) if outs else q.new_zeros((b, g, rep, 0, dv), dtype=torch.float32)
    o = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dv).to(q.dtype)
    keep = (tok[None] < nv[:, None])[:, :, None, None]
    kv_dtype = kv_dtype or k_new.dtype
    k_cast = kvc.to_tier(torch.where(keep, k_rot, 0.0).to(k_new.dtype), kv_dtype)
    v_cast = kvc.to_tier(torch.where(keep, v_new, torch.zeros_like(v_new)), kv_dtype)
    return o, k_cast, v_cast


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, copied when its data does not start on a 16-byte boundary
    (the kernels load and store 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k_new, v_new, valid, scale, theta, cache=None, window=0, ring=False,
            kv_dtype=None):
    """The GQA forms: fresh without ``cache``, chunked with it; the
    sliding-window forms when ``window`` or ``ring`` is set; the fp8 forms
    when the emit dtype ``kv_dtype`` (that of the tiers) is fp8."""
    b, s, h, d = q.shape
    g = k_new.shape[2]
    rep = h // g
    tiers = () if cache is None else tuple(cache[:4])  # hot k / v, cold k / v or the pools
    extra = () if cache is None else tiers + (cache.lengths,)
    if not all(t.is_cuda for t in (q, k_new, v_new, valid) + extra):
        raise ValueError("flash_prefill_attention: all operands must be CUDA tensors")
    fp8 = kv_dtype == kvc.FP8
    if (q.dtype not in (torch.float32, torch.bfloat16) or kv_dtype not in (q.dtype, kvc.FP8)
            or any(t.dtype != q.dtype for t in (k_new, v_new))
            or any(t.dtype != kv_dtype for t in tiers)):
        raise TypeError("flash_prefill_attention: q, k and v must share one dtype, f32 or "
                        "bf16, and the tiers and the emit that dtype or fp8 (e4m3)")
    if rep * g != h or rep > MAX_REP or d not in HEAD_DIMS:
        raise ValueError(f"flash_prefill_attention: h={h}, g={g}, d={d} unsupported "
                         f"(rep <= {MAX_REP}, d in {HEAD_DIMS})")
    if k_new.shape != (b, s, g, d) or v_new.shape != (b, s, g, d) or valid.shape != (b,):
        raise ValueError("flash_prefill_attention: k/v must be (b, s, g, d), valid (b,)")
    q, k_new, v_new = (_aligned(t.contiguous()) for t in (q, k_new, v_new))
    valid = valid.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    k_cast = torch.empty_like(k_new, dtype=kv_dtype)
    v_cast = torch.empty_like(v_new, dtype=kv_dtype)
    if b == 0 or s == 0:
        return o, k_cast, v_cast
    bf16 = int(q.dtype == torch.bfloat16)
    if cache is None:
        cos, sin = rope_cos_sin(torch.arange(s, device=q.device), d, theta)  # (s, d/2)
        args = (bf16, ptr(q), ptr(k_new), ptr(v_new), ptr(valid), ptr(cos), ptr(sin), ptr(o),
                ptr(k_cast), ptr(v_cast), b, s, g, rep, d)
        if window:
            (FP8_WINDOW_KERNEL if fp8 else WINDOW_KERNEL).launch(*args, window, float(scale),
                                                                 stream_of(q))
        else:
            (FP8_KERNEL if fp8 else KERNEL).launch(*args, float(scale), stream_of(q))
        return o, k_cast, v_cast
    paged = isinstance(cache, kvc.PagedKVCache)
    cold_shape = (cache.n_pages, cache.page_size, g, d) if paged else (b, cache.cold_cap, g, d)
    for name, t, shape in (("hot", tiers[0], (b, cache.hot_cap, g, d)), ("cold", tiers[2], cold_shape)):
        if t.shape != shape:
            raise ValueError(f"flash_prefill_attention: {name} tier {tuple(t.shape)} != {shape}")
    if tiers[1].shape != tiers[0].shape or tiers[3].shape != tiers[2].shape:
        raise ValueError("flash_prefill_attention: v tiers must match the k tiers")
    tiers = tuple(_aligned(t.contiguous()) for t in tiers)
    lengths = cache.lengths.to(torch.int32).contiguous()
    # per-slot tables at the rows' absolute positions: the plain version's
    # own expression (apply_rope at lengths + t)
    pos = lengths.long()[:, None] + torch.arange(s, device=q.device)[None]
    cos, sin = rope_cos_sin(pos, d, theta)  # (b, s, d/2)
    if paged:
        if cache.page_table.shape != (b, cache.pages_per_slot) or not cache.page_table.is_cuda:
            raise ValueError(f"flash_prefill_attention: page table "
                             f"{tuple(cache.page_table.shape)} != {(b, cache.pages_per_slot)} "
                             "on the card")
        table = cache.page_table.to(torch.int32).contiguous()
        (FP8_CHUNK_PAGED_KERNEL if fp8 else CHUNK_PAGED_KERNEL).launch(
            bf16, ptr(q), ptr(k_new), ptr(v_new), ptr(valid), ptr(cos), ptr(sin),
            ptr(o), ptr(k_cast), ptr(v_cast), *(ptr(t) for t in tiers), ptr(lengths),
            ptr(table), b, s, g, rep, d, cache.hot_cap, cache.page_size, cache.pages_per_slot,
            float(scale), stream_of(q),
        )
        return o, k_cast, v_cast
    args = (bf16, ptr(q), ptr(k_new), ptr(v_new), ptr(valid), ptr(cos), ptr(sin),
            ptr(o), ptr(k_cast), ptr(v_cast), *(ptr(t) for t in tiers),
            ptr(lengths), b, s, g, rep, d, cache.hot_cap, cache.cold_cap)
    if window or ring:
        (FP8_CHUNK_RING_KERNEL if fp8 else CHUNK_RING_KERNEL).launch(
            *args, window, int(ring), float(scale), stream_of(q))
    else:
        (FP8_CHUNK_KERNEL if fp8 else CHUNK_KERNEL).launch(*args, float(scale), stream_of(q))
    return o, k_cast, v_cast


def _launch_mla(q, k_new, v_new, valid, scale, theta, rope_dims):
    b, s, h, d = q.shape
    dv = v_new.shape[-1]
    if not (q.is_cuda and k_new.is_cuda and v_new.is_cuda and valid.is_cuda):
        raise ValueError("flash_prefill_attention: all operands must be CUDA tensors")
    if q.dtype not in (torch.float32, torch.bfloat16) or k_new.dtype != q.dtype or (
            v_new.dtype != q.dtype):
        raise TypeError("flash_prefill_attention: q, k, v must share one dtype, f32 or bf16")
    if ((d, dv, rope_dims) not in MLA_DIMS or k_new.shape != (b, s, h, d)
            or v_new.shape != (b, s, h, dv)):
        raise ValueError(f"flash_prefill_attention (MLA form): q {tuple(q.shape)}, k "
                         f"{tuple(k_new.shape)}, v {tuple(v_new.shape)}, rope_dims {rope_dims} "
                         f"unsupported (g = h, (dk, dv, rope_dims) in {MLA_DIMS})")
    if valid.shape != (b,):
        raise ValueError("flash_prefill_attention: valid must be (b,)")
    q, k_new, v_new = (_aligned(t.contiguous()) for t in (q, k_new, v_new))
    valid = valid.to(torch.int32).contiguous()
    cos, sin = rope_cos_sin(torch.arange(s, device=q.device), rope_dims, theta)
    cos, sin = cos.contiguous(), sin.contiguous()
    o = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    MLA_KERNEL.launch(
        int(q.dtype == torch.bfloat16), ptr(q), ptr(k_new), ptr(v_new), ptr(valid),
        ptr(cos), ptr(sin), ptr(o), b, s, h, d, dv, rope_dims, float(scale), stream_of(q),
    )
    return o


def flash_prefill_attention(
    q: torch.Tensor,  # (b, s, h, d) — UNROTATED
    k_new: torch.Tensor,  # (b, s, g, d) — UNROTATED
    v_new: torch.Tensor,  # (b, s, g, d)
    cache=None,  # live TieredKVCache or PagedKVCache: the chunked form
    valid: Optional[torch.Tensor] = None,  # (b,) valid rows (default s)
    *,
    scale: Optional[float] = None,
    window: int = 0,
    ring: bool = False,
    rope_theta: float = 1_000_000.0,
    rope_dims: Optional[int] = None,  # None = whole head (GQA); MLA: rope dims
    emit_kv: bool = True,
    kv_dtype=None,
    impl: str = "auto",
):
    """Causal prefill, fresh (``cache=None``) or a chunk continuing each
    slot's cached prefix (``cache`` a ``TieredKVCache`` or a
    ``PagedKVCache``, the GQA form) ->
    ``(o, k_cast, v_cast)``, or ``o`` alone when ``emit_kv=False`` (the
    MLA form, fresh only, with ``rope_dims``).

    ``impl="auto"`` launches the CUDA kernel for CUDA tensors and runs the
    plain version for CPU tensors; ``impl="plain"`` runs the plain version."""
    if cache is not None and not isinstance(cache, (kvc.TieredKVCache, kvc.PagedKVCache)):
        raise TypeError(f"flash_prefill_attention: unknown cache type {type(cache).__name__}")
    kv_dtype = kv_dtype or (cache.hot_k.dtype if cache is not None else k_new.dtype)
    if kv_dtype not in (k_new.dtype, kvc.FP8) or (cache is not None
                                                  and cache.hot_k.dtype != kv_dtype):
        raise NotImplementedError("the emitted k/v are in the input dtype or fp8 (e4m3), "
                                  "and in the tiers' dtype")
    b, s, _, d = q.shape
    mla = not emit_kv
    if mla != (rope_dims is not None and rope_dims < d):
        raise NotImplementedError(
            "ported forms: whole-head RoPE with emit_kv=True (GQA), or "
            "rope_dims < head with emit_kv=False (MLA)")
    if mla and cache is not None:
        raise NotImplementedError("the MLA form is fresh only (the reference never chunks MLA)")
    if (window or ring) and (mla or isinstance(cache, kvc.PagedKVCache)):
        raise NotImplementedError("a window or ring over a paged cache or in the MLA form "
                                  "(the reference has neither)")
    if window < 0:
        raise ValueError(f"flash_prefill_attention: window {window} < 0")
    ring = bool(ring) and cache is not None  # without a cache there is no ring to read
    scale = float(scale) if scale is not None else d ** -0.5
    if valid is None:
        valid = torch.full((b,), s, dtype=torch.int32, device=q.device)
    if impl == "plain" or (impl == "auto" and not q.is_cuda):
        out = flash_prefill_plain(q, k_new, v_new, valid, scale, float(rope_theta), rope_dims,
                                  cache, int(window), ring, kv_dtype)
        return out[0] if mla else out
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}")
    if mla:
        return _launch_mla(q, k_new, v_new, valid, scale, float(rope_theta), rope_dims)
    return _launch(q, k_new, v_new, valid, scale, float(rope_theta), cache, int(window), ring,
                   kv_dtype)
