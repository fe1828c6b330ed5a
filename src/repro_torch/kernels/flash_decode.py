"""Fused-RoPE GQA flash decode over the tiered KV cache (reference:
``repro/kernels/flash_decode.py::_flash_gqa_fused`` through
``flash_decode_attention(k_new=..., rope_theta=...)``).

q (b, h, d) and the pending token's k (b, g, d) arrive UNROTATED; both
rotate at position ``cache.lengths[b]``. Each slot attends over its hot
tier, then its cold tier, then — when ``active`` — the pending (k, v) as
the last element. The cache is the PRE-append state; the call returns
``(o, k_rot)`` and the caller appends. The CUDA kernel is
``csrc/flash_decode.cu``; ``flash_decode_fused_plain`` is the plain
PyTorch version (it repeats the kernel's arithmetic — the same 32-key tiles, halving-tree
sums and separately rounded products — so the two agree bit for bit, which
keeps greedy tokens of the kernel and plain runs equal at full width).

``flash_decode_attention_latent`` is the MLA absorbed form (reference:
``_flash_latent`` through ``flash_decode_attention_latent``): q (b, h, D)
over the POST-append latent cache, whose k-slot rows (c_kv ‖ k_rope) also
give the values (their first ``value_dim`` dims); CUDA kernel
``csrc/flash_latent.cu``, plain version ``flash_decode_latent_plain`` in
the same reproducible arithmetic.

Only these two forms are ported: the reference's ring, paged and fp8
forms and the unfused ``_flash_gqa`` raise here.
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
MAX_REP = 8
HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's instantiations
LATENT_KERNEL = CudaKernel(
    "flash_latent", "flash_decode_latent",
    [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_void_p],
)
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
    """Rows [start, start + TILE) of ``t`` along ``dim``, zero-padded to TILE."""
    part = t.narrow(dim, start, min(TILE, t.shape[dim] - start))
    if part.shape[dim] == TILE:
        return part
    pad = list(part.shape)
    pad[dim] = TILE - part.shape[dim]
    return torch.cat([part, part.new_zeros(pad)], dim=dim)


def fold_tile(state, logits, valid, v):
    """One key tile of the online softmax in the kernels' arithmetic.

    state: (m, l, acc) with shapes (...), (...), (..., dv); logits (..., J)
    f32; valid broadcastable to logits; v (..., J, dv) f32, zero at
    invalid keys. Every product and sum is rounded on its own."""
    m, l, acc = state
    m_new = torch.maximum(m, torch.where(valid, logits, NEG_INF).amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.where(valid, torch.exp(logits - m_new[..., None]), 0.0)
    l = l * alpha + tree_sum(p, -1)
    acc = acc * alpha[..., None] + tree_sum(p[..., None] * v, -2)
    return m_new, l, acc


def flash_decode_fused_plain(q, cache: kvc.TieredKVCache, k_new, v_new,
                             active, scale: float, theta: float):
    """Plain version, in the kernel's arithmetic: rotate q and k_new at
    ``lengths`` (in f32), then fold the hot tier's and the cold tier's
    32-key tiles and, for active slots, the pending token."""
    b, h, d = q.shape
    g = k_new.shape[1]
    rep = h // g
    pos = cache.lengths.long()[:, None]  # (b, 1)
    q_rot = apply_rope(q.float()[:, None], pos, theta)[:, 0]
    k_rot = apply_rope(k_new.float()[:, None], pos, theta)[:, 0]  # (b, g, d) f32
    qg = q_rot.reshape(b, g, rep, 1, d)
    lengths = cache.lengths.long()
    state = (q.new_full((b, g, rep), NEG_INF, dtype=torch.float32),
             q.new_zeros((b, g, rep), dtype=torch.float32),
             q.new_zeros((b, g, rep, d), dtype=torch.float32))
    tiers = ((cache.hot_k, cache.hot_v, lengths.clamp(max=cache.hot_cap)),
             (cache.cold_k, cache.cold_v, (lengths - cache.hot_cap).clamp(0, cache.cold_cap)))
    keys = torch.arange(TILE, device=q.device)
    for kt, vt, n_valid in tiers:
        for start in range(0, kt.shape[1], TILE):
            valid = (start + keys)[None] < n_valid[:, None]  # (b, TILE)
            k_t = tile_of(kt, start).float().permute(0, 2, 1, 3)[:, :, None]  # (b, g, 1, T, d)
            v_t = torch.where(valid[:, :, None, None], tile_of(vt, start).float(), 0.0)
            logits = tree_sum(qg * k_t, -1) * scale  # (b, g, rep, T)
            state = fold_tile(state, logits, valid[:, None, None, :],
                              v_t.permute(0, 2, 1, 3)[:, :, None])
    act = (torch.ones(b, dtype=torch.bool, device=q.device) if active is None
           else active.bool())
    logit = tree_sum(qg[:, :, :, 0] * k_rot[:, :, None], -1) * scale  # (b, g, rep)
    v_p = torch.where(act[:, None, None], v_new.float(), 0.0)[:, :, None, None]
    _, l, acc = fold_tile(state, logit[..., None], act[:, None, None, None], v_p)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype), k_rot.to(k_new.dtype)


def _launch(q, cache, k_new, v_new, active, scale, theta):
    b, h, d = q.shape
    g = k_new.shape[1]
    rep = h // g
    tensors = (q, cache.hot_k, cache.hot_v, cache.cold_k, cache.cold_v, k_new, v_new)
    if not all(t.is_cuda for t in tensors + (cache.lengths,)):
        raise ValueError("flash_decode_attention: all operands must be CUDA tensors")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != q.dtype for t in tensors):
        raise TypeError("flash_decode_attention: q, tiers and k/v_new must share "
                        "one dtype, f32 or bf16 (fp8 tiers are not ported)")
    if rep * g != h or rep > MAX_REP or d not in HEAD_DIMS:
        raise ValueError(f"flash_decode_attention: h={h}, g={g}, d={d} unsupported "
                         f"(rep <= {MAX_REP}, d in {HEAD_DIMS})")
    for name, t, cap in (("hot", cache.hot_k, cache.hot_cap),
                         ("cold", cache.cold_k, cache.cold_cap)):
        if t.shape != (b, cap, g, d):
            raise ValueError(f"flash_decode_attention: {name} tier {tuple(t.shape)} "
                             f"!= {(b, cap, g, d)}")
    if v_new.shape != (b, g, d) or cache.hot_v.shape != cache.hot_k.shape or (
            cache.cold_v.shape != cache.cold_k.shape):
        raise ValueError("flash_decode_attention: v shapes must match k shapes")
    lengths = cache.lengths.to(torch.int32).contiguous()
    act = (torch.ones(b, dtype=torch.int32, device=q.device) if active is None
           else active.to(torch.int32).contiguous())
    cos, sin = rope_cos_sin(lengths.long()[:, None], d, theta)  # (b, 1, d/2)
    cos, sin = cos[:, 0].contiguous(), sin[:, 0].contiguous()
    tensors = tuple(t.contiguous() for t in tensors)
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    k_rot = torch.empty((b, g, d), dtype=k_new.dtype, device=q.device)
    if b == 0:
        return out, k_rot
    KERNEL.launch(
        int(q.dtype == torch.bfloat16), *(ptr(t) for t in tensors), ptr(lengths),
        ptr(act), ptr(cos), ptr(sin), ptr(out), ptr(k_rot),
        b, g, rep, d, cache.hot_cap, cache.cold_cap, float(scale), stream_of(q),
    )
    return out, k_rot


def flash_decode_attention(
    q: torch.Tensor,  # (b, h, d) — UNROTATED
    cache: kvc.TieredKVCache,  # PRE-append state
    scale: Optional[float] = None,
    *,
    k_new: Optional[torch.Tensor] = None,  # (b, g, d) — UNROTATED pending token
    v_new: Optional[torch.Tensor] = None,  # (b, g, d)
    active: Optional[torch.Tensor] = None,  # (b,) bool
    rope_theta: Optional[float] = None,
    impl: str = "auto",
):
    """Fused-RoPE one-token GQA attention -> ``(o (b, h, d), k_rot (b, g, d))``.

    ``impl="auto"`` launches the CUDA kernel for CUDA tensors and runs the
    plain version for CPU tensors; ``impl="plain"`` runs the plain version."""
    if k_new is None or v_new is None or rope_theta is None:
        raise NotImplementedError(
            "only the fused-RoPE form (k_new, v_new, rope_theta) is ported; "
            "use kv_cache.tiered_decode_attention on a post-append cache")
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if impl == "plain" or (impl == "auto" and not q.is_cuda):
        return flash_decode_fused_plain(q, cache, k_new, v_new, active, scale,
                                        float(rope_theta))
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}")
    return _launch(q, cache, k_new, v_new, active, scale, float(rope_theta))


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
            k_t = tile_of(buf, start).float()  # (b, TILE, D)
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
    if dt not in (torch.float32, torch.bfloat16) or cache.cold_k.dtype != dt:
        raise TypeError("flash_decode_attention_latent: the latent tiers must share one "
                        "dtype, f32 or bf16 (fp8 tiers are not ported)")
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
    LATENT_KERNEL.launch(
        int(dt == torch.bfloat16), ptr(q), ptr(hot), ptr(cold), ptr(lengths), ptr(out),
        b, h, cache.hot_cap, cache.cold_cap, d, value_dim, float(scale), stream_of(q),
    )
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
