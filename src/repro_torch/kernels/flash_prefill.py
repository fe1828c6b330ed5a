"""Causal GQA flash prefill of a fresh prompt (reference:
``repro/kernels/flash_prefill.py::_flash_prefill`` through
``flash_prefill_attention(cache=None, emit_kv=True)``).

q (b, s, h, d), k and v (b, s, g, d) arrive UNROTATED; RoPE applies at
positions 0..s-1. Returns ``(o, k_cast, v_cast)``: the causal attention
output and the prompt's rotated k and its v in the tier dtype, with rows
at or past ``valid[b]`` zeroed — ready for ``kv_cache.fill_fresh``. The
CUDA kernel is ``csrc/flash_prefill.cu``; ``flash_prefill_fresh_plain``
is the plain PyTorch version; it repeats the kernel's arithmetic (32-key
tiles, halving-tree sums, separately rounded products), so the two agree
bit for bit.

The MLA form (``rope_dims`` < the key width, ``emit_kv=False``; the
reference's call in ``models/attention.py::mla_prefill``) has its own
entry point, launch count and kernel (``mla_prefill_kernel``, the same
block body as the GQA form's ``gqa_prefill_kernel``): g = h (rep 1), keys
of width dk whose trailing ``rope_dims`` rotate, values of another width
dv, and only ``o`` (b, s, h, dv) returned. The plain version serves both
forms.

Only the fresh form is ported: continuation over a live cache (chunked
prefill), SWA windows and rings and the paged cold tier raise here.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.kv_cache import NEG_INF
from repro_torch.kernels.flash_decode import TILE, fold_tile, tile_of, tree_sum
from repro_torch.kernels.build import CudaKernel, ptr, stream_of
from repro_torch.models.layers import apply_rope, rope_cos_sin

KERNEL = CudaKernel(
    "flash_prefill", "flash_prefill_fresh",
    [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_void_p],
)
MLA_KERNEL = CudaKernel(
    "flash_prefill", "flash_prefill_mla",
    [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_void_p],
)
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


def flash_prefill_fresh_plain(q, k_new, v_new, valid, scale: float, theta: float,
                              rope_dims: Optional[int] = None):
    """Plain version, in the kernel's arithmetic: rotate q and k (the
    trailing ``rope_dims``, default all, in f32), fold the prompt's 32-key
    tiles under the causal and valid masks, emit the rotated k / v zeroed
    at rows past ``valid``."""
    b, s, h, d = q.shape
    g, dv = k_new.shape[2], v_new.shape[-1]
    rep = h // g
    rd = rope_dims or d
    pos = torch.arange(s, device=q.device)[None]  # (1, s)
    q_rot = rope_trailing(q.float(), pos, rd, theta)
    k_rot = rope_trailing(k_new.float(), pos, rd, theta)  # (b, s, g, d) f32
    qg = q_rot.reshape(b, s, g, rep, d).permute(0, 2, 3, 1, 4)[..., None, :]  # (b, g, rep, s, 1, d)
    nv = valid.long().clamp(max=s)
    tok = torch.arange(s, device=q.device)
    keys = torch.arange(TILE, device=q.device)
    state = (q.new_full((b, g, rep, s), NEG_INF, dtype=torch.float32),
             q.new_zeros((b, g, rep, s), dtype=torch.float32),
             q.new_zeros((b, g, rep, s, dv), dtype=torch.float32))
    for start in range(0, s, TILE):
        key = start + keys  # (TILE,)
        live = key[None] < nv[:, None]  # (b, TILE): keys that exist
        k_t = tile_of(k_rot, start).permute(0, 2, 1, 3)[:, :, None, None]  # (b, g, 1, 1, T, d)
        v_t = torch.where(live[:, :, None, None], tile_of(v_new, start).float(), 0.0)
        logits = tree_sum(qg * k_t, -1) * scale  # (b, g, rep, s, T)
        ok = live[:, None, :] & (key[None, None, :] <= tok[None, :, None])  # (b, s, T)
        state = fold_tile(state, logits, ok[:, None, None],
                          v_t.permute(0, 2, 1, 3)[:, :, None, None])
    _, l, acc = state
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # (b, g, rep, s, dv)
    o = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dv).to(q.dtype)
    keep = (tok[None] < nv[:, None])[:, :, None, None]
    k_cast = torch.where(keep, k_rot, 0.0).to(k_new.dtype)
    v_cast = torch.where(keep, v_new, torch.zeros_like(v_new))
    return o, k_cast, v_cast


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, copied when its data does not start on a 16-byte boundary
    (the kernels load and store 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k_new, v_new, valid, scale, theta):
    b, s, h, d = q.shape
    g = k_new.shape[2]
    rep = h // g
    if not (q.is_cuda and k_new.is_cuda and v_new.is_cuda and valid.is_cuda):
        raise ValueError("flash_prefill_attention: all operands must be CUDA tensors")
    if q.dtype not in (torch.float32, torch.bfloat16) or k_new.dtype != q.dtype or (
            v_new.dtype != q.dtype):
        raise TypeError("flash_prefill_attention: q, k, v must share one dtype, f32 or bf16")
    if rep * g != h or rep > MAX_REP or d not in HEAD_DIMS:
        raise ValueError(f"flash_prefill_attention: h={h}, g={g}, d={d} unsupported "
                         f"(rep <= {MAX_REP}, d in {HEAD_DIMS})")
    if k_new.shape != (b, s, g, d) or v_new.shape != (b, s, g, d) or valid.shape != (b,):
        raise ValueError("flash_prefill_attention: k/v must be (b, s, g, d), valid (b,)")
    q, k_new, v_new = (_aligned(t.contiguous()) for t in (q, k_new, v_new))
    valid = valid.to(torch.int32).contiguous()
    cos, sin = rope_cos_sin(torch.arange(s, device=q.device), d, theta)  # (s, d/2)
    cos, sin = cos.contiguous(), sin.contiguous()
    o = torch.empty_like(q)
    k_cast = torch.empty_like(k_new)
    v_cast = torch.empty_like(v_new)
    if b == 0 or s == 0:
        return o, k_cast, v_cast
    KERNEL.launch(
        int(q.dtype == torch.bfloat16), ptr(q), ptr(k_new), ptr(v_new), ptr(valid),
        ptr(cos), ptr(sin), ptr(o), ptr(k_cast), ptr(v_cast),
        b, s, g, rep, d, float(scale), stream_of(q),
    )
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
    cache=None,
    valid: Optional[torch.Tensor] = None,  # (b,) valid rows (default s)
    *,
    scale: Optional[float] = None,
    rope_theta: float = 1_000_000.0,
    rope_dims: Optional[int] = None,  # None = whole head (GQA); MLA: rope dims
    emit_kv: bool = True,
    kv_dtype=None,
    impl: str = "auto",
):
    """Fresh causal prefill -> ``(o, k_cast, v_cast)``, or ``o`` alone when
    ``emit_kv=False`` (the MLA form, with ``rope_dims``).

    ``impl="auto"`` launches the CUDA kernel for CUDA tensors and runs the
    plain version for CPU tensors; ``impl="plain"`` runs the plain version."""
    if cache is not None:
        raise NotImplementedError("only the fresh form (cache=None) is ported")
    if kv_dtype is not None and kv_dtype != k_new.dtype:
        raise NotImplementedError("the emitted k/v keep the input dtype")
    b, s, _, d = q.shape
    mla = not emit_kv
    if mla != (rope_dims is not None and rope_dims < d):
        raise NotImplementedError(
            "ported forms: whole-head RoPE with emit_kv=True (GQA), or "
            "rope_dims < head with emit_kv=False (MLA)")
    scale = float(scale) if scale is not None else d ** -0.5
    if valid is None:
        valid = torch.full((b,), s, dtype=torch.int32, device=q.device)
    if impl == "plain" or (impl == "auto" and not q.is_cuda):
        out = flash_prefill_fresh_plain(q, k_new, v_new, valid, scale, float(rope_theta),
                                        rope_dims)
        return out[0] if mla else out
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}")
    if mla:
        return _launch_mla(q, k_new, v_new, valid, scale, float(rope_theta), rope_dims)
    return _launch(q, k_new, v_new, valid, scale, float(rope_theta))
