"""GQA attention with the tiered DR KV cache (reference:
``repro/models/attention.py``, GQA forms only).

Prefill runs the flash-prefill kernel (``kernels/flash_prefill.py``): q
and k rotate inside it, and it emits the rotated k / v that
``kv_cache.fill_fresh`` places into the fresh cache. Decode runs the
fused-RoPE flash-decode kernel (``kernels/flash_decode.py``) against the
pre-append cache and then appends the kernel-rotated k in place.
``blockwise_attention`` is the plain full-sequence reference the tests
hold both against.
"""

from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core import kv_cache as kvc
from repro_torch.kernels.flash_decode import flash_decode_attention
from repro_torch.kernels.flash_prefill import flash_prefill_attention
from repro_torch.models import qops
from repro_torch.models.layers import rms_norm

NEG_INF = kvc.NEG_INF
DEFAULT_CHUNK = 512


def blockwise_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        scale: float | None = None, q_chunk: int | None = None,
                        kv_chunk: int | None = None) -> torch.Tensor:
    """Streaming-softmax attention over full sequences, in f32.

    q: (b, g, r, sq, dk); k: (b, g, sk, dk); v: (b, g, sk, dv) ->
    (b, g, r, sq, dv). Chunks of at most 512 rows and keys; a partial last
    chunk is masked rather than padded away."""
    b, g, r, sq, dk = q.shape
    sk = k.shape[2]
    scale = scale if scale is not None else dk ** -0.5
    cq = q_chunk or min(sq, DEFAULT_CHUNK)
    ck = kv_chunk or min(sk, DEFAULT_CHUNK)
    outs = []
    for q0 in range(0, sq, cq):
        qc = q[:, :, :, q0:q0 + cq].float()
        q_pos = q_offset + q0 + torch.arange(qc.shape[3], device=q.device)
        m = torch.full(qc.shape[:4], NEG_INF, device=q.device)
        l = torch.zeros(qc.shape[:4], device=q.device)
        acc = torch.zeros(qc.shape[:4] + (v.shape[-1],), device=q.device)
        for k0 in range(0, sk, ck):
            kc, vc = k[:, :, k0:k0 + ck].float(), v[:, :, k0:k0 + ck].float()
            k_pos = k0 + torch.arange(kc.shape[2], device=q.device)
            logits = torch.einsum("bgrqd,bgkd->bgrqk", qc, kc) * scale
            mask = torch.ones((qc.shape[3], kc.shape[2]), dtype=torch.bool, device=q.device)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            logits = torch.where(mask, logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.where(mask, torch.exp(logits - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bgrqk,bgkd->bgrqd", p, vc)
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    return torch.cat(outs, dim=3).to(q.dtype)


def init_attention(cfg: ModelConfig, *, generator, device, dtype=torch.float32) -> dict:
    d, h, g, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    kw = dict(generator=generator, device=device, dtype=dtype)
    p = {
        "ln": torch.ones((d,), dtype=dtype, device=device),
        "wq": qops.init_linear(d, h * hd, **kw),
        "wk": qops.init_linear(d, g * hd, **kw),
        "wv": qops.init_linear(d, g * hd, **kw),
        "wo": qops.init_linear(h * hd, d, **kw),
    }
    if cfg.bitnet.lora_rank:
        from repro_torch.core import lora as lora_lib

        if "v" in cfg.bitnet.lora_targets:
            p["lora_v"] = lora_lib.init(d, g * hd, cfg.bitnet.lora_rank, **kw)
        if "o" in cfg.bitnet.lora_targets:
            p["lora_o"] = lora_lib.init(h * hd, d, cfg.bitnet.lora_rank, **kw)
    return p


def _project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    hidden = rms_norm(x, p["ln"], cfg.norm_eps)
    # fused packed wq‖wk‖wv: one act-quant + one kernel launch; the v
    # adapter applies to its segment after the split
    return qops.fused_linear(p["wqkv"], hidden, cfg, out_shapes=((h, hd), (g, hd), (g, hd)),
                             lora_leaves={2: p.get("lora_v")})


def attention_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig,
                      cache: kvc.TieredKVCache):
    """Full-prompt attention + fill of one layer's fresh cache (in place).
    x: (b, s, d_model) -> (y, cache)."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(p, x, cfg)
    o, k_c, v_c = flash_prefill_attention(
        q, k, v, rope_theta=cfg.rope_theta, emit_kv=True, impl=cfg.bitnet.impl)
    kvc.fill_fresh(cache, k_c, v_c)
    y = qops.linear(p["wo"], o.reshape(b, s, h * hd), cfg, lora_leaf=p.get("lora_o"))
    return y, cache


def attention_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                     cache: kvc.TieredKVCache, active: torch.Tensor | None = None):
    """One decode step of one layer: x (b, d_model) -> (y, cache); the
    pending token's k (rotated by the kernel) and v are appended in place
    for ``active`` slots after attention."""
    b, _ = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(p, x[:, None, :], cfg)  # (b, 1, h, hd) / (b, 1, g, hd)
    o, k_rot = flash_decode_attention(
        q[:, 0], cache, k_new=k[:, 0], v_new=v[:, 0], active=active,
        rope_theta=cfg.rope_theta, impl=cfg.bitnet.impl,
    )
    kvc.append_decode(cache, k_rot, v[:, 0], active=active)
    y = qops.linear(p["wo"], o.reshape(b, h * hd), cfg, lora_leaf=p.get("lora_o"))
    return y, cache
