"""GQA and MLA attention with the tiered DR KV cache (reference:
``repro/models/attention.py``, GQA and MLA serving forms).

Prefill runs the flash-prefill kernel (``kernels/flash_prefill.py``): q
and k rotate inside it, and it emits the rotated k / v in the tier dtype
(f32, bf16 or fp8) that ``kv_cache.fill_fresh`` places into the fresh
cache; a prompt chunk over
the live cache (chunked admission) runs its chunked form and
``kv_cache.append`` places the rows at each slot's offset. Decode runs the
fused-RoPE flash-decode kernel (``kernels/flash_decode.py``) against the
pre-append cache and then appends the kernel-rotated k in place. The
chunk and decode paths take a paged cache (``kv_cache.PagedKVCache``) as
well: the kernels' paged forms read its cold tier through the page
table, and the appends write through it.
``blockwise_attention`` is the plain full-sequence reference the tests
hold both against, and ``attention_full`` runs it for the hybrid family's
prefill and the full-sequence ``transformer.forward`` (bidirectional for
an encoder), as the reference does.

Sliding-window attention (``cfg.attn_type == "swa"``, mixtral-8x22b) runs
the same paths with ``window = cfg.swa_window`` over a ring cold tier (no
hot tier): the prefill kernel's window form and ``fill_fresh(ring=True)``
(which realigns a prompt longer than the ring), the chunked form over the
ring and ``append(ring=True)``, and the ring form of the fused decode
(``flash_decode_attention_ring``) with ``append_decode_ring``.

MLA (DeepSeek-V3) caches the compressed latent (c_kv ‖ k_rope, 576 values
per token) in the k-slot of a cache with an empty v-slot. Prefill expands
per-head keys and values from the latent and runs the flash-prefill
kernel's MLA form; decode runs in absorbed form (w_uk folded into the
query, w_uv out of the context) over the latent flash-decode kernel.
"""

from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core import kv_cache as kvc
from repro_torch.core.ternary import act_quant_ste
from repro_torch.kernels.flash_decode import (flash_decode_attention,
                                              flash_decode_attention_latent,
                                              flash_decode_attention_ring)
from repro_torch.kernels.flash_prefill import flash_prefill_attention
from repro_torch.models import qops
from repro_torch.models.layers import apply_rope, rms_norm

NEG_INF = kvc.NEG_INF
DEFAULT_CHUNK = 512


def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, scale: float | None = None,
                        q_chunk: int | None = None,
                        kv_chunk: int | None = None) -> torch.Tensor:
    """Streaming-softmax attention over full sequences, in f32.

    q: (b, g, r, sq, dk); k: (b, g, sk, dk); v: (b, g, sk, dv) ->
    (b, g, r, sq, dv). Chunks of at most 512 rows and keys; a partial last
    chunk is masked rather than padded away. ``window`` > 0 is SWA: a row
    sees the keys with q_pos - k_pos < window."""
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
            if window:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
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
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    if cfg.bitnet.lora_rank:
        from repro_torch.core import lora as lora_lib

        if "v" in cfg.bitnet.lora_targets:
            p["lora_v"] = lora_lib.init(d, g * hd, cfg.bitnet.lora_rank, **kw)
        if "o" in cfg.bitnet.lora_targets:
            p["lora_o"] = lora_lib.init(h * hd, d, cfg.bitnet.lora_rank, **kw)
    return p


def _project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    hidden = rms_norm(x, p["ln"], cfg.norm_eps, impl=cfg.bitnet.impl)
    # fused packed wq‖wk‖wv: one act-quant + one kernel launch; the v
    # adapter applies to its segment after the split
    q, k, v = qops.fused_linear(p["wqkv"], hidden, cfg, out_shapes=((h, hd), (g, hd), (g, hd)),
                                lora_leaves={2: p.get("lora_v")})
    if cfg.qk_norm:
        # qwen3: an RMSNorm over each q and k head, before the attention
        # kernels rotate them
        q = rms_norm(q, p["q_norm"], cfg.norm_eps, impl=cfg.bitnet.impl)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps, impl=cfg.bitnet.impl)
    return q, k, v


def _window(cfg: ModelConfig):
    """(window, ring) of the arch: SWA masks by ``swa_window`` over a ring."""
    swa = cfg.attn_type == "swa"
    return (cfg.swa_window if swa else 0), swa


def attention_full(p: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                   return_kv: bool = False):
    """Full-sequence attention in plain PyTorch (reference:
    ``attention_full``), causal unless ``cfg.is_encoder``: the
    projections, ``apply_rope`` on q and k at ``positions`` (s,),
    ``blockwise_attention``, then ``wo``. The hybrid family's prefill and
    ``transformer.forward`` run here, as the reference's do (its
    flash-prefill path admits only the attention-cache families). x (b, s,
    d_model) -> y, and with ``return_kv`` also the rotated k and the v (b,
    s, g, hd) for the cache fill."""
    b, s, _ = x.shape
    h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions[None], cfg.rope_theta)
    k = apply_rope(k, positions[None], cfg.rope_theta)
    qg = q.reshape(b, s, g, h // g, hd).permute(0, 2, 3, 1, 4)  # (b, g, rep, s, hd)
    o = blockwise_attention(qg, k.transpose(1, 2), v.transpose(1, 2),
                            causal=not cfg.is_encoder,
                            window=_window(cfg)[0])  # (b, g, rep, s, hd)
    o = o.permute(0, 3, 1, 2, 4).reshape(b, s, h * hd)
    y = qops.linear(p["wo"], o, cfg, lora_leaf=p.get("lora_o"))
    return (y, (k, v)) if return_kv else y


def attention_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig,
                      cache: kvc.TieredKVCache):
    """Full-prompt attention + fill of one layer's fresh cache (in place).
    x: (b, s, d_model) -> (y, cache)."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    window, ring = _window(cfg)
    q, k, v = _project_qkv(p, x, cfg)
    o, k_c, v_c = flash_prefill_attention(
        q, k, v, window=window, rope_theta=cfg.rope_theta, emit_kv=True,
        kv_dtype=cache.hot_k.dtype, impl=cfg.bitnet.impl)
    kvc.fill_fresh(cache, k_c, v_c, ring=ring)
    y = qops.linear(p["wo"], o.reshape(b, s, h * hd), cfg, lora_leaf=p.get("lora_o"))
    return y, cache


def attention_prefill_chunk(p: dict, x: torch.Tensor, cfg: ModelConfig,
                            cache: kvc.TieredKVCache, n_valid: torch.Tensor,
                            append: bool = True):
    """Chunked-prefill continuation of one layer (reference:
    ``attention_prefill_chunk``): the C chunk rows of each slot attend to
    the slot's cached prefix (``cache.lengths`` tokens, both tiers) and to
    the causally earlier chunk rows, then their rotated k / v are appended
    at the slot's offset, in place, for the first ``n_valid[b]`` rows (0:
    the slot is not prefilling and keeps its rows). x: (b, C, d_model) ->
    (y, cache).

    ``append=False`` is the speculative verify form: the cache is left as
    it is and the kernel's emitted k / v come back instead, ``(y, (k_c,
    v_c))``, for ``transformer.spec_commit_chunk``. The kernel reads a
    chunk's own rows from its inputs, never through the cache, so the
    deferred append changes no value."""
    b, c, _ = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    window, ring = _window(cfg)
    q, k, v = _project_qkv(p, x, cfg)
    o, k_c, v_c = flash_prefill_attention(
        q, k, v, cache, valid=n_valid, window=window, ring=ring, rope_theta=cfg.rope_theta,
        emit_kv=True, impl=cfg.bitnet.impl)
    if append:
        kvc.append(cache, k_c, v_c, valid=n_valid, ring=ring)
    y = qops.linear(p["wo"], o.reshape(b, c, h * hd), cfg, lora_leaf=p.get("lora_o"))
    return y, (cache if append else (k_c, v_c))


def attention_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                     cache: kvc.TieredKVCache, active: torch.Tensor | None = None):
    """One decode step of one layer: x (b, d_model) -> (y, cache); the
    pending token's k (rotated by the kernel) and v are appended in place
    for ``active`` slots after attention (SWA: the ring forms of both)."""
    b, _ = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(p, x[:, None, :], cfg)  # (b, 1, h, hd) / (b, 1, g, hd)
    ring = cfg.attn_type == "swa"
    entry = flash_decode_attention_ring if ring else flash_decode_attention
    o, k_rot = entry(
        q[:, 0], cache, k_new=k[:, 0], v_new=v[:, 0], active=active,
        rope_theta=cfg.rope_theta, impl=cfg.bitnet.impl,
    )
    (kvc.append_decode_ring if ring else kvc.append_decode)(cache, k_rot, v[:, 0],
                                                            active=active)
    y = qops.linear(p["wo"], o.reshape(b, h * hd), cfg, lora_leaf=p.get("lora_o"))
    return y, cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): compressed-latent attention
# ---------------------------------------------------------------------------


def init_mla(cfg: ModelConfig, *, generator, device, dtype=torch.float32) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    kw = dict(generator=generator, device=device, dtype=dtype)
    p = {
        "ln": torch.ones((d,), dtype=dtype, device=device),
        "w_dq": qops.init_linear(d, m.q_lora_rank, **kw),
        "q_ln": torch.ones((m.q_lora_rank,), dtype=dtype, device=device),
        "w_uq": qops.init_linear(m.q_lora_rank, h * qk_head, **kw),
        "w_dkv": qops.init_linear(d, m.kv_cache_dim, **kw),
        "kv_ln": torch.ones((m.kv_lora_rank,), dtype=dtype, device=device),
        # factor matrices stay float (fake-quant ternary at use)
        "w_uk": qops.init_linear(m.kv_lora_rank, h * m.qk_nope_head_dim, **kw),
        "w_uv": qops.init_linear(m.kv_lora_rank, h * m.v_head_dim, **kw),
        "wo": qops.init_linear(h * m.v_head_dim, d, **kw),
    }
    if cfg.bitnet.lora_rank:
        from repro_torch.core import lora as lora_lib

        if "v" in cfg.bitnet.lora_targets:
            p["lora_v"] = lora_lib.init(m.kv_lora_rank, h * m.v_head_dim,
                                        cfg.bitnet.lora_rank, **kw)
        if "o" in cfg.bitnet.lora_targets:
            p["lora_o"] = lora_lib.init(h * m.v_head_dim, d, cfg.bitnet.lora_rank, **kw)
    return p


def _mla_down(p: dict, hidden: torch.Tensor, cfg: ModelConfig):
    """Both down-projections of the shared hidden -> (dq, dkv): one
    act-quant + one launch for the pack-time-fused w_dq‖w_dkv."""
    if "w_dqkv" in p:
        return qops.fused_linear(p["w_dqkv"], hidden, cfg)
    return qops.linear(p["w_dq"], hidden, cfg), qops.linear(p["w_dkv"], hidden, cfg)


def _mla_queries(p: dict, dq: torch.Tensor, cfg: ModelConfig, positions=None):
    """dq (b, t, q_rank) -> q_nope (b, t, h, dn), q_rope (b, t, h, dr),
    q_rope rotated at ``positions`` (batch-broadcastable (1, s) or (b, 1));
    ``positions=None`` leaves it unrotated (the prefill kernel rotates)."""
    m, h = cfg.mla, cfg.n_heads
    cq = rms_norm(dq, p["q_ln"], cfg.norm_eps, impl=cfg.bitnet.impl)
    q = qops.linear(p["w_uq"], cq, cfg, out_shape=(h, m.qk_nope_head_dim + m.qk_rope_head_dim))
    q_nope, q_rope = q[..., : m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    if positions is not None:
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope, q


def _mla_latent(p: dict, dkv: torch.Tensor, cfg: ModelConfig, positions):
    """dkv (b, t, dl + dr) -> the normed latent c_kv (b, t, dl), the
    rotated k_rope (b, t, dr) and the unrotated one."""
    m = cfg.mla
    c_kv = rms_norm(dkv[..., : m.kv_lora_rank], p["kv_ln"], cfg.norm_eps,
                    impl=cfg.bitnet.impl)
    k_rope_raw = dkv[..., m.kv_lora_rank:]
    k_rope = apply_rope(k_rope_raw[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope, k_rope_raw


def mla_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig, cache: kvc.TieredKVCache):
    """Full-prompt MLA prefill + latent cache fill of one layer (in place).

    The per-head keys (k_nope ‖ the shared unrotated k_rope) and values
    (from ``w_uk`` / ``w_uv`` over the latent) go UNROTATED into the
    flash-prefill kernel's MLA form, which rotates the trailing rope dims
    of q and k. The cached row is the latent (c_kv ‖ k_rope), built here
    with k_rope rotated once per token. x: (b, s, d_model) -> (y, cache)."""
    m, h = cfg.mla, cfg.n_heads
    b, s, _ = x.shape
    hidden = rms_norm(x, p["ln"], cfg.norm_eps, impl=cfg.bitnet.impl)
    dq, dkv = _mla_down(p, hidden, cfg)
    _, _, q = _mla_queries(p, dq, cfg)
    c_kv, k_rope, k_rope_raw = _mla_latent(
        p, dkv, cfg, torch.arange(s, device=x.device)[None])
    k_nope = qops.linear(p["w_uk"], c_kv, cfg, out_shape=(h, m.qk_nope_head_dim))
    v = qops.linear(p["w_uv"], c_kv, cfg, out_shape=(h, m.v_head_dim),
                    lora_leaf=p.get("lora_v"))
    k = torch.cat([k_nope, k_rope_raw[:, :, None, :].expand(b, s, h, m.qk_rope_head_dim)],
                  dim=-1)
    o = flash_prefill_attention(q, k, v, rope_theta=cfg.rope_theta,
                                rope_dims=m.qk_rope_head_dim, emit_kv=False,
                                impl=cfg.bitnet.impl)  # (b, s, h, dv)
    y = qops.linear(p["wo"], o.reshape(b, s, h * m.v_head_dim), cfg,
                    lora_leaf=p.get("lora_o"))
    lat = torch.cat([c_kv, k_rope], dim=-1)
    kvc.fill_fresh(cache, lat, lat.new_zeros((b, s, 0)))
    return y, cache


def _fake_quant_latent(buf: torch.Tensor, kv_lora_rank: int, bits: int) -> torch.Tensor:
    """Cached rows with the latent part fake-quantized per row (the rope
    dims are never quantized), as the non-absorbed path feeds c_kv through
    the w_uk / w_uv fake-quant linears (reference: ``mla_decode``'s ``_q``).
    An fp8 tier's rows upcast, quantize and round back to fp8."""
    if buf.shape[1] == 0:
        return buf
    ckv = act_quant_ste(buf[..., :kv_lora_rank], bits=bits)  # in buf's dtype
    return torch.cat([kvc.raw(ckv), kvc.raw(buf[..., kv_lora_rank:])], dim=-1).view(buf.dtype)


def mla_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, cache: kvc.TieredKVCache,
               active: torch.Tensor | None = None):
    """Absorbed-form MLA decode over the tiered latent cache: x (b,
    d_model) -> (y, cache). The new latent row is appended in place
    (``active`` slots only) BEFORE attention, then the latent flash-decode
    kernel reads a copy of the cache whose latent parts are
    fake-quantized; ``w_uk`` folds into the query, ``w_uv`` out of the
    context."""
    m, h = cfg.mla, cfg.n_heads
    b, _ = x.shape
    hidden = rms_norm(x[:, None, :], p["ln"], cfg.norm_eps, impl=cfg.bitnet.impl)
    pos = cache.lengths.long()[:, None]  # (b, 1)
    dq, dkv = _mla_down(p, hidden, cfg)
    q_nope, q_rope, _ = _mla_queries(p, dq, cfg, pos)  # (b, 1, h, ·)
    c_kv, k_rope, _ = _mla_latent(p, dkv, cfg, pos)
    lat_new = torch.cat([c_kv, k_rope], dim=-1)[:, 0]  # (b, dl + dr)
    kvc.append_decode(cache, lat_new, lat_new.new_zeros((b, 0)), active=active)

    w_uk = p["w_uk"]["fq"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
    q_abs = torch.einsum("bhn,lhn->bhl", q_nope[:, 0], w_uk)  # (b, h, dl)
    q_full = torch.cat([q_abs, q_rope[:, 0]], dim=-1)  # (b, h, dl + dr)
    bits = cfg.bitnet.act_bits
    att = cache._replace(hot_k=_fake_quant_latent(cache.hot_k, m.kv_lora_rank, bits),
                         cold_k=_fake_quant_latent(cache.cold_k, m.kv_lora_rank, bits))
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    ctx = flash_decode_attention_latent(q_full, att, value_dim=m.kv_lora_rank, scale=scale,
                                        impl=cfg.bitnet.impl)  # (b, h, dl) f32
    w_uv = p["w_uv"]["fq"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    o = torch.einsum("bhl,lhv->bhv", ctx, w_uv).reshape(b, h * m.v_head_dim)
    y = qops.linear(p["wo"], o.to(x.dtype), cfg, lora_leaf=p.get("lora_o"))
    return y, cache
