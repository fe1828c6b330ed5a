"""Decoder LM: init / prefill / decode with the tiered DR cache
(reference: ``repro/models/transformer.py``, dense and moe families).

Parameters are a plain dict: ``embed``, ``final_ln``, ``lm_head`` and the
layer stacks, lists with one dict per layer (the reference stacks layers
and scans them; here a Python loop walks the list):
  * dense: ``blocks``, each ``{"attn": ..., "mlp": ...}``;
  * moe: ``dense_blocks`` (the leading dense-FFN layers, ``{"attn",
    "mlp"}``) then ``moe_blocks`` (``{"attn", "moe"}``); attention is MLA
    when ``cfg.attn_type == "mla"``.
The decode cache stacks the per-layer caches of each stack along a
leading axis: ``{"attn": TieredKVCache}`` (dense, tiers (L, b, cap, g,
hd)) or ``{"attn_dense", "attn_moe"}`` (moe; under MLA the k-slot tiers
are (L, b, cap, 576) latent rows and the v-slot is empty).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core import kv_cache as kvc
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import qops
from repro_torch.models.layers import apply_mlp, init_mlp, rms_norm

DEFAULT_HOT_CAP = 32  # paper: 32 buffered early tokens (S = 128)


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                dtype=torch.float32) -> dict:
    """Parameters drawn from a seeded ``torch.Generator`` with the
    reference init's distributions and shapes (embed N(0, 0.02^2),
    projections N(0, 1/d_in), LoRA A N(0, 1/r) and B = 0, norms 1). Float,
    except the routed experts, which come packed (``moe.init_moe``)."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, device=device, dtype=dtype)
    d = cfg.d_model
    params = {
        "embed": {"w": torch.randn((cfg.vocab_size, d), **kw) * 0.02},
        "final_ln": torch.ones((d,), dtype=dtype, device=device),
        "lm_head": qops.init_linear(d, cfg.vocab_size, **kw),
    }
    init_attn = attn.init_mla if cfg.attn_type == "mla" else attn.init_attention
    if cfg.family == "dense":
        params["blocks"] = [
            {"attn": init_attn(cfg, **kw), "mlp": init_mlp(cfg, **kw)}
            for _ in range(cfg.n_layers)
        ]
        return params
    nd = cfg.moe.n_dense_layers
    params["dense_blocks"] = [
        {"attn": init_attn(cfg, **kw), "mlp": init_mlp(cfg, cfg.moe.d_ff_dense or None, **kw)}
        for _ in range(nd)
    ]
    params["moe_blocks"] = [
        {"attn": init_attn(cfg, **kw), "moe": moe_lib.init_moe(cfg, **kw)}
        for _ in range(cfg.n_layers - nd)
    ]
    return params


def layer_stacks(cfg: ModelConfig):
    """(parameter stack, cache stack, layers) in the order the layers run."""
    if cfg.family == "dense":
        return (("blocks", "attn", cfg.n_layers),)
    nd = cfg.moe.n_dense_layers
    return (("dense_blocks", "attn_dense", nd), ("moe_blocks", "attn_moe", cfg.n_layers - nd))


def _attn_cache_spec(cfg: ModelConfig):
    """Per-token shapes of the k- and v-slots: GQA (g, hd) for both; MLA
    the latent row (kv_lora_rank + rope dims,) and an empty v-slot."""
    if cfg.attn_type == "mla":
        return (cfg.mla.kv_cache_dim,), (0,)
    g, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return (g, hd), (g, hd)


def _embed_tokens(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return params["embed"]["w"][tokens.long()].to(dtype)


def _lm_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The untied float lm_head: a plain matmul (outside any kernel in the
    reference too)."""
    return qops.linear(params["lm_head"], x, cfg).float()


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      hot_cap: int = DEFAULT_HOT_CAP, dtype=torch.float32,
                      device=None) -> dict:
    """Empty stacked cache per layer stack: hot tier min(hot_cap,
    max_len), cold the rest."""
    hc = min(hot_cap, max_len)
    kshape, vshape = _attn_cache_spec(cfg)
    return {cname: kvc.init_cache(batch, hc, max_len - hc, kshape, dtype, device=device,
                                  lead=(n,), v_shape=vshape)
            for _, cname, n in layer_stacks(cfg)}


def _attn_block_prefill(bp: dict, x: torch.Tensor, cfg: ModelConfig,
                        cache: kvc.TieredKVCache) -> torch.Tensor:
    """One block: full-prompt attention straight into its cache rows, then
    the MLP or MoE."""
    f = attn.mla_prefill if cfg.attn_type == "mla" else attn.attention_prefill
    y, _ = f(bp["attn"], x, cfg, cache)
    x = x + y
    if "moe" in bp:
        return x + moe_lib.apply_moe(bp["moe"], x, cfg)[0]
    return x + apply_mlp(bp["mlp"], x, cfg)


def _attn_block_decode(bp: dict, x: torch.Tensor, cfg: ModelConfig,
                       cache: kvc.TieredKVCache, active) -> torch.Tensor:
    f = attn.mla_decode if cfg.attn_type == "mla" else attn.attention_decode
    y, _ = f(bp["attn"], x, cfg, cache, active=active)
    x = x + y
    if "moe" in bp:
        return x + moe_lib.apply_moe(bp["moe"], x[:, None, :], cfg)[0][:, 0]
    return x + apply_mlp(bp["mlp"], x[:, None, :], cfg)[:, 0]


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            hot_cap: int = DEFAULT_HOT_CAP, max_len: Optional[int] = None):
    """Prompt (b, s) -> (last-token logits (b, V) f32, filled cache).

    The per-layer flash-prefill loop of the reference's ``_prefill_flash``:
    each layer's attention fills its cache rows, then its MLP or MoE runs."""
    b, s = tokens.shape
    if max_len is None:
        max_len = s + cfg.decode_headroom
    dtype = params["final_ln"].dtype
    x = _embed_tokens(params, tokens, dtype)
    cache = init_decode_cache(cfg, b, max_len, hot_cap, dtype=dtype, device=x.device)
    for pname, cname, _ in layer_stacks(cfg):
        for i, bp in enumerate(params[pname]):
            x = _attn_block_prefill(bp, x, cfg, kvc.layer(cache[cname], i))
    x_last = rms_norm(x[:, -1], params["final_ln"], cfg.norm_eps)
    return _lm_logits(params, cfg, x_last), cache


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
                active: Optional[torch.Tensor] = None):
    """One token for every slot: tokens (b,) -> (logits (b, V) f32, cache).
    ``active`` (b,) bool gates the KV appends per slot (in place)."""
    x = _embed_tokens(params, tokens, params["final_ln"].dtype)  # (b, d)
    for pname, cname, _ in layer_stacks(cfg):
        for i, bp in enumerate(params[pname]):
            x = _attn_block_decode(bp, x, cfg, kvc.layer(cache[cname], i), active)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return _lm_logits(params, cfg, x), cache
