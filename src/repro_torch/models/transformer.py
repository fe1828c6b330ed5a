"""Dense decoder LM: init / prefill / decode with the tiered DR cache
(reference: ``repro/models/transformer.py``, dense family).

Parameters are a plain dict: ``embed``, ``final_ln``, ``lm_head`` and
``blocks``, a list with one ``{"attn": ..., "mlp": ...}`` dict per layer
(the reference stacks layers and scans them; here a Python loop walks the
list). The decode cache stacks the per-layer caches along a leading axis:
``{"attn": TieredKVCache}`` with tier tensors (L, b, cap, g, hd).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.core import kv_cache as kvc
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import qops
from repro_torch.models.layers import apply_mlp, init_mlp, rms_norm

DEFAULT_HOT_CAP = 32  # paper: 32 buffered early tokens (S = 128)


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                dtype=torch.float32) -> dict:
    """Float parameters drawn from a seeded ``torch.Generator`` with the
    reference init's distributions and shapes (embed N(0, 0.02^2),
    projections N(0, 1/d_in), LoRA A N(0, 1/r) and B = 0, norms 1)."""
    if cfg.family != "dense":
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
    params["blocks"] = [
        {"attn": attn.init_attention(cfg, **kw), "mlp": init_mlp(cfg, **kw)}
        for _ in range(cfg.n_layers)
    ]
    return params


def _embed_tokens(params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return params["embed"]["w"][tokens.long()].to(dtype)


def _lm_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The untied float lm_head: a plain matmul (outside any kernel in the
    reference too)."""
    return qops.linear(params["lm_head"], x, cfg).float()


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      hot_cap: int = DEFAULT_HOT_CAP, dtype=torch.float32,
                      device=None) -> dict:
    """Empty stacked cache: hot tier min(hot_cap, max_len), cold the rest."""
    hc = min(hot_cap, max_len)
    return {"attn": kvc.init_cache(
        batch, hc, max_len - hc, (cfg.n_kv_heads, cfg.resolved_head_dim), dtype,
        device=device, lead=(cfg.n_layers,))}


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            hot_cap: int = DEFAULT_HOT_CAP, max_len: Optional[int] = None):
    """Prompt (b, s) -> (last-token logits (b, V) f32, filled cache).

    The per-layer flash-prefill loop of the reference's ``_prefill_flash``:
    each layer's attention fills its cache rows, then its MLP runs."""
    b, s = tokens.shape
    if max_len is None:
        max_len = s + cfg.decode_headroom
    dtype = params["final_ln"].dtype
    x = _embed_tokens(params, tokens, dtype)
    cache = init_decode_cache(cfg, b, max_len, hot_cap, dtype=dtype, device=x.device)
    for i, bp in enumerate(params["blocks"]):
        y, _ = attn.attention_prefill(bp["attn"], x, cfg, kvc.layer(cache["attn"], i))
        x = x + y
        x = x + apply_mlp(bp["mlp"], x, cfg)
    x_last = rms_norm(x[:, -1], params["final_ln"], cfg.norm_eps)
    return _lm_logits(params, cfg, x_last), cache


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
                active: Optional[torch.Tensor] = None):
    """One token for every slot: tokens (b,) -> (logits (b, V) f32, cache).
    ``active`` (b,) bool gates the KV appends per slot (in place)."""
    x = _embed_tokens(params, tokens, params["final_ln"].dtype)  # (b, d)
    for i, bp in enumerate(params["blocks"]):
        y, _ = attn.attention_decode(bp["attn"], x, cfg, kvc.layer(cache["attn"], i),
                                     active=active)
        x = x + y
        x = x + apply_mlp(bp["mlp"], x[:, None, :], cfg)[:, 0]
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return _lm_logits(params, cfg, x), cache
