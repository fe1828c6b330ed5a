"""Shared layers: RMSNorm, RoPE, the SwiGLU MLP (reference:
``repro/models/layers.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.models import qops


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * w.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """cos and sin (positions.shape + (head_dim/2,)) f32 — the one
    expression both ``apply_rope`` and the attention kernels' wrappers use,
    so the kernels rotate with bit-identical tables."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., T, H, D); positions: (..., T) integer."""
    d = x.shape[-1]
    cos, sin = rope_cos_sin(positions, d, theta)
    cos, sin = cos[..., None, :], sin[..., None, :]  # (..., T, 1, D/2)
    x32 = x.float()
    x1, x2 = x32[..., : d // 2], x32[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_mlp(cfg: ModelConfig, *, generator, device, dtype=torch.float32) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    p = {
        "ln": torch.ones((d,), dtype=dtype, device=device),
        "gate": qops.init_linear(d, f, generator=generator, device=device, dtype=dtype),
        "up": qops.init_linear(d, f, generator=generator, device=device, dtype=dtype),
        "down": qops.init_linear(f, d, generator=generator, device=device, dtype=dtype),
    }
    if cfg.bitnet.lora_rank and "down" in cfg.bitnet.lora_targets:
        from repro_torch.core import lora as lora_lib

        p["lora_down"] = lora_lib.init(f, d, cfg.bitnet.lora_rank, generator=generator,
                                       device=device, dtype=dtype)
    return p


def apply_mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    # fused packed gate‖up: one act-quant + one kernel launch for both halves
    g, u = qops.fused_linear(p["wgu"], h, cfg)
    return qops.linear(p["down"], F.silu(g) * u, cfg, lora_leaf=p.get("lora_down"))
