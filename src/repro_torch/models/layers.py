"""Shared layers: RMSNorm, RoPE, the MLP: gated (SwiGLU or GeGLU) or the
non-gated GELU one of an encoder (reference: ``repro/models/layers.py``)."""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.kernels.rms_norm import rms_norm as rms_norm_k
from repro_torch.models import qops


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
             impl: str = "auto") -> torch.Tensor:
    """RMSNorm over the last dim in a sum order fixed per row
    (``kernels/rms_norm.py``: the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors or ``impl="plain"``), so a token's norm does
    not depend on how many rows share its call."""
    return rms_norm_k(x, w, eps, impl=impl)


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


ACTIVATIONS = ("swiglu", "geglu", "gelu")


def _check_activation(cfg: ModelConfig):
    if cfg.activation not in ACTIVATIONS:
        raise NotImplementedError(f"activation {cfg.activation!r}: the MLP is one of "
                                  f"{ACTIVATIONS}")


def init_mlp(cfg: ModelConfig, d_ff: int | None = None, *, generator, device,
             dtype=torch.float32) -> dict:
    """``ln``, then ``gate`` and ``up`` (gated) or ``up`` alone (the
    non-gated ``"gelu"`` MLP), then ``down``."""
    _check_activation(cfg)
    d, f = cfg.d_model, d_ff or cfg.d_ff
    kw = dict(generator=generator, device=device, dtype=dtype)
    p = {"ln": torch.ones((d,), dtype=dtype, device=device)}
    if cfg.activation != "gelu":
        p["gate"] = qops.init_linear(d, f, **kw)
    p["up"] = qops.init_linear(d, f, **kw)
    p["down"] = qops.init_linear(f, d, **kw)
    if cfg.bitnet.lora_rank and "down" in cfg.bitnet.lora_targets:
        from repro_torch.core import lora as lora_lib

        p["lora_down"] = lora_lib.init(f, d, cfg.bitnet.lora_rank, **kw)
    return p


@functools.lru_cache(maxsize=None)
def dtype_const(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` first (as ``jnp.asarray(value,
    dtype)`` or a weakly typed constant in the reference), as a Python
    float: a product with it then rounds once, as there, and launches no
    host-to-device copy."""
    return torch.tensor(value, dtype=dtype).item()


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` in its order:
    ``x * (0.5 * (1 + tanh(c * (x + 0.044715 * x^3))))`` with ``c =
    sqrt(2 / pi)``, each constant rounded to x's dtype, and x^3 as (x * x)
    * x (jax's ``integer_pow``)."""
    c, k = dtype_const(math.sqrt(2 / math.pi), x.dtype), dtype_const(0.044715, x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x))))
    return x * cdf


def apply_mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    _check_activation(cfg)
    h = rms_norm(x, p["ln"], cfg.norm_eps, impl=cfg.bitnet.impl)
    if cfg.activation == "gelu":
        # the non-gated MLP: its ``up`` leaf has no gate sibling to fuse with
        act = gelu_tanh(qops.linear(p["up"], h, cfg))
    else:
        # fused packed gate‖up: one act-quant + one kernel launch for both halves
        g, u = qops.fused_linear(p["wgu"], h, cfg)
        act = (gelu_tanh(g) if cfg.activation == "geglu" else F.silu(g)) * u
    return qops.linear(p["down"], act, cfg, lora_leaf=p.get("lora_down"))
