"""Model configs of the port (reference: ``repro/configs/base.py`` and
``repro/configs/falcon3_1b.py``).

A copy of the fields the ported path reads — a dense, untied, SwiGLU,
full-attention decoder with fused packed projections — so the port
imports nothing of the JAX package. ``BitNetConfig.impl`` mirrors the
reference's dispatch switch: ``"auto"`` runs the CUDA kernels on CUDA tensors and the
plain PyTorch versions on CPU tensors; ``"plain"`` forces the plain
versions everywhere (used to run the same path twice for comparison).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Tuple


@dataclass(frozen=True)
class BitNetConfig:
    """The paper's quantization recipe (BitNet b1.58 / a4.8 + LoRA §III-C)."""

    act_bits: int = 8  # 8 = b1.58, 4 = a4.8
    codec: str = "pack2"  # "pack2" (2 b/trit) | "pack243" (1.6 b/trit)
    impl: str = "auto"  # "auto" | "plain"
    lora_rank: int = 0  # 0 disables adapters
    lora_targets: Tuple[str, ...] = ("v", "o", "down")
    lora_bits: int = 6


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # only "dense" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    decode_headroom: int = 128
    bitnet: BitNetConfig = field(default_factory=BitNetConfig)
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


def shrink(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (``configs/base.py::
    shrink``, dense fields only)."""
    kw: dict = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=4 if cfg.n_kv_heads == cfg.n_heads else 2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )
    if cfg.bitnet.lora_rank:
        kw["bitnet"] = dataclasses.replace(cfg.bitnet, lora_rank=4)
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)


# falcon3-1b — the paper's own deployment target (§V-B) [hf:tiiuae/Falcon3-1B]
FALCON3_1B = ModelConfig(
    name="falcon3-1b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=8192,
    vocab_size=131072,
    rope_theta=1_000_042.0,
    bitnet=BitNetConfig(lora_rank=16, lora_targets=("v", "o", "down"), lora_bits=6),
    source="hf:tiiuae/Falcon3-1B-Instruct; hf",
)

_REGISTRY: Dict[str, ModelConfig] = {FALCON3_1B.name: FALCON3_1B}
_SMOKE: Dict[str, ModelConfig] = {FALCON3_1B.name: shrink(FALCON3_1B)}


def get_config(name: str) -> ModelConfig:
    return _REGISTRY[name]


def get_smoke_config(name: str) -> ModelConfig:
    return _SMOKE[name]
