"""Model configs of the port (reference: ``repro/configs/base.py``,
``repro/configs/falcon3_1b.py`` and ``repro/configs/deepseek_v3_671b.py``).

A copy of the fields the ported paths read — the dense family (falcon3-1b:
untied, SwiGLU, full GQA attention) and the MoE family with MLA attention
(deepseek-v3-671b: latent KV cache, shared + routed experts) — so the
port imports nothing of the JAX package. ``BitNetConfig.impl`` mirrors the
reference's dispatch switch: ``"auto"`` runs the CUDA kernels on CUDA
tensors and the plain PyTorch versions on CPU tensors; ``"plain"`` forces
the plain versions everywhere (used to run the same path twice for
comparison).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def kv_cache_dim(self) -> int:  # latent + rope key per token
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_ff_expert: int = 0
    d_ff_dense: int = 0  # FFN width of the leading dense layers (0 -> d_ff)
    n_dense_layers: int = 0  # leading dense layers (DeepSeek-V3: 3)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


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
    family: str  # "dense" | "moe"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    attn_type: str = "full"  # "full" (GQA) | "mla"
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    decode_headroom: int = 128
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    bitnet: BitNetConfig = field(default_factory=BitNetConfig)
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


def shrink(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (``configs/base.py::
    shrink``, for the fields the port has)."""
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
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                              qk_rope_head_dim=8, v_head_dim=16)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64,
            d_ff_dense=128 if cfg.moe.d_ff_dense else 0,
            n_dense_layers=1 if cfg.moe.n_dense_layers else 0,
            capacity_factor=4.0,  # no token drops in smoke
        )
        kw["n_layers"] = 2
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

# deepseek-v3-671b — MLA, 1 shared + 256 routed top-8 experts, 3 leading
# dense layers (FFN 18432) [arXiv:2412.19437; hf]. The MTP head is omitted.
DEEPSEEK_V3_671B = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=2048,
    vocab_size=129280,
    attn_type="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, n_shared=1, d_ff_expert=2048,
                  d_ff_dense=18432, n_dense_layers=3),
    rope_theta=10_000.0,
    source="arXiv:2412.19437; hf",
)

# The same model at full width and reduced depth: the 3 dense layers plus
# 2 MoE layers. 61 layers do not fit one 80 GB card (the routed experts
# alone take about 164 GB as pack2); widths, heads, experts and top-k are
# unchanged.
DEEPSEEK_V3_671B_L5 = dataclasses.replace(DEEPSEEK_V3_671B, name="deepseek-v3-671b-l5",
                                          n_layers=5)

_REGISTRY: Dict[str, ModelConfig] = {
    c.name: c for c in (FALCON3_1B, DEEPSEEK_V3_671B, DEEPSEEK_V3_671B_L5)}
_SMOKE: Dict[str, ModelConfig] = {
    FALCON3_1B.name: shrink(FALCON3_1B),
    DEEPSEEK_V3_671B.name: shrink(DEEPSEEK_V3_671B),
}


def get_config(name: str) -> ModelConfig:
    return _REGISTRY[name]


def get_smoke_config(name: str) -> ModelConfig:
    return _SMOKE[name]
