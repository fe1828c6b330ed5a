"""Model configs of the port (reference: ``repro/configs/base.py``,
``repro/configs/falcon3_1b.py``, ``qwen3_8b.py``, ``qwen3_32b.py``,
``gemma_7b.py``, ``deepseek_coder_33b.py``, ``deepseek_v3_671b.py`` and
``mixtral_8x22b.py``, ``mamba2_130m.py``, ``zamba2_7b.py``,
``llava_next_34b.py`` and ``hubert_xlarge.py``).

A copy of the fields the ported paths read — the dense family (falcon3-1b:
untied, SwiGLU, full GQA attention; its speculative draft falcon3-draft,
tied embeddings; qwen3-8b / qwen3-32b with an RMSNorm over each q and k
head; gemma-7b with GeGLU, MHA and tied embeddings scaled by
sqrt(d_model); deepseek-coder-33b, the plain llama shape), the MoE family
with MLA attention
(deepseek-v3-671b: latent KV cache, shared + routed experts) and the MoE
family with sliding-window GQA attention (mixtral-8x22b: a ring-buffer
cold tier of ``swa_window`` rows, no hot tier), the attention-free SSM
family (mamba2-130m: a stack of Mamba2 blocks, ``attn_type="none"``) and
the hybrid family (zamba2-7b: groups of ``hybrid_attn_every`` Mamba2
blocks, each followed by one shared attention + MLP block), the vision
family (llava-next-34b: ``n_patches`` image-patch features of
``frontend_dim`` projected ahead of the text, then a dense decoder) and the
audio family (hubert-xlarge: an encoder-only stack over projected frame
features, bidirectional attention and the non-gated ``"gelu"`` MLP, no
decode) — so the port imports nothing of the JAX package.
``BitNetConfig.impl`` mirrors the reference's dispatch switch: ``"auto"``
runs the CUDA kernels on CUDA tensors and the plain PyTorch versions on
CPU tensors; ``"plain"`` forces the plain versions everywhere (used to run
the same path twice for comparison).
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
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 64

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class BitNetConfig:
    """The paper's quantization recipe (BitNet b1.58 / a4.8 + LoRA §III-C)."""

    act_bits: int = 8  # 8 = b1.58, 4 = a4.8
    codec: str = "pack2"  # "pack2" (2 b/trit) | "pack243" (1.6 b/trit)
    impl: str = "auto"  # "auto" | "plain"
    # True: the int8 act-quant runs in the packed matmul kernel's prologue;
    # False: a separate act-quant, then the known-scale kernel (the
    # carried-scale path; same numerics)
    fuse_act_quant: bool = True
    lora_rank: int = 0  # 0 disables adapters
    lora_targets: Tuple[str, ...] = ("v", "o", "down")
    lora_bits: int = 6
    # fp8 (e4m3) KV-cache tiers at inference: every attention cache
    # (contiguous, paged, ring) stores one byte a value
    kv_fp8: bool = False


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "dense" | "moe" | "ssm" | "hybrid" | "vlm" | "audio"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    activation: str = "swiglu"  # "swiglu" | "geglu" (gated) | "gelu" (non-gated)
    qk_norm: bool = False  # RMSNorm over each q and k head before RoPE (qwen3)
    attn_type: str = "full"  # "full" (GQA) | "swa" (GQA, sliding window) | "mla" | "none"
    swa_window: int = 4096
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    decode_headroom: int = 128
    tie_embeddings: bool = False  # the lm_head is embed.T (no lm_head leaf)
    scale_embed: bool = False  # embeddings scaled by sqrt(d_model) (gemma)
    is_encoder: bool = False  # bidirectional attention, no decode (hubert)
    hybrid_attn_every: int = 0  # zamba2: the shared attention block every k layers
    frontend: str = "none"  # "none" | "audio" | "vision"
    frontend_dim: int = 0  # width of the frame / patch features
    n_patches: int = 0  # vision: image patches per request, ahead of its text
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
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
        swa_window=8 if cfg.attn_type == "swa" else cfg.swa_window,
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
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=8, chunk=8)
    if cfg.family == "hybrid":
        kw["hybrid_attn_every"] = 2
        kw["n_layers"] = 5  # 2 groups of 2 + a tail of 1
    if cfg.frontend == "audio":
        kw["frontend_dim"] = 32
    if cfg.frontend == "vision":
        kw["frontend_dim"] = 32
        kw["n_patches"] = 8
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

# falcon3-draft — the draft model of speculative serving
# (``serving/engine.py``, ``spec_k > 0``): 4 ternary layers on falcon3-1b's
# vocabulary, the only hard coupling between draft and target, with tied
# embeddings and no LoRA (reference: ``configs/falcon3_1b.py::DRAFT``)
FALCON3_DRAFT = ModelConfig(
    name="falcon3-draft",
    family="dense",
    n_layers=4,
    d_model=1024,
    n_heads=8,
    n_kv_heads=4,
    head_dim=128,
    d_ff=4096,
    vocab_size=131072,
    rope_theta=1_000_042.0,
    tie_embeddings=True,
    bitnet=BitNetConfig(),
    source="derived; speculative draft for falcon3-1b",
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

# qwen3-8b — qk-norm, GQA [hf:Qwen/Qwen3-8B; hf]
QWEN3_8B = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B; hf",
)

# qwen3-32b — qk-norm, GQA rep 8, h * hd = 8192 against d_model 5120
QWEN3_32B = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B; hf",
)

# gemma-7b — GeGLU, MHA (16 kv heads of 256), tied embeddings scaled by
# sqrt(d_model) [arXiv:2403.08295; hf]
GEMMA_7B = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    activation="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    scale_embed=True,
    source="arXiv:2403.08295; hf",
)

# deepseek-coder-33b — the llama shape, GQA rep 7 [arXiv:2401.14196; hf]
DEEPSEEK_CODER_33B = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100_000.0,
    source="arXiv:2401.14196; hf",
)

# mixtral-8x22b — 8 experts top-2, sliding-window attention (window 4096):
# the decode cache is a ring of the window's last tokens [arXiv:2401.04088; hf]
MIXTRAL_8X22B = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    attn_type="swa",
    swa_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384),
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088; hf",
)

# mamba2-130m — SSD (state-space duality), attention-free: d_inner 1536, 24
# SSM heads of 64, one B / C group of 128 states [arXiv:2405.21060; unverified]
MAMBA2_130M = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=1,  # attention-free; the SSM heads derive from the ssm config
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    attn_type="none",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=64),
    source="arXiv:2405.21060; unverified",
)

# zamba2-7b — 81 Mamba2 blocks in 13 groups of 6 and a tail of 3; after each
# group ONE shared attention + MLP block (MHA, 32 heads of 112) whose v
# projection takes a per-invocation LoRA adapter [arXiv:2411.15242; unverified]
ZAMBA2_7B = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    hybrid_attn_every=6,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=2, chunk=64),
    bitnet=BitNetConfig(lora_rank=16),  # the shared block's per-invocation adapters
    rope_theta=10_000.0,
    source="arXiv:2411.15242; unverified",
)

# llava-next-34b — a Yi-34B-like dense decoder (GQA rep 7) behind a
# two-layer projector of 576 precomputed CLIP patch features of 1024 (one
# 336 px tile): the patches are the sequence's early tokens, read at every
# decode step [hf:llava-hf/llava-v1.6; unverified]
LLAVA_NEXT_34B = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    frontend="vision",
    frontend_dim=1024,
    n_patches=576,
    rope_theta=5_000_000.0,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)

# hubert-xlarge — encoder-only (bidirectional MHA 16 x 80, the non-gated
# gelu MLP) over precomputed frame features of 512 (the conv feature
# extractor is a projection); no decode [arXiv:2106.07447; unverified]
HUBERT_XLARGE = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    activation="gelu",
    is_encoder=True,
    frontend="audio",
    frontend_dim=512,
    rope_theta=10_000.0,
    source="arXiv:2106.07447; unverified",
)

_DENSE_FAMILIES = (QWEN3_8B, QWEN3_32B, GEMMA_7B, DEEPSEEK_CODER_33B)
_SSM_FAMILIES = (MAMBA2_130M, ZAMBA2_7B)
_FRONTEND_FAMILIES = (LLAVA_NEXT_34B, HUBERT_XLARGE)
_ARCHS = (FALCON3_1B, FALCON3_DRAFT, DEEPSEEK_V3_671B, MIXTRAL_8X22B, *_DENSE_FAMILIES,
          *_SSM_FAMILIES, *_FRONTEND_FAMILIES)
# deepseek-v3-671b-l5 is a depth cut for one card, not an architecture of
# the registry: it has no smoke config and list_configs() leaves it out
_REGISTRY: Dict[str, ModelConfig] = {c.name: c for c in (*_ARCHS, DEEPSEEK_V3_671B_L5)}
_SMOKE: Dict[str, ModelConfig] = {c.name: shrink(c) for c in _ARCHS}


def get_config(name: str) -> ModelConfig:
    return _REGISTRY[name]


def get_smoke_config(name: str) -> ModelConfig:
    return _SMOKE[name]


def list_configs() -> Tuple[str, ...]:
    """The registered architectures, sorted: the reference's
    ``list_configs()``."""
    return tuple(sorted(_SMOKE))
