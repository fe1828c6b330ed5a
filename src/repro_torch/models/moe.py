"""Mixture-of-Experts layer, global routing (reference:
``repro/models/moe.py``; DeepSeek-V3: 1 shared + 256 routed, top-8).

Router scores -> per-token top-k experts -> per-expert top-C token
selection (capacity ``int(T * k / E * factor) + 1``, counting every token
given, live or not) -> gather (E, C, d) -> the expert GEMMs as one launch
over all experts (``qops.expert_fused_linear`` / ``expert_linear``) ->
weighted combine back in bfloat16, as the reference combines in
inference. Tokens beyond an expert's capacity pass through the residual.

Two orders are fixed on purpose:
  * top-k breaks ties toward the lower index (``jax.lax.top_k``'s rule),
    through a stable descending sort;
  * the combine adds each token's expert outputs in ascending expert
    order, one rounded bfloat16 add at a time — the order in which the
    reference's scatter-add applies its (E, C) updates. A scatter with
    repeated indices on CUDA (``index_add_``) adds in an order that
    changes from run to run, and at top-8 the bfloat16 sum depends on it.
Grouped routing (the reference's sharding hint) is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.core.bitlinear import PackedLinear
from repro_torch.models import qops
from repro_torch.models.layers import rms_norm
from repro_torch.models.pack import pack_weight, stack_packed


def _packed_experts(n_e: int, d_in: int, d_out: int, codec: str, *, generator, device,
                    dtype) -> PackedLinear:
    """Expert-stacked packed weights drawn and packed ONE expert at a time
    (N(0, 1/d_in) like the reference's init), so no (E, d_in, d_out) float
    master exists: at DeepSeek-V3's width one would take 15 GB."""
    return stack_packed([
        pack_weight(torch.randn((d_in, d_out), generator=generator, device=device,
                                dtype=dtype) * d_in ** -0.5, codec)
        for _ in range(n_e)])


def init_moe(cfg: ModelConfig, *, generator, device, dtype=torch.float32) -> dict:
    """Router and shared expert as float leaves; the routed experts come
    packed (``_packed_experts``)."""
    mo = cfg.moe
    d = cfg.d_model
    ff = mo.d_ff_expert or cfg.d_ff
    kw = dict(generator=generator, device=device, dtype=dtype)
    ex = dict(codec=cfg.bitnet.codec, **kw)
    p = {
        "ln": torch.ones((d,), dtype=dtype, device=device),
        "router": {"w": torch.randn((d, mo.n_experts), **kw) * d ** -0.5},
        "w_gate": _packed_experts(mo.n_experts, d, ff, **ex),
        "w_up": _packed_experts(mo.n_experts, d, ff, **ex),
        "w_down": _packed_experts(mo.n_experts, ff, d, **ex),
    }
    if mo.n_shared:
        p["shared_gate"] = qops.init_linear(d, cfg.d_ff * mo.n_shared, **kw)
        p["shared_up"] = qops.init_linear(d, cfg.d_ff * mo.n_shared, **kw)
        p["shared_down"] = qops.init_linear(cfg.d_ff * mo.n_shared, d, **kw)
    if cfg.bitnet.lora_rank and "down" in cfg.bitnet.lora_targets:
        from repro_torch.core import lora as lora_lib

        p["lora_down"] = lora_lib.init(d, d, cfg.bitnet.lora_rank, **kw)
    return p


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    mo = cfg.moe
    c = int(n_tokens * mo.top_k / mo.n_experts * mo.capacity_factor) + 1
    return max(min(c, n_tokens), 1)


def top_k(x: torch.Tensor, k: int):
    """Largest k along the last dim, descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def combine(ye: torch.Tensor, sel_w: torch.Tensor, sel_idx: torch.Tensor,
            gate_idx: torch.Tensor, n_tok: int) -> torch.Tensor:
    """Weighted bfloat16 combine of the expert outputs back to tokens.

    ye (E, C, d) f32, sel_w / sel_idx (E, C): the capacity selection;
    gate_idx (T, k): each token's routed experts. Each token's kept
    contributions ``bf16(ye) * bf16(w)`` are added one at a time in
    ascending expert order (zero-weight selections add nothing). Returns
    (T, d) f32."""
    n_e, cap, d = ye.shape
    dev = ye.device
    contrib = ye.to(torch.bfloat16) * sel_w[..., None].to(torch.bfloat16)  # (E, C, d)
    # slot[t, e]: the capacity slot holding token t in expert e, or -1
    slot = torch.full((n_tok, n_e), -1, dtype=torch.long, device=dev)
    e_idx = torch.arange(n_e, device=dev)[:, None].expand(n_e, cap)
    c_idx = torch.arange(cap, device=dev)[None].expand(n_e, cap)
    kept = sel_w > 0
    slot[sel_idx[kept], e_idx[kept]] = c_idx[kept]
    experts, _ = torch.sort(gate_idx, dim=-1)  # ascending expert order per token
    rows = torch.arange(n_tok, device=dev)
    y = torch.zeros((n_tok, d), dtype=torch.bfloat16, device=dev)
    for j in range(experts.shape[-1]):
        e = experts[:, j]
        c = slot[rows, e]
        part = contrib[e, c.clamp(min=0)]
        y = y + torch.where((c >= 0)[:, None], part, torch.zeros_like(part))
    return y.float()


def _route_tokens(p: dict, h: torch.Tensor, cfg: ModelConfig, cap: int):
    """Dispatch + expert GEMMs + combine for one token group. h: (T, d) ->
    (y (T, d) f32, probs (T, E) f32, top-1 one-hot (T, E))."""
    mo = cfg.moe
    n_tok, d = h.shape
    logits = h.float() @ p["router"]["w"].float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, mo.top_k)  # (T, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)  # renorm
    assign = torch.zeros((n_tok, mo.n_experts), dtype=torch.float32, device=h.device)
    assign[torch.arange(n_tok, device=h.device)[:, None], gate_idx] = gate_vals
    sel_w, sel_idx = top_k(assign.T, cap)  # (E, C)
    xe = h[sel_idx.reshape(-1)].reshape(mo.n_experts, cap, d)
    g, u = qops.expert_fused_linear(p["w_gu"], xe, cfg)
    ye = qops.expert_linear(p["w_down"], F.silu(g) * u, cfg)  # (E, C, d)
    y = combine(ye, sel_w, sel_idx, gate_idx, n_tok)
    top1 = F.one_hot(gate_idx[:, 0], mo.n_experts).float()
    return y, probs, top1


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (b, t, d) -> (y (b, t, d), load-balance aux loss)."""
    mo = cfg.moe
    b, t, d = x.shape
    h3 = rms_norm(x, p["ln"], cfg.norm_eps)
    y, probs, top1 = _route_tokens(p, h3.reshape(b * t, d), cfg, _capacity(b * t, cfg))
    if mo.n_shared:
        # fused packed gate‖up: one act-quant + one kernel launch
        sg, su = qops.fused_linear(p["shared_gu"], h3, cfg)
        shared = qops.linear(p["shared_down"], F.silu(sg) * su, cfg)
        y = y + shared.float().reshape(b * t, d)
    if "lora_down" in p and cfg.bitnet.lora_rank:
        from repro_torch.core import lora as lora_lib

        y = y + lora_lib.apply(p["lora_down"], h3.reshape(b * t, d),
                               alpha=2.0 * cfg.bitnet.lora_rank,
                               weight_bits=cfg.bitnet.lora_bits).float()
    aux = mo.n_experts * (probs.mean(dim=0) * top1.mean(dim=0)).sum() * mo.router_aux_weight
    return y.reshape(b, t, d).to(x.dtype), aux
