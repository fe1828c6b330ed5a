"""Decoder LM: init / prefill / decode with the tiered DR cache, and the
full-sequence forward (reference: ``repro/models/transformer.py``, the
dense, moe, ssm, hybrid, vlm and audio families).

Parameters are a plain dict: ``embed``, ``final_ln``, ``lm_head`` (absent
under ``cfg.tie_embeddings``, where the lm_head is ``embed.T``) and the
layer stacks, lists with one dict per layer (the reference stacks layers
and scans them; here a Python loop walks the list):
  * dense, vlm and audio: ``blocks``, each ``{"attn": ..., "mlp": ...}``;
    vlm and audio also hold ``frontend``, the projection of the patch or
    frame features into d_model (audio: one ``{"w"}`` leaf; vision:
    ``proj1``, gelu, ``proj2``), fake-quantized at pack time (``{"fq"}``)
    and run as float products, as the reference's unpacked leaves are. An
    audio model keeps the reference's unused ``embed``;
  * moe: ``dense_blocks`` (the leading dense-FFN layers, ``{"attn",
    "mlp"}``; absent without any, as in mixtral) then ``moe_blocks``
    (``{"attn", "moe"}``); attention is MLA when ``cfg.attn_type ==
    "mla"``, sliding-window GQA when it is ``"swa"``;
  * ssm: ``blocks``, one Mamba2 block each (``models/ssm.py``);
  * hybrid (zamba2): ``mamba_groups``, a list of groups of
    ``hybrid_attn_every`` Mamba2 blocks (the reference stacks it twice),
    ``mamba_tail`` (the blocks past the last whole group; absent without
    any), ``shared``, ONE ``{"attn", "mlp"}`` block run after every group,
    and ``shared_lora_v``, one v adapter per group, which takes the place
    of the shared block's own ``lora_v`` at that group's invocation.
The decode cache stacks the per-layer caches of each stack along a
leading axis: ``{"attn": TieredKVCache}`` (dense, tiers (L, b, cap, g,
hd), or a ``PagedKVCache`` with pools (L, n_pages, page_size, g, hd)) or
``{"attn_dense", "attn_moe"}`` (moe; ``attn_dense`` only with dense
layers; under MLA the k-slot tiers are (L, b, cap, 576) latent rows and
the v-slot is empty). Under SWA the cache has no hot tier and a ring cold
tier of ``min(swa_window, max_len)`` rows, as in the reference. The
recurrent families keep ``ssm.SSMState``s with leading layer axes:
``{"ssm": (L, b, ...)}`` (ssm), and ``{"mamba": (n_groups, every, b, ...),
"attn": a TieredKVCache of the n_groups shared-block invocations, "tail":
(n_tail, b, ...)}`` (hybrid). Their prefill is the reference's
collect-state forward (its flash-prefill path admits only the
attention-cache families): the Mamba2 blocks' chunked SSD scan and, for the
shared block, ``attention.attention_full`` in plain PyTorch, whose rotated
k / v fill the invocation's cache; decode runs the recurrent step, with
the state of an inactive slot kept as it was, and kernel 2 for the shared
block. As in the reference, a Mamba2 block's output REPLACES the hidden
state: there is no residual around it.

The vlm family is the dense decoder behind its frontend: its prefill
concatenates the ``n_patches`` projected patch rows ahead of the text
embeddings (s = n_patches + text) and runs the dense prefill over them; its
cache and decode step are the dense ones. The audio family is encoder-only:
``forward`` (bidirectional ``attention_full`` over the projected frames)
is its one path, and ``init_decode_cache`` / ``prefill`` refuse it with
the reference's ``ValueError``. ``forward`` runs the attention-stack
families (dense, vlm, audio) in packed mode.

Speculative decoding (``serving/engine.py``) verifies a K-token chunk with
``spec_verify_chunk`` (the chunk step's layers over the no-append form of
attention, the lm_head once per chunk position) and appends what it keeps
with ``spec_commit_chunk``.
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
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import apply_mlp, dtype_const, gelu_tanh, init_mlp, rms_norm
from repro_torch.models.pack import pack_params

DEFAULT_HOT_CAP = 32  # paper: 32 buffered early tokens (S = 128)


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                dtype=torch.float32, pack: bool = False) -> dict:
    """Parameters drawn from a seeded ``torch.Generator`` with the
    reference init's distributions and shapes (embed N(0, 0.02^2),
    projections N(0, 1/d_in), LoRA A N(0, 1/r) and B = 0, norms 1). Float,
    except the routed experts, which come packed (``moe.init_moe``).
    ``pack``: each layer is packed (``pack.pack_params``) as soon as it is
    drawn, so no float copy of the stack exists (mixtral-8x22b's float
    attention projections alone take 20 GB); the result equals
    ``pack_params(init_params(...))``, draw for draw."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm", "audio"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, device=device, dtype=dtype)
    d = cfg.d_model
    params = {
        "embed": {"w": torch.randn((cfg.vocab_size, d), **kw) * 0.02},
        "final_ln": torch.ones((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = qops.init_linear(d, cfg.vocab_size, **kw)
    init_attn = attn.init_mla if cfg.attn_type == "mla" else attn.init_attention

    def done(block: dict) -> dict:
        return pack_params(block, cfg) if pack else block

    if cfg.frontend == "audio":
        params.update(done({"frontend": qops.init_linear(cfg.frontend_dim, d, **kw)}))
    elif cfg.frontend == "vision":
        params.update(done({"frontend": {"proj1": qops.init_linear(cfg.frontend_dim, d, **kw),
                                         "proj2": qops.init_linear(d, d, **kw)}}))

    def mamba(n):
        return [done(ssm_lib.init_mamba_block(cfg, **kw)) for _ in range(n)]

    if cfg.family in ("dense", "vlm", "audio"):
        params["blocks"] = [
            done({"attn": init_attn(cfg, **kw), "mlp": init_mlp(cfg, **kw)})
            for _ in range(cfg.n_layers)
        ]
        return params
    if cfg.family == "ssm":
        params["blocks"] = mamba(cfg.n_layers)
        return params
    if cfg.family == "hybrid":
        ng, nt = hybrid_groups(cfg)
        params["mamba_groups"] = [mamba(cfg.hybrid_attn_every) for _ in range(ng)]
        if nt:
            params["mamba_tail"] = mamba(nt)
        params["shared"] = done({"attn": init_attn(cfg, **kw), "mlp": init_mlp(cfg, **kw)})
        if cfg.bitnet.lora_rank:
            from repro_torch.core import lora as lora_lib

            g, hd = cfg.n_kv_heads, cfg.resolved_head_dim
            params["shared_lora_v"] = [lora_lib.init(d, g * hd, cfg.bitnet.lora_rank, **kw)
                                       for _ in range(ng)]
        return params
    nd = cfg.moe.n_dense_layers
    if nd:
        params["dense_blocks"] = [
            done({"attn": init_attn(cfg, **kw),
                  "mlp": init_mlp(cfg, cfg.moe.d_ff_dense or None, **kw)})
            for _ in range(nd)
        ]
    params["moe_blocks"] = [
        done({"attn": init_attn(cfg, **kw), "moe": moe_lib.init_moe(cfg, **kw)})
        for _ in range(cfg.n_layers - nd)
    ]
    return params


def hybrid_groups(cfg: ModelConfig):
    """(whole groups, tail blocks) of a hybrid model's Mamba2 stack."""
    ng = cfg.n_layers // cfg.hybrid_attn_every
    return ng, cfg.n_layers - ng * cfg.hybrid_attn_every


def layer_stacks(cfg: ModelConfig):
    """(parameter stack, cache stack, layers) of the attention-cache
    families, in the order the layers run; a MoE model without dense
    layers has no dense stack."""
    if cfg.family not in ("dense", "vlm", "moe"):
        raise ValueError(f"the {cfg.family} family has no attention layer stack")
    if cfg.family in ("dense", "vlm"):
        return (("blocks", "attn", cfg.n_layers),)
    nd = cfg.moe.n_dense_layers
    moe = ("moe_blocks", "attn_moe", cfg.n_layers - nd)
    return (("dense_blocks", "attn_dense", nd), moe) if nd else (moe,)


def _attn_cache_spec(cfg: ModelConfig):
    """Per-token shapes of the k- and v-slots: GQA (g, hd) for both; MLA
    the latent row (kv_lora_rank + rope dims,) and an empty v-slot."""
    if cfg.attn_type == "mla":
        return (cfg.mla.kv_cache_dim,), (0,)
    g, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return (g, hd), (g, hd)


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Embedding rows in ``dtype``; under ``cfg.scale_embed`` (gemma) times
    sqrt(d_model), the constant rounded to ``dtype`` before the product as
    in the reference. The tied lm_head reads the unscaled table."""
    x = params["embed"]["w"][tokens.long()].to(dtype)
    if cfg.scale_embed:
        x = x * dtype_const(cfg.d_model ** 0.5, dtype)
    return x


def _frontend_embed(params, cfg: ModelConfig, feats: torch.Tensor) -> torch.Tensor:
    """Frame or patch features (b, n, frontend_dim) -> (b, n, d_model)
    (reference: ``_frontend_embed``): audio one projection, vision
    ``proj1``, gelu (tanh form), ``proj2``; each a fake-quantized float
    product (``qops.linear``'s ``{"fq"}`` leaf)."""
    fe = params["frontend"]
    if cfg.frontend == "audio":
        return qops.linear(fe, feats, cfg)
    return qops.linear(fe["proj2"], gelu_tanh(qops.linear(fe["proj1"], feats, cfg)), cfg)


def _input_embed(params, cfg: ModelConfig, tokens, feats, dtype) -> torch.Tensor:
    """The sequence a model's stack reads: the text embeddings; a vlm's
    projected patches ahead of them; an audio model's projected frames.
    Missing features raise the reference's ``KeyError`` ('frames' /
    'patches')."""
    if cfg.frontend != "none" and feats is None:
        raise KeyError("frames" if cfg.family == "audio" else "patches")
    if cfg.family == "audio":
        return _frontend_embed(params, cfg, feats.to(dtype))
    x = _embed_tokens(params, cfg, tokens, dtype)
    if cfg.family == "vlm":
        x = torch.cat([_frontend_embed(params, cfg, feats.to(dtype)), x], dim=1)
    return x


def _lm_logits(params, cfg: ModelConfig, x: torch.Tensor,
               rows: Optional[int] = None) -> torch.Tensor:
    """The float lm_head: a plain matmul (outside any kernel in the
    reference too), ``x @ embed.T`` in x's dtype when the config ties its
    embeddings. ``rows`` pads x (M, d) with zero rows to that many
    first: a GEMM library picks its algorithm, and so a row's sum order,
    by M (on the H100 every M >= 2 gave other logits than M = 1), so the
    engine runs every lm_head of a serve at its slot count."""
    m = x.shape[0]
    if rows is not None and rows > m:
        x = torch.cat([x, x.new_zeros((rows - m,) + tuple(x.shape[1:]))])
    if cfg.tie_embeddings:
        return (x @ params["embed"]["w"].T.to(x.dtype)).float()[:m]
    return qops.linear(params["lm_head"], x, cfg).float()[:m]


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      hot_cap: int = DEFAULT_HOT_CAP, dtype=torch.float32,
                      device=None, paged: bool = False, page_size: int = 32,
                      n_pages: Optional[int] = None) -> dict:
    """Empty stacked cache per layer stack: hot tier min(hot_cap,
    max_len), cold the rest; under SWA no hot tier and a ring of
    min(swa_window, max_len) rows. With ``paged`` the cold tier is a pool
    of ``n_pages`` pages of ``page_size`` rows per layer
    (``kv_cache.PagedKVCache``); a page id names the same pool page in
    every layer, so the engine keeps one host-side page account. The
    tiers are in ``dtype``, or fp8 (e4m3) under ``cfg.bitnet.kv_fp8``
    whatever the layout; the recurrent families' zero states
    (``ssm.init_mamba_state``) keep ``dtype``. The encoder-only audio
    family has none: ``ValueError(family)``, as in the reference
    (``init_decode_cache``)."""

    if cfg.family == "audio":
        raise ValueError(cfg.family)  # encoder-only: no decode cache

    def attn(n):
        return _attn_cache(cfg, batch, max_len, hot_cap, dtype, device, n, paged, page_size,
                           n_pages)

    def state(*lead):
        return ssm_lib.init_mamba_state(batch, cfg, dtype, device, lead=lead)

    if cfg.family == "ssm":
        return {"ssm": state(cfg.n_layers)}
    if cfg.family == "hybrid":
        ng, nt = hybrid_groups(cfg)
        out = {"mamba": state(ng, cfg.hybrid_attn_every), "attn": attn(ng)}
        if nt:
            out["tail"] = state(nt)
        return out
    return {cname: attn(n) for _, cname, n in layer_stacks(cfg)}


def _attn_cache(cfg: ModelConfig, batch: int, max_len: int, hot_cap: int, dtype, device,
                n: int, paged: bool = False, page_size: int = 32,
                n_pages: Optional[int] = None):
    """One attention stack of ``n`` layers (``init_decode_cache``)."""
    if cfg.bitnet.kv_fp8:
        dtype = kvc.FP8
    hc = min(hot_cap, max_len)
    cc = max_len - hc
    if cfg.attn_type == "swa":
        hc, cc = 0, min(cfg.swa_window, max_len)
    kshape, vshape = _attn_cache_spec(cfg)
    if paged:
        if cfg.attn_type == "swa":
            raise NotImplementedError("a paged cold tier has no ring layout (SWA archs), "
                                      "as in the reference")
        return kvc.init_paged_cache(batch, hc, cc, kshape, dtype, page_size=page_size,
                                    n_pages=n_pages, device=device, lead=(n,),
                                    v_shape=vshape)
    return kvc.init_cache(batch, hc, cc, kshape, dtype, device=device, lead=(n,),
                          v_shape=vshape)


def batch_axis(cname: str) -> int:
    """The batch axis of every tensor of the cache stack ``cname``: after
    its leading layer axes, two for the hybrid family's grouped Mamba2
    state, one elsewhere."""
    return 2 if cname == "mamba" else 1


def _attn_block_prefill(bp: dict, x: torch.Tensor, cfg: ModelConfig,
                        cache: kvc.TieredKVCache,
                        n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One block: full-prompt attention straight into its cache rows (or,
    with ``n_valid``, a prompt chunk appended to the live cache rows), then
    the MLP or MoE."""
    if n_valid is not None:
        y, _ = attn.attention_prefill_chunk(bp["attn"], x, cfg, cache, n_valid)
    else:
        f = attn.mla_prefill if cfg.attn_type == "mla" else attn.attention_prefill
        y, _ = f(bp["attn"], x, cfg, cache)
    return _ffn(bp, x + y, cfg)


def _ffn(bp: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The block's residual MLP or MoE over (b, s, d_model)."""
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


def _shared_block(params: dict, gi: int) -> dict:
    """The hybrid family's shared block as group ``gi`` invokes it: with
    that group's v adapter in place of its own ``lora_v``."""
    sp = params["shared"]
    if "shared_lora_v" in params:
        sp = {"attn": {**sp["attn"], "lora_v": params["shared_lora_v"][gi]}, "mlp": sp["mlp"]}
    return sp


def _stack_states(states) -> ssm_lib.SSMState:
    return ssm_lib.SSMState(*(torch.stack(f) for f in zip(*states)))


def _recurrent_prefill(params: dict, cfg: ModelConfig, x: torch.Tensor, max_len: int,
                       hot_cap: int):
    """The ssm / hybrid prefill (reference: ``forward(collect_kv=True)``,
    ``_hybrid_forward``, then ``prefill``'s fills): every Mamba2 block's
    full-sequence scan with its final state; the hybrid's shared block
    after each group through ``attention_full``, its rotated k / v placed
    into the invocation's fresh cache. Returns (hidden, cache); the
    states are the blocks' own (a prompt shorter than d_conv - 1 gives a
    shorter conv state, as in the reference)."""

    def blocks(x, stack):
        states = []
        for bp in stack:
            x, st = ssm_lib.apply_mamba_full(bp, x, cfg, return_state=True)
            states.append(st)
        return x, _stack_states(states)

    if cfg.family == "ssm":
        x, st = blocks(x, params["blocks"])
        return x, {"ssm": st}
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    cache = {"attn": _attn_cache(cfg, b, max_len, hot_cap, x.dtype, x.device,
                                 len(params["mamba_groups"]))}
    groups = []
    for gi, group in enumerate(params["mamba_groups"]):
        x, st = blocks(x, group)
        groups.append(st)
        sp = _shared_block(params, gi)
        y, (k, v) = attn.attention_full(sp["attn"], x, cfg, positions, return_kv=True)
        kvc.fill_fresh(kvc.layer(cache["attn"], gi), k, v)
        x = _ffn(sp, x + y, cfg)
    cache = {"mamba": _stack_states(groups), **cache}
    if "mamba_tail" in params:
        x, cache["tail"] = blocks(x, params["mamba_tail"])
    return x, cache


def forward(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Full-sequence forward in packed mode (reference: ``forward(mode=
    "packed")`` with ``_attn_block_fwd``) of the attention-stack families:
    ``batch`` holds ``"tokens"`` (b, s) and / or the features
    ``"frames"`` (audio) or ``"patches"`` (vlm, ahead of the tokens); the
    blocks run ``attention_full`` (bidirectional for an encoder) and the
    MLP, then ``final_ln`` and the lm_head. Returns (b, s, vocab) f32
    logits."""
    if cfg.family not in ("dense", "vlm", "audio") or cfg.attn_type != "full":
        raise NotImplementedError(
            f"forward of {cfg.name} (family {cfg.family}, attention {cfg.attn_type}): the "
            "full-sequence MoE, MLA (mla_full), SWA and Mamba2 stacks are not ported")
    feats = batch.get("frames" if cfg.family == "audio" else "patches")
    x = _input_embed(params, cfg, batch.get("tokens"), feats, params["final_ln"].dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for bp in params["blocks"]:
        x = _ffn(bp, x + attn.attention_full(bp["attn"], x, cfg, positions), cfg)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps, impl=cfg.bitnet.impl)
    return _lm_logits(params, cfg, x)


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            hot_cap: int = DEFAULT_HOT_CAP, max_len: Optional[int] = None,
            logit_rows: Optional[int] = None, patches: Optional[torch.Tensor] = None):
    """Prompt (b, s) -> (last-token logits (b, V) f32, filled cache).

    The per-layer flash-prefill loop of the reference's ``_prefill_flash``:
    each layer's attention fills its cache rows, then its MLP or MoE runs;
    the ssm and hybrid families run ``_recurrent_prefill``. A vlm's
    ``patches`` (b, n_patches, frontend_dim) are projected and
    concatenated ahead of the text, so the sequence is n_patches + s long;
    the audio family has no prefill (the reference's ``ValueError``).
    ``logit_rows``: the lm_head's row count (``_lm_logits``)."""
    if cfg.family == "audio":
        raise ValueError("encoder-only arch has no decode/prefill phase")
    b, s = tokens.shape
    if cfg.family == "vlm":
        s += cfg.n_patches
    if max_len is None:
        max_len = s + cfg.decode_headroom
    dtype = params["final_ln"].dtype
    x = _input_embed(params, cfg, tokens, patches, dtype)
    if cfg.family in ("ssm", "hybrid"):
        x, cache = _recurrent_prefill(params, cfg, x, max_len, hot_cap)
    else:
        cache = init_decode_cache(cfg, b, max_len, hot_cap, dtype=dtype, device=x.device)
        for pname, cname, _ in layer_stacks(cfg):
            for i, bp in enumerate(params[pname]):
                x = _attn_block_prefill(bp, x, cfg, kvc.layer(cache[cname], i))
    x_last = rms_norm(x[:, -1], params["final_ln"], cfg.norm_eps, impl=cfg.bitnet.impl)
    return _lm_logits(params, cfg, x_last, logit_rows), cache


def prefill_chunk_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
                       n_valid: torch.Tensor):
    """One chunked-prefill dispatch over the live slot state: tokens
    (slots, C), one prompt chunk per slot, of which ``n_valid[b]`` rows are
    real (0: the slot is not prefilling). Each slot's rows are appended at
    its own ``cache.lengths`` offset, in place, in every layer. Returns the
    logits at each slot's last valid row (slots, V) f32 (meaningless for
    idle slots) and the cache. Every shape is fixed by (slots, C),
    whatever the prompt lengths."""
    x = _embed_tokens(params, cfg, tokens, params["final_ln"].dtype)  # (slots, C, d)
    for pname, cname, _ in layer_stacks(cfg):
        for i, bp in enumerate(params[pname]):
            x = _attn_block_prefill(bp, x, cfg, kvc.layer(cache[cname], i), n_valid)
    idx = (n_valid.long() - 1).clamp(0, tokens.shape[1] - 1)
    x_last = x[torch.arange(x.shape[0], device=x.device), idx]
    x_last = rms_norm(x_last, params["final_ln"], cfg.norm_eps, impl=cfg.bitnet.impl)
    return _lm_logits(params, cfg, x_last), cache


def spec_verify_chunk(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
                      n_valid: torch.Tensor):
    """Speculative verification (reference: ``spec_verify_chunk``): score a
    K-token chunk (slots, K), the pending token then the draft's
    proposals, against the live cache without appending. Each layer runs
    the chunk step's attention in its no-append form and keeps the rotated
    k / v. Returns ``(logits, kvs)``: the target's logits after every
    chunk position (slots, K, V) f32, and per cache stack a list of one
    ``(k, v)`` (slots, K, g, hd) per layer, for ``spec_commit_chunk``.

    The lm_head runs once per chunk position over the slots' rows, as in
    the decode step: a GEMM's rows change with M on the card, and a single
    lm_head over slots x K rows would give logits other than the decode
    step's. Every other op is per row (the ternary projections' int32
    accumulators and per-row act-quant, the fixed-order LoRA and rms_norm
    kernels, attention over absolute 32-key tiles), so row j equals the
    decode step's logits for the same token bit for bit."""
    x = _embed_tokens(params, cfg, tokens, params["final_ln"].dtype)  # (slots, K, d)
    kvs = {}
    for pname, cname, _ in layer_stacks(cfg):
        kvs[cname] = []
        for i, bp in enumerate(params[pname]):
            y, kv = attn.attention_prefill_chunk(bp["attn"], x, cfg, kvc.layer(cache[cname], i),
                                                 n_valid, append=False)
            x = _ffn(bp, x + y, cfg)
            kvs[cname].append(kv)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps, impl=cfg.bitnet.impl)
    logits = torch.stack([_lm_logits(params, cfg, x[:, j].contiguous())
                          for j in range(x.shape[1])], dim=1)
    return logits, kvs


def spec_commit_chunk(cfg: ModelConfig, cache: dict, kvs: dict, n_commit: torch.Tensor) -> dict:
    """Append the first ``n_commit[b]`` verified rows of each slot to every
    layer's cache, in place (reference: ``spec_commit_chunk``), tiered or
    paged. A linear layout may commit the whole chunk and roll back with
    ``kv_cache.truncate``; a ring must commit only what it keeps."""
    ring = cfg.attn_type == "swa"
    for cname, layers in kvs.items():
        for i, (k, v) in enumerate(layers):
            kvc.append(kvc.layer(cache[cname], i), k, v, valid=n_commit, ring=ring)
    return cache


def _mamba_decode(params_stack, cfg: ModelConfig, x: torch.Tensor,
                  state: ssm_lib.SSMState, active) -> torch.Tensor:
    """One decode step through a stack of Mamba2 blocks; each block's new
    state is written in place, where ``active`` (the state of an inactive
    slot stays as it was: reference ``_mask_state``)."""
    for i, bp in enumerate(params_stack):
        old = kvc.layer(state, i)
        x, new = ssm_lib.apply_mamba_decode(bp, x, cfg, old)
        for o, n in zip(old, new):
            if active is not None:
                n = torch.where(active.reshape((-1,) + (1,) * (n.ndim - 1)), n, o)
            o.copy_(n)
    return x


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache: dict,
                active: Optional[torch.Tensor] = None):
    """One token for every slot: tokens (b,) -> (logits (b, V) f32, cache).
    ``active`` (b,) bool gates the KV appends and the recurrent state
    updates per slot (in place)."""
    x = _embed_tokens(params, cfg, tokens, params["final_ln"].dtype)  # (b, d)
    if cfg.family == "ssm":
        x = _mamba_decode(params["blocks"], cfg, x, cache["ssm"], active)
    elif cfg.family == "hybrid":
        for gi, group in enumerate(params["mamba_groups"]):
            x = _mamba_decode(group, cfg, x, kvc.layer(cache["mamba"], gi), active)
            x = _attn_block_decode(_shared_block(params, gi), x, cfg,
                                   kvc.layer(cache["attn"], gi), active)
        if "tail" in cache:
            x = _mamba_decode(params["mamba_tail"], cfg, x, cache["tail"], active)
    else:
        for pname, cname, _ in layer_stacks(cfg):
            for i, bp in enumerate(params[pname]):
                x = _attn_block_decode(bp, x, cfg, kvc.layer(cache[cname], i), active)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps, impl=cfg.bitnet.impl)
    return _lm_logits(params, cfg, x), cache
