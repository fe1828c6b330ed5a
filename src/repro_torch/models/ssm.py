"""Mamba2 (SSD, state-space duality) blocks [arXiv:2405.21060] (reference:
``repro/models/ssm.py``).

The reference leaves the block to XLA: no Pallas kernel. So it is plain
PyTorch here, except its two projections: ``in_proj`` ([z, x, B, C, dt])
and ``out_proj`` are packed ternary leaves through ``qops.linear`` (kernel
1 on the card), and its two RMSNorms go through the rms_norm kernel. The
depthwise causal conv, the SSM scalars (``a_log``, ``d_skip``,
``dt_bias``) and the LoRA adapter ``lora_out`` stay float.

Full sequences (prefill) run the chunked SSD scan (``_ssd_chunked``): the
within-chunk quadratic form plus the recurrence over the chunk-final
states. Decode is the O(1)-state recurrence S <- exp(dt A) S + dt (B x),
y = C S + D x. The recurrent state of one block is ``SSMState``: the SSM
state (b, g, r, p, n) in f32 whatever the params' dtype, and the conv
state, the last d_conv - 1 RAW conv inputs (before the conv and its silu),
(b, d_conv - 1, conv channels) in the params' dtype.

As in the reference, a block returns ``out_proj``'s output alone, with no
residual around it: the stacks (``models/transformer.py``) replace the
hidden state by it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.models import qops
from repro_torch.models.layers import rms_norm


class SSMState(NamedTuple):
    """The recurrent state of a block, or of a stack of blocks with leading
    layer axes before the batch axis."""

    ssm: torch.Tensor  # (..., b, g, r, p, n) f32
    conv: torch.Tensor  # (..., b, d_conv - 1, conv channels), the params' dtype


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    conv_ch = di + 2 * s.n_groups * s.d_state
    return s, di, nh, conv_ch


def init_mamba_block(cfg: ModelConfig, *, generator, device, dtype=torch.float32) -> dict:
    """A block's parameters with the reference init's distributions and
    shapes: the projections N(0, 1/d_in), the conv N(0, 1/d_conv),
    ``a_log`` = log(linspace(1, 16)), ``d_skip`` ones, the rest zeros or
    ones; ``lora_out`` (the SSM analogue of the down projection's adapter)
    when the config adapts ``down``."""
    s, di, nh, conv_ch = _dims(cfg)
    d = cfg.d_model
    kw = dict(generator=generator, device=device, dtype=dtype)
    in_dim = 2 * di + 2 * s.n_groups * s.d_state + nh  # [z, x, B, C, dt]
    p = {
        "ln": torch.ones((d,), dtype=dtype, device=device),
        "in_proj": qops.init_linear(d, in_dim, **kw),
        "conv_w": torch.randn((conv_ch, s.d_conv), **kw) * (s.d_conv ** -0.5),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, device=device).to(dtype)),
        "d_skip": torch.ones((nh,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((nh,), dtype=dtype, device=device),
        "gate_ln": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": qops.init_linear(di, d, **kw),
    }
    if cfg.bitnet.lora_rank and "down" in cfg.bitnet.lora_targets:
        from repro_torch.core import lora as lora_lib

        p["lora_out"] = lora_lib.init(di, d, cfg.bitnet.lora_rank, **kw)
    return p


def _split_in_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    """[z, x, B, C, dt] -> z, the conv input [x, B, C] and dt."""
    s, di, nh, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    return zxbcdt[..., :di], zxbcdt[..., di: 2 * di + 2 * gn], zxbcdt[..., 2 * di + 2 * gn:]


def _causal_conv_full(xc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence, left-padded by k - 1:
    xc (bsz, l, c), w (c, k), b (c,) -> (bsz, l, c)."""
    k = w.shape[1]
    out = F.conv1d(F.pad(xc.transpose(1, 2), (k - 1, 0)), w[:, None, :], groups=w.shape[0])
    return out.transpose(1, 2) + b


def _ssd_chunked(xh, dt_a, bmat, cmat, cfg: ModelConfig, s_init=None):
    """The chunked SSD scan. xh (bsz, l, g, r, p): dt-scaled inputs per head;
    dt_a (bsz, l, g, r): log decays dt A (negative); bmat, cmat (bsz, l, g,
    n). The chunk is ``cfg.ssm.chunk`` capped at l and halved until it
    divides l (a prime length runs chunks of 1). Returns y (bsz, l, g, r, p)
    and the final state (bsz, g, r, p, n) f32."""
    bsz, l, g, r, p = xh.shape
    n = bmat.shape[-1]
    q = min(cfg.ssm.chunk, l)
    while l % q:
        q //= 2
    nc = l // q
    xh = xh.reshape(bsz, nc, q, g, r, p)
    dt_a = dt_a.reshape(bsz, nc, q, g, r)
    bmat = bmat.reshape(bsz, nc, q, g, n)
    cmat = cmat.reshape(bsz, nc, q, g, n)
    # the within-chunk triangle is masked BEFORE exp: the i < j entries have
    # positive exponents that overflow, and exp-then-mask would give inf * 0
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))[None, :, :, None, None]
    state = (s_init if s_init is not None
             else torch.zeros((bsz, g, r, p, n), dtype=torch.float32, device=xh.device))
    ys = []
    for c in range(nc):
        xc, ac, bc, cc = xh[:, c], dt_a[:, c], bmat[:, c], cmat[:, c]
        a_cs = torch.cumsum(ac, dim=1)  # inclusive (bsz, q, g, r)
        diff = a_cs[:, :, None] - a_cs[:, None]  # (bsz, i, j, g, r)
        ldec = torch.exp(torch.where(tri, diff, float("-inf")))
        scores = torch.einsum("bign,bjgn->bijg", cc, bc)
        y_diag = torch.einsum("bijg,bijgr,bjgrp->bigrp", scores, ldec, xc)
        y_off = torch.einsum("bign,bgrpn,bigr->bigrp", cc, state, torch.exp(a_cs))
        a_sum = a_cs[:, -1]  # (bsz, g, r)
        decay = torch.exp(a_sum[:, None] - a_cs)  # (bsz, j, g, r)
        s_chunk = torch.einsum("bjgn,bjgr,bjgrp->bgrpn", bc, decay, xc)
        state = state * torch.exp(a_sum)[..., None, None] + s_chunk
        ys.append(y_diag + y_off)
    return torch.stack(ys, dim=1).reshape(bsz, l, g, r, p), state


def _gated_out(p: dict, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """rms_norm(y * silu(z)) through ``out_proj`` (and ``lora_out``)."""
    y = rms_norm(y * F.silu(z), p["gate_ln"], cfg.norm_eps, impl=cfg.bitnet.impl)
    return qops.linear(p["out_proj"], y, cfg, lora_leaf=p.get("lora_out"))


def apply_mamba_full(p: dict, x: torch.Tensor, cfg: ModelConfig, return_state: bool = False):
    """Full-sequence block: x (bsz, l, d) -> y, and with ``return_state``
    also the final ``SSMState``. A prompt shorter than d_conv - 1 returns
    fewer conv rows, as the reference's slice does: ``apply_mamba_decode``
    refuses that state, and the engine's admission broadcasts its rows
    over the slot's, as the reference's scatter does."""
    s, di, nh, _ = _dims(cfg)
    bsz, l, _ = x.shape
    g, n = s.n_groups, s.d_state
    r = nh // g
    h = rms_norm(x, p["ln"], cfg.norm_eps, impl=cfg.bitnet.impl)
    zxbcdt = qops.linear(p["in_proj"], h, cfg)
    z, xc_raw, dt_raw = _split_in_proj(zxbcdt, cfg)
    xc = F.silu(_causal_conv_full(xc_raw, p["conv_w"], p["conv_b"]))
    xin = xc[..., :di]
    bmat = xc[..., di: di + g * n].reshape(bsz, l, g, n).float()
    cmat = xc[..., di + g * n:].reshape(bsz, l, g, n).float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (bsz, l, nh)
    a = -torch.exp(p["a_log"].float())  # (nh,)
    xheads = xin.reshape(bsz, l, g, r, s.head_dim).float()
    dt_h = dt.reshape(bsz, l, g, r)
    y, final = _ssd_chunked(xheads * dt_h[..., None], dt_h * a.reshape(g, r), bmat, cmat, cfg)
    y = y + xheads * p["d_skip"].reshape(g, r)[None, None, :, :, None]
    out = _gated_out(p, y.reshape(bsz, l, di).to(x.dtype), z, cfg)
    if return_state:
        # the conv state: the last d_conv - 1 RAW conv inputs (pre-conv,
        # pre-silu), by the reference's slice, whose start is negative for
        # a shorter prompt and then counts from the end
        conv = xc_raw[:, l - (s.d_conv - 1):]
        return out, SSMState(final, conv.contiguous())
    return out


def init_mamba_state(bsz: int, cfg: ModelConfig, dtype=torch.float32, device=None,
                     lead: tuple = ()) -> SSMState:
    """Zero state of ``bsz`` slots (with leading layer axes ``lead``)."""
    s, _, nh, conv_ch = _dims(cfg)
    g = s.n_groups
    return SSMState(
        ssm=torch.zeros(lead + (bsz, g, nh // g, s.head_dim, s.d_state), dtype=torch.float32,
                        device=device),
        conv=torch.zeros(lead + (bsz, s.d_conv - 1, conv_ch), dtype=dtype, device=device),
    )


def apply_mamba_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, state: SSMState):
    """One-token recurrent step: x (bsz, d) -> (y, new state)."""
    s, di, nh, _ = _dims(cfg)
    bsz, _ = x.shape
    g, n = s.n_groups, s.d_state
    r = nh // g
    h = rms_norm(x, p["ln"], cfg.norm_eps, impl=cfg.bitnet.impl)
    zxbcdt = qops.linear(p["in_proj"], h, cfg)
    z, xc_new, dt_raw = _split_in_proj(zxbcdt, cfg)
    # the rolling causal conv
    window = torch.cat([state.conv, xc_new[:, None, :]], dim=1)  # (bsz, k, c)
    conv_out = torch.einsum("bkc,ck->bc", window.float(), p["conv_w"].float())
    xc = F.silu(conv_out + p["conv_b"]).to(x.dtype)
    xin = xc[..., :di]
    bvec = xc[..., di: di + g * n].reshape(bsz, g, n).float()
    cvec = xc[..., di + g * n:].reshape(bsz, g, n).float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"]).reshape(bsz, g, r)
    a = -torch.exp(p["a_log"].float()).reshape(g, r)
    xheads = xin.reshape(bsz, g, r, s.head_dim).float()
    decay = torch.exp(dt * a)[..., None, None]  # (bsz, g, r, 1, 1)
    upd = torch.einsum("bgrp,bgn->bgrpn", xheads * dt[..., None], bvec)
    new_ssm = state.ssm * decay + upd
    y = torch.einsum("bgrpn,bgn->bgrp", new_ssm, cvec)
    y = y + xheads * p["d_skip"].reshape(g, r)[None, :, :, None]
    out = _gated_out(p, y.reshape(bsz, di).to(x.dtype), z, cfg)
    return out, SSMState(new_ssm, window[:, 1:])
