"""Two-tier (DR eDRAM-style) KV cache with per-slot lengths, contiguous
tier only (reference: ``repro/core/kv_cache.py``).

  hot_k/hot_v   : (batch, hot_cap, g, d)   the first ``hot_cap`` tokens
  cold_k/cold_v : (batch, cold_cap, g, d)  the rest
  lengths       : (batch,) int32           tokens written, per slot

The serving path stacks one cache per layer along a leading axis
(``layer`` returns a view of one layer). Unlike the reference, whose
arrays are immutable, the appends here write the tier buffers and
``lengths`` IN PLACE: a decode step then moves one row per slot instead
of copying the cache.

The traffic ledger (``step_traffic_tokens``, ``prompt_traffic_tokens``)
counts KV accesses in token units per slot; summed over a sequence it
reconciles exactly with ``dr_edram.closed_form_reduction``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

NEG_INF = torch.finfo(torch.float32).min


class TieredKVCache(NamedTuple):
    hot_k: torch.Tensor
    hot_v: torch.Tensor
    cold_k: torch.Tensor
    cold_v: torch.Tensor
    lengths: torch.Tensor  # (batch,) int32

    @property
    def hot_cap(self) -> int:
        return self.hot_k.shape[-3]

    @property
    def cold_cap(self) -> int:
        return self.cold_k.shape[-3]

    @property
    def capacity(self) -> int:
        return self.hot_cap + self.cold_cap


def init_cache(batch: int, hot_cap: int, cold_cap: int, kv_shape: Sequence[int],
               dtype=torch.float32, device=None, lead: tuple = ()) -> TieredKVCache:
    """Zeroed cache; ``lead`` prepends stacking dims (one cache per layer)."""
    lead = tuple(lead)
    shape_hot = lead + (batch, hot_cap) + tuple(kv_shape)
    shape_cold = lead + (batch, cold_cap) + tuple(kv_shape)
    return TieredKVCache(
        hot_k=torch.zeros(shape_hot, dtype=dtype, device=device),
        hot_v=torch.zeros(shape_hot, dtype=dtype, device=device),
        cold_k=torch.zeros(shape_cold, dtype=dtype, device=device),
        cold_v=torch.zeros(shape_cold, dtype=dtype, device=device),
        lengths=torch.zeros(lead + (batch,), dtype=torch.int32, device=device),
    )


def layer(stack: TieredKVCache, i: int) -> TieredKVCache:
    """View of layer ``i`` of a stacked cache (writes go to the stack)."""
    return TieredKVCache(*(t[i] for t in stack))


def append_decode(cache: TieredKVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                  active: Optional[torch.Tensor] = None) -> TieredKVCache:
    """Append one token (batch, g, d) per slot at its own length, in place.

    ``active`` (batch,) bool gates the write per slot: inactive slots keep
    their rows and length. Positions past the capacity clip to the last
    row, as in the reference."""
    b = cache.lengths.shape[0]
    pos = cache.lengths.long()
    act = (torch.ones(b, dtype=torch.bool, device=pos.device) if active is None
           else active.bool())
    rows = torch.arange(b, device=pos.device)
    in_hot = pos < cache.hot_cap

    def upd(tier, new, tier_pos, write):
        cap = tier.shape[1]
        if cap == 0:
            return
        idx = tier_pos.clamp(0, cap - 1)
        mask = (write & act).reshape((b,) + (1,) * (tier.ndim - 2))
        tier[rows, idx] = torch.where(mask, new.to(tier.dtype), tier[rows, idx])

    upd(cache.hot_k, k_new, pos, in_hot)
    upd(cache.hot_v, v_new, pos, in_hot)
    upd(cache.cold_k, k_new, pos - cache.hot_cap, ~in_hot)
    upd(cache.cold_v, v_new, pos - cache.hot_cap, ~in_hot)
    cache.lengths.add_(act.to(cache.lengths.dtype))
    return cache


def fill_fresh(cache: TieredKVCache, k_new: torch.Tensor,
               v_new: torch.Tensor) -> TieredKVCache:
    """Place an aligned full prompt (batch, s, g, d) — already rotated and
    in the tier dtype — into a fresh cache with static slices, in place."""
    s = k_new.shape[1]
    n_h = min(s, cache.hot_cap)
    n_c = min(s - n_h, cache.cold_cap)
    if n_h:
        cache.hot_k[:, :n_h] = k_new[:, :n_h].to(cache.hot_k.dtype)
        cache.hot_v[:, :n_h] = v_new[:, :n_h].to(cache.hot_v.dtype)
    if n_c:
        cache.cold_k[:, :n_c] = k_new[:, n_h:n_h + n_c].to(cache.cold_k.dtype)
        cache.cold_v[:, :n_c] = v_new[:, n_h:n_h + n_c].to(cache.cold_v.dtype)
    cache.lengths.fill_(s)
    return cache


# ---------------------------------------------------------------------------
# Plain tiered attention read: per-tier partials + streaming-softmax merge
# ---------------------------------------------------------------------------


def valid_masks(cache: TieredKVCache):
    """Per-slot validity of each tier row: (b, hot_cap), (b, cold_cap) bool."""
    lengths = cache.lengths.long()
    dev = lengths.device
    hot_valid = torch.arange(cache.hot_cap, device=dev)[None] < lengths[:, None]
    n_cold = (lengths - cache.hot_cap).clamp(0, cache.cold_cap)
    cold_valid = torch.arange(cache.cold_cap, device=dev)[None] < n_cold[:, None]
    return hot_valid, cold_valid


def tier_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor, scale: float):
    """Partial attention over one tier.

    q: (b, h, d); k/v: (b, s, g, d); valid: (b, s) bool. Returns
    (numerator (b, h, dv), denominator (b, h), max (b, h)), all f32. v is
    zeroed at invalid rows before the product: p = 0 there, but 0 * NaN
    is NaN, and a masked row may hold anything."""
    b, s, g, d = k.shape
    h = q.shape[1]
    dv = v.shape[-1]
    if s == 0:
        return (q.new_zeros((b, h, dv), dtype=torch.float32),
                q.new_zeros((b, h), dtype=torch.float32),
                q.new_full((b, h), NEG_INF, dtype=torch.float32))
    rep = h // g
    qg = q.reshape(b, g, rep, d).float()
    kf = k.float()
    vf = torch.where(valid[:, :, None, None], v.float(), 0.0)
    logits = torch.einsum("bgrd,bsgd->bgrs", qg, kf) * scale
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None]) * valid[:, None, None, :]
    denom = p.sum(dim=-1)
    num = torch.einsum("bgrs,bsgd->bgrd", p, vf)
    return num.reshape(b, h, dv), denom.reshape(b, h), m.reshape(b, h)


def merge_partials(parts):
    """Streaming-softmax merge of (num, den, max) partials -> (b, h, dv)."""
    num, den, m = parts[0]
    for n2, d2, m2 in parts[1:]:
        m_new = torch.maximum(m, m2)
        a1 = torch.exp(m - m_new) * (den > 0)
        a2 = torch.exp(m2 - m_new) * (d2 > 0)
        num = num * a1[..., None] + n2 * a2[..., None]
        den = den * a1 + d2 * a2
        m = m_new
    return num / torch.clamp(den, min=1e-30)[..., None]


def tiered_decode_attention(q: torch.Tensor, cache: TieredKVCache,
                            scale: float | None = None) -> torch.Tensor:
    """One-token attention over both tiers. q: (b, h, d) -> (b, h, d).
    A slot with length 0 returns zeros."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    hot_valid, cold_valid = valid_masks(cache)
    out = merge_partials([
        tier_partial(q, cache.hot_k, cache.hot_v, hot_valid, scale),
        tier_partial(q, cache.cold_k, cache.cold_v, cold_valid, scale),
    ])
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# DR-traffic ledger (token units)
# ---------------------------------------------------------------------------

TRAFFIC_KEYS = ("ondie_read", "ext_read", "ondie_write", "ext_write")


def external_reduction(traffic: dict) -> float:
    """Fraction of accesses kept on-die, from a 4-key traffic ledger."""
    ext = traffic["ext_read"] + traffic["ext_write"]
    total = ext + traffic["ondie_read"] + traffic["ondie_write"]
    return 1.0 - ext / total if total else 0.0


def step_traffic_tokens(lengths: torch.Tensor, hot_cap: int) -> dict:
    """Per-slot ledger of one decode step at the pre-append ``lengths``."""
    lengths = lengths.to(torch.int32)
    ext_w = (lengths >= hot_cap).to(torch.int32)
    return {
        "ondie_read": torch.clamp(lengths, max=hot_cap),
        "ext_read": torch.clamp(lengths - hot_cap, min=0),
        "ondie_write": 1 - ext_w,
        "ext_write": ext_w,
    }


def prompt_traffic_tokens(prompt_len: int, hot_cap: int) -> dict:
    """Closed-form prompt-phase ledger: the sum of ``step_traffic_tokens``
    over lengths 0..prompt_len-1."""
    p, b = prompt_len, hot_cap
    if p <= b:
        ondie_read = p * (p - 1) // 2
        ext_read = 0
    else:
        ondie_read = b * (b - 1) // 2 + (p - b) * b
        ext_read = (p - b - 1) * (p - b) // 2
    return {
        "ondie_read": ondie_read,
        "ext_read": ext_read,
        "ondie_write": min(p, b),
        "ext_write": max(p - b, 0),
    }


def prompt_traffic_tokens_resumed(prompt_len: int, prefix_len: int,
                                  hot_cap: int) -> dict:
    """Prompt-phase ledger when the first ``prefix_len`` tokens were
    restored from a shared prefix instead of prefilled; the hot part of
    the restored prefix is reloaded from external memory."""
    full = prompt_traffic_tokens(prompt_len, hot_cap)
    skipped = prompt_traffic_tokens(min(prefix_len, prompt_len), hot_cap)
    out = {k: full[k] - skipped[k] for k in TRAFFIC_KEYS}
    reload_hot = min(prefix_len, hot_cap)
    out["ext_read"] += reload_hot
    out["ondie_write"] += reload_hot
    return out
