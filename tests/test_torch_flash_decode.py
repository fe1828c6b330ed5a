"""Port parity for GQA flash decode — the fused-RoPE form and the
post-append form — and the contiguous tiered KV cache
(repro_torch.kernels.flash_decode, core.kv_cache) against the reference's
``_flash_gqa_fused`` and ``_flash_gqa`` Pallas kernels (interpret mode)
and their XLA paths (rotate -> append -> tiered attention, and the tiered
attention alone).

Cache writes are copies, so appends must match bit for bit. The attention
output is f32 arithmetic in another order (tiles and halving trees here,
the reference's blocks there) and RoPE's cos / sin differ by an ulp
between the frameworks, so outputs and the rotated k are held to
TOL = 2e-5 (the reference's own flash-decode tolerance). The CUDA kernel
runs only on a card: ``cuda``-marked tests hold it against the plain
version there, bit for bit, and skip here; on the CPU a torch model of
the kernel's schedule is held against the plain version bit for bit.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.core import kv_cache as kvc
from repro_torch.core.kv_cache import NEG_INF
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import flash_prefill as fp
from repro_torch.models.layers import apply_rope, rope_cos_sin
from test_torch_paged import LENGTHS, _card_pair, _shuffle_pages
from test_torch_threads import share_cpu_threads  # noqa: F401 (autouse: torch threads per worker)

TOL = dict(rtol=2e-5, atol=2e-5)
THETA = 1_000_042.0


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import kv_cache as jkvc
    from repro.kernels import flash_decode as jfd

    return types.SimpleNamespace(jnp=jnp, kvc=jkvc, fd=jfd)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _history(seed, b, t, g, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, g, d)).astype(np.float32),
            rng.standard_normal((b, t, g, d)).astype(np.float32))


def _build(lens, hot, cold, g=2, d=16, seed=0, jref=None):
    """Port cache (and the reference's, when ``jref``) filled through
    active-masked decode appends — the serving write path."""
    b = len(lens)
    ks, vs = _history(seed, b, max(max(lens), 1), g, d)
    cache = kvc.init_cache(b, hot, cold, (g, d))
    jcache = jref.kvc.init_cache(b, hot, cold, (g, d), jref.jnp.float32) if jref else None
    for t in range(max(lens)):
        act = np.asarray([t < n for n in lens])
        kvc.append_decode(cache, torch.from_numpy(ks[:, t]), torch.from_numpy(vs[:, t]),
                          active=torch.from_numpy(act))
        if jref:
            jcache = jref.kvc.append_decode(jcache, jref.jnp.asarray(ks[:, t]),
                                            jref.jnp.asarray(vs[:, t]),
                                            active=jref.jnp.asarray(act))
    return cache, jcache


def _tiered(jcache):
    return kvc.TieredKVCache(*(torch.from_numpy(np.asarray(a).copy()) for a in jcache))


@pytest.mark.parametrize("lens,hot,cold", [
    ([0, 1, 4, 5, 16], 4, 12),  # empty slot, hot edge, first cold row, full
    ([3, 9, 40, 70], 8, 64),  # multi-tile cold tier
])
def test_append_decode_bit_identical(jref, lens, hot, cold):
    cache, jcache = _build(lens, hot, cold, jref=jref)
    for got, want in zip(cache, jcache):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("lens,hot,cold,active,h,g,d", [
    ([0, 1, 4, 5, 15], 4, 12, [False, True, True, True, True], 4, 2, 16),
    ([3, 9, 40, 70], 8, 64, [True, False, True, True], 4, 2, 16),
    ([2, 33, 34, 60], 32, 96, [True, True, True, True], 4, 2, 16),
    ([0, 33, 80, 31], 32, 96, [False, True, True, True], 8, 4, 256),  # falcon3-1b's heads
])
def test_fused_decode_matches_pallas_and_xla(jref, lens, hot, cold, active, h, g, d):
    b = len(lens)
    _, jcache = _build(lens, hot, cold, g, d, jref=jref)
    rng = np.random.default_rng(sum(lens))
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kn = rng.standard_normal((b, g, d)).astype(np.float32)
    vn = rng.standard_normal((b, g, d)).astype(np.float32)
    act = np.asarray(active)
    jargs = dict(k_new=jref.jnp.asarray(kn), v_new=jref.jnp.asarray(vn),
                 active=jref.jnp.asarray(act), rope_theta=THETA)
    o_p, k_p = jref.fd.flash_decode_attention(jref.jnp.asarray(q), jcache, impl="pallas",
                                              interpret=True, **jargs)
    o_x, k_x = jref.fd.flash_decode_attention(jref.jnp.asarray(q), jcache, impl="xla", **jargs)
    o, k_rot = fd.flash_decode_attention(
        torch.from_numpy(q), _tiered(jcache), k_new=torch.from_numpy(kn),
        v_new=torch.from_numpy(vn), active=torch.from_numpy(act), rope_theta=THETA)
    for want_o, want_k in ((o_p, k_p), (o_x, k_x)):
        np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
        np.testing.assert_allclose(k_rot.numpy(), np.asarray(want_k), **TOL)
    if lens[0] == 0 and not active[0]:
        assert not o[0].any()  # unadmitted slot: zeros


def test_plain_decode_skips_rows_past_length():
    """Rows at or past a slot's length may hold anything (NaN here): the
    plain version masks them before every product."""
    lens = [0, 3, 20]
    cache, _ = _build(lens, 4, 28)
    hot_valid, cold_valid = kvc.valid_masks(cache)
    poisoned = kvc.TieredKVCache(
        torch.where(hot_valid[:, :, None, None], cache.hot_k, float("nan")),
        torch.where(hot_valid[:, :, None, None], cache.hot_v, float("nan")),
        torch.where(cold_valid[:, :, None, None], cache.cold_k, float("nan")),
        torch.where(cold_valid[:, :, None, None], cache.cold_v, float("nan")),
        cache.lengths)
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((3, 4, 16)).astype(np.float32))
    kn = torch.from_numpy(rng.standard_normal((3, 2, 16)).astype(np.float32))
    act = torch.tensor([False, True, True])
    clean = fd.flash_decode_attention(q, cache, k_new=kn, v_new=kn, active=act, rope_theta=THETA)
    dirty = fd.flash_decode_attention(q, poisoned, k_new=kn, v_new=kn, active=act,
                                      rope_theta=THETA)
    assert torch.equal(clean[0], dirty[0]) and torch.isfinite(dirty[0]).all()


def test_tiered_decode_attention_matches_reference(jref):
    lens = [0, 2, 9, 30]
    _, jcache = _build(lens, 8, 24, jref=jref)
    q = np.random.default_rng(1).standard_normal((4, 4, 16)).astype(np.float32)
    want = np.asarray(jref.kvc.tiered_decode_attention(jref.jnp.asarray(q), jcache))
    got = kvc.tiered_decode_attention(torch.from_numpy(q), _tiered(jcache))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_tree_sum_is_the_halving_order():
    x = torch.tensor([1e8, 1.0, -1e8, 1.0, 3.0], dtype=torch.float32)
    # padded to 8: ((x0 + x4) + (x2 + x6)) + ((x1 + x5) + (x3 + x7))
    want = ((x[0] + x[4]) + x[2]) + (x[1] + x[3])
    assert torch.equal(fd.tree_sum(x, 0), want)


def test_only_the_fused_form_is_ported():
    """Since the post-append form is ported too, what stays refused is a
    half-given fused form: k_new without v_new or rope_theta, or the fused
    form's arguments without k_new."""
    cache, _ = _build([1], 2, 2)
    q, kn = torch.zeros(1, 4, 16), torch.zeros(1, 2, 16)
    assert fd.flash_decode_attention(q, cache).shape == (1, 4, 16)
    for kw in (dict(k_new=kn), dict(k_new=kn, v_new=kn), dict(k_new=kn, rope_theta=THETA),
               dict(v_new=kn), dict(rope_theta=THETA)):
        with pytest.raises(ValueError):
            fd.flash_decode_attention(q, cache, **kw)
    with pytest.raises(ValueError):
        fd.flash_decode_attention(q, cache, impl="pallas")


@pytest.mark.parametrize("lens,hot,cold,h,g,d", [
    ([1, 4, 2, 3], 4, 12, 4, 2, 16),  # hot tier only
    ([0, 3, 9, 16], 4, 12, 4, 2, 16),  # length-0 slot, hot edge, cold rows, full
    ([5, 40, 70, 33], 8, 64, 4, 2, 16),  # several cold tiles
    ([0, 33, 81, 128], 32, 96, 8, 4, 256),  # falcon3-1b's heads, up to a full cache
])
def test_post_append_decode_matches_pallas_and_xla(jref, lens, hot, cold, h, g, d):
    b = len(lens)
    _, jcache = _build(lens, hot, cold, g, d, jref=jref)
    q = np.random.default_rng(sum(lens) + 7).standard_normal((b, h, d)).astype(np.float32)
    want_p = np.asarray(jref.fd.flash_decode_attention(jref.jnp.asarray(q), jcache,
                                                       impl="pallas", interpret=True))
    want_x = np.asarray(jref.fd.flash_decode_attention(jref.jnp.asarray(q), jcache, impl="xla"))
    got = fd.flash_decode_attention(torch.from_numpy(q), _tiered(jcache))
    assert got.shape == (b, h, d) and got.dtype == torch.float32
    for want in (want_p, want_x):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    for i, n in enumerate(lens):
        if n == 0:
            assert not got[i].any()  # length-0 slot: exact zeros


def test_post_append_plain_skips_rows_past_length():
    lens = [0, 5, 20]
    cache, _ = _build(lens, 4, 28)
    hot_valid, cold_valid = kvc.valid_masks(cache)
    poisoned = kvc.TieredKVCache(
        *(torch.where(m[:, :, None, None], t, float("nan"))
          for t, m in ((cache.hot_k, hot_valid), (cache.hot_v, hot_valid),
                       (cache.cold_k, cold_valid), (cache.cold_v, cold_valid))),
        cache.lengths)
    q = torch.from_numpy(np.random.default_rng(8).standard_normal((3, 4, 16)).astype(np.float32))
    clean = fd.flash_decode_attention(q, cache)
    dirty = fd.flash_decode_attention(q, poisoned)
    assert torch.equal(clean, dirty) and not dirty[0].any()


def test_fused_form_is_post_append_form_after_the_append():
    """The fused form over the pre-append cache and the post-append form
    over the cache after the append (f32 tiers, so the appended key is the
    fused form's rotated k) see the same keys in the same absolute tiles,
    the pending token at its position: they agree bit for bit."""
    lens = [0, 3, 31, 40]
    cache, _ = _build(lens, 8, 56, seed=9)
    rng = np.random.default_rng(10)
    q, kn, vn = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((4, 4, 16), (4, 2, 16), (4, 2, 16)))
    o, k_rot = fd.flash_decode_attention(q, cache, k_new=kn, v_new=vn, rope_theta=THETA)
    q_rot = apply_rope(q[:, None], cache.lengths.long()[:, None], THETA)[:, 0]
    kvc.append_decode(cache, k_rot, vn)
    assert torch.equal(fd.flash_decode_attention(q_rot, cache), o)


def _paged_copy(cache, ps, seed):
    """The contiguous cache's content over a paged cold tier of page size
    ``ps``, its pages shuffled through a random permutation."""
    b, cold = cache.lengths.shape[0], cache.cold_cap
    pps = -(-cold // ps)
    perm = torch.as_tensor(np.random.default_rng(seed).permutation(b * pps), dtype=torch.int32)
    pools = []
    for src in (cache.cold_k, cache.cold_v):
        full = torch.cat([src, src.new_zeros((b, pps * ps - cold) + src.shape[2:])], 1)
        pool = torch.empty_like(full.reshape((b * pps, ps) + src.shape[2:]))
        pool[perm.long()] = full.reshape(pool.shape)  # logical page p at pool page perm[p]
        pools.append(pool)
    table = perm.reshape(b, pps)
    return kvc.PagedKVCache(cache.hot_k, cache.hot_v, *pools, table, cache.lengths)


DP_LENGTHS = [1, 31, 32, 33, 40, 63, 80, 127]


@pytest.mark.parametrize("tier", ["f32", "fp8"])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("hot", [4, 32])
def test_decode_row_equals_prefill_row_bit_for_bit(hot, paged, tier):
    """Recompute-from-prefix needs a decoded row to equal the prefill's row
    at its position. Both fold absolute 32-key tiles, the pending token at
    lane p % 32 of tile p // 32, so at falcon3-1b's heads (h 8, g 4, d 256),
    at lengths across tile edges, hot 4 (tiles straddling the tiers) and 32,
    contiguous and paged (page size 32, shuffled), f32 and fp8 tiers: the
    fused decode equals the one-row chunk prefill over the same cache bit
    for bit; with f32 tiers also the fresh prefill's row p (the cache made
    from that prefill's own emit) and the post-append decode after the
    append. Inactive slots equal the chunk form with valid 0."""
    b, h, g, d, cold = len(DP_LENGTHS), 8, 4, 256, 128 - hot
    rng = np.random.default_rng(hot + 2 * paged)
    seq = [torch.from_numpy(rng.standard_normal((b, 128, n, d)).astype(np.float32))
           for n in (h, g, g)]  # q, k, v of every position, unrotated
    fresh, k_cast, v_cast = fp.flash_prefill_attention(*seq, rope_theta=THETA)
    cache = kvc.init_cache(b, hot, cold, (g, d))
    lens = torch.tensor(DP_LENGTHS, dtype=torch.int32)
    kvc.fill_fresh(cache, k_cast, v_cast)
    cache.lengths.copy_(lens)  # rows past each length stay, masked
    if tier == "fp8":
        cache = kvc.TieredKVCache(*(kvc.to_tier(t, kvc.FP8) for t in cache[:4]), cache.lengths)
    if paged:
        cache = _paged_copy(cache, 32, seed=hot)
    slots = torch.arange(b)
    q, kn, vn = (t[slots, lens.long()] for t in seq)  # each slot's row at its length
    act = torch.tensor([i % 4 != 3 for i in range(b)])
    o, k_rot = fd.flash_decode_attention(q, cache, k_new=kn, v_new=vn, active=act,
                                         rope_theta=THETA)
    chunk, k_c, _ = fp.flash_prefill_attention(q[:, None], kn[:, None], vn[:, None], cache,
                                               act.int(), rope_theta=THETA)
    assert torch.equal(o, chunk[:, 0]) and torch.isfinite(o).all()
    assert torch.equal(kvc.raw(kvc.to_tier(k_rot, k_c.dtype))[act], kvc.raw(k_c[:, 0])[act])
    if tier == "f32":
        assert torch.equal(o[act], fresh[slots, lens.long()][act])
        q_rot = apply_rope(q[:, None], lens.long()[:, None], THETA)[:, 0]
        kvc.append_decode(cache, k_rot, vn, active=act)
        assert torch.equal(fd.flash_decode_attention(q_rot, cache)[act], o[act])


# ---------------------------------------------------------------------------
# The CUDA kernel's schedule (csrc/flash_decode.cuh), modelled in torch
# ---------------------------------------------------------------------------

KERNEL_THREADS = 256  # kThreads
KERNEL_CHUNK = 4  # kChunk: tiles whose logits come before their fold


def _slice_dims(d):
    """Value dims per block (slice_dims)."""
    return min(d, 64)


def _lane_dot(prod):
    """The kernel's dot product over the last dim: lane L holds dims L +
    32 t (zero past d), sums them as a halving tree over t, and the xor
    butterfly across lanes, which lane 0 sees as the halving tree over the
    lanes, sums the lanes."""
    d = prod.shape[-1]
    if d < 32:
        prod = torch.cat([prod, prod.new_zeros(prod.shape[:-1] + (32 - d,))], -1)
    lanes = prod.reshape(prod.shape[:-1] + (max(d // 32, 1), 32))  # [t, L] = dim L + 32 t
    return fd.tree_sum(fd.tree_sum(lanes, -2), -1)


def _lane_rope(x, cos, sin):
    """The kernel's RoPE in registers, by lane: dim i = L + 32 t pairs with
    L + 32 (t + TL / 2) in the same lane for d >= 64, and with lane L ^ (d /
    2) for d 16 and 32; the pair's low dim indexes the table."""
    d = x.shape[-1]
    tl, half = max(d // 32, 1), d // 2
    i = torch.arange(d)
    lane, t = i % 32, i // 32
    partner = lane + 32 * ((t + tl // 2) % tl) if tl >= 2 else lane ^ half
    j = torch.where(i < half, i, partner)
    xc, ps = x * cos[..., j], x[..., partner] * sin[..., j]
    return torch.where(i < half, xc - ps, xc + ps)


def _decode_schedule_model(q, cache, scale, k_new=None, v_new=None, active=None, theta=None):
    """The kernel's schedule, block by block: for each (value-dim slice,
    kv group, slot) the rotated rows (``_lane_rope``), then per chunk of
    KERNEL_CHUNK absolute tiles of the slot's keys (positions 32 i .. 32 i
    + 31: hot rows below hot_cap, cold rows above, so a tile may hold both;
    the pending token of an active slot of the fused form at position
    ``length``, in the last tile) every logit in the lane dot order, then
    per tile and head m_new, alpha, p and l, then P.V: the thread of value
    dim dv and part c holds keys j = c + SPLIT u, sums their products as a
    halving tree over u, and the SPLIT parts by an xor butterfly. Returns
    o, or (o, k_rot) with k_new."""
    b, h, d = q.shape
    g = cache.hot_k.shape[2]
    rep, dvs = h // g, _slice_dims(d)
    split = max(KERNEL_THREADS // dvs, 1)
    out = torch.zeros(b, h, d)
    k_rot = torch.zeros(b, g, d)
    for s, length in enumerate(cache.lengths.tolist()):
        n_tier = min(length, cache.hot_cap + cache.cold_cap)
        n_hot = min(n_tier, cache.hot_cap)
        pend = k_new is not None and (active is None or bool(active[s]))
        for gi in range(g):
            heads = slice(gi * rep, (gi + 1) * rep)
            qg = q[s, heads].float()
            if k_new is not None:
                cos, sin = rope_cos_sin(cache.lengths[s:s + 1].long(), d, theta)
                qg = _lane_rope(qg, cos, sin)
                k_rot[s, gi] = _lane_rope(k_new[s, gi].float()[None], cos, sin)[0]
            keys = torch.cat([cache.hot_k[s, :n_hot, gi], cache.cold_k[s, :n_tier - n_hot, gi]]
                             + ([k_rot[s, gi][None]] if pend else [])).float()
            vals = torch.cat([cache.hot_v[s, :n_hot, gi], cache.cold_v[s, :n_tier - n_hot, gi]]
                             + ([v_new[s, gi][None]] if pend else [])).float()
            tiles = [(keys[i: i + 32], vals[i: i + 32]) for i in range(0, keys.shape[0], 32)]
            for d0 in range(0, d, dvs):
                dims = slice(d0, d0 + dvs)
                m, l, acc = torch.full((rep,), NEG_INF), torch.zeros(rep), torch.zeros(rep, dvs)
                for c0 in range(0, len(tiles), KERNEL_CHUNK):
                    chunk = tiles[c0: c0 + KERNEL_CHUNK]
                    logits = [_lane_dot(qg[:, None] * kt[None]) * scale for kt, _ in chunk]
                    for (_, vt), lg in zip(chunk, logits):
                        n = vt.shape[0]
                        m_new = torch.maximum(m, lg.amax(-1))
                        alpha = torch.exp(m - m_new)
                        p, v = torch.zeros(rep, 32), torch.zeros(32, dvs)
                        p[:, :n], v[:n] = torch.exp(lg - m_new[:, None]), vt[:, dims]
                        l = l * alpha + fd.tree_sum(p, -1)
                        parts = (p[:, :, None] * v[None]).reshape(rep, 32 // split, split, dvs)
                        acc = acc * alpha[:, None] + fd.tree_sum(fd.tree_sum(parts, 1), 1)
                        m = m_new
                out[s, heads, dims] = acc / torch.clamp(l, min=1e-30)[:, None]
    if k_new is None:
        return out.to(q.dtype)
    return out.to(q.dtype), k_rot.to(k_new.dtype)


def _poisoned_cache(lens, hot, cold, g, d, seed, dtype=torch.float32, device="cpu"):
    """Random tiers with NaN in every row at or past a slot's length."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    tiers = [torch.from_numpy(rng.standard_normal((b, cap, g, d)).astype(np.float32))
             for cap in (hot, hot, cold, cold)]
    lengths = torch.tensor(lens, dtype=torch.int32)
    hot_valid, cold_valid = kvc.valid_masks(kvc.TieredKVCache(*tiers, lengths))
    tiers = [torch.where(m[:, :, None, None], t, float("nan"))
             for t, m in zip(tiers, (hot_valid, hot_valid, cold_valid, cold_valid))]
    return kvc.TieredKVCache(*(t.to(device, dtype) for t in tiers), lengths.to(device))


def _decode_inputs(b, rep, g, d, seed, dtype=torch.float32, device="cpu"):
    """q (a row of -0.0 in slot 1), k_new, v_new, and active with slot 0
    and every fourth slot from 3 inactive."""
    rng = np.random.default_rng(seed)
    q, kn, vn = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((b, g * rep, d), (b, g, d), (b, g, d)))
    q[1 % b, 0] = -0.0
    active = torch.tensor([i % 4 != 3 and i != 0 for i in range(b)])
    return tuple(t.to(device, dtype) for t in (q, kn, vn)) + (active.to(device),)


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_lane_local_rope_equals_apply_rope(d, seed):
    """The in-lane rotation (partner t + TL / 2 for d >= 64, a shuffle by d
    / 2 below) with rope_cos_sin's table gives apply_rope's bits."""
    rng = np.random.default_rng(seed + d)
    x = torch.from_numpy(rng.standard_normal((64, 5, d)).astype(np.float32))
    x[0] = -0.0
    pos = torch.from_numpy(rng.integers(0, 5000, 64))
    cos, sin = rope_cos_sin(pos[:, None], d, THETA)  # (64, 1, d / 2)
    want = apply_rope(x[:, None], pos[:, None], THETA)[:, 0]
    got = _lane_rope(x, cos, sin)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("form", ["fused", "post_append"])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [16, 32, 64, 256])
def test_gqa_decode_schedule_model_bit_identical_to_plain(d, rep, form):
    """The kernel's schedule (value-dim slices, absolute tiles, logits of a
    chunk first in the lane dot order, per-head max / alpha / p, the P.V
    tile tree split over SPLIT threads, the pending token inside its tile)
    gives the plain version's output bit for bit: slots at lengths 0, 1,
    31, 32, 33, the hot / cold edge (hot 40: a tile holding hot and cold
    rows) and 127, NaN past each length, inactive slots and a q row of
    -0.0."""
    lens, g = [0, 1, 31, 32, 33, 40, 41, 127], 2
    cache = _poisoned_cache(lens, 40, 88, g, d, seed=d + rep)
    q, kn, vn, act = _decode_inputs(len(lens), rep, g, d, seed=d * rep)
    scale = d ** -0.5
    if form == "fused":
        got, k_got = _decode_schedule_model(q, cache, scale, kn, vn, act, THETA)
        want, k_want = fd.flash_decode_fused_plain(q, cache, kn, vn, act, scale, THETA)
        assert torch.equal(k_got.view(torch.int32), k_want.view(torch.int32))
    else:
        got = _decode_schedule_model(q, cache, scale)
        want = fd.flash_decode_plain(q, cache, scale)
        assert not want[0].any()
    assert torch.isfinite(want).all() and torch.equal(got, want)


def _card_case(d, rep, tiers, dtype, seed, device, tier="same"):
    """A card case; ``tier`` "fp8" casts the tiers to fp8 (e4m3) through
    ``to_tier``, the activations keeping ``dtype``."""
    hot, cold, lens = {"hot32-cold96": (32, 96, list(range(129))),
                       "hot32-cold480": (32, 480, [500, 0, 1, 257, 33, 480, 31])}[tiers]
    g = 3
    cache = _poisoned_cache(lens, hot, cold, g, d, seed, getattr(torch, dtype), device)
    if tier == "fp8":
        cache = kvc.TieredKVCache(*(kvc.to_tier(t, kvc.FP8) for t in cache[:4]), cache.lengths)
    return (cache,) + _decode_inputs(len(lens), rep, g, d, seed + 1, getattr(torch, dtype), device)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["same", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tiers", ["hot32-cold96", "hot32-cold480"])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("d", fd.HEAD_DIMS)
def test_cuda_kernel_bit_identical_to_plain(cuda, d, rep, tiers, dtype, tier):
    """Fused form: o and k_rot torch.equal to the plain version and one
    launch, at every head dim and rep, every length 0-128 (hot 32 / cold
    96) or up to 500 (hot 32 / cold 480), NaN past each length, inactive
    slots and a q row of -0.0; tiers in the activations' dtype or fp8
    (A1c, its own entry point)."""
    cache, q, kn, vn, act = _card_case(d, rep, tiers, dtype, d + rep, cuda, tier)
    kw = dict(k_new=kn, v_new=vn, active=act, rope_theta=THETA)
    kern = fd.FP8_KERNEL if tier == "fp8" else fd.KERNEL
    before = kern.launches
    o, k_rot = fd.flash_decode_attention(q, cache, **kw)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    o_p, k_rot_p = fd.flash_decode_attention(q, cache, impl="plain", **kw)
    assert torch.equal(k_rot, k_rot_p) and torch.equal(o, o_p)
    assert torch.isfinite(o).all() and not o[cache.lengths.eq(0) & ~act].any()


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["same", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tiers", ["hot32-cold96", "hot32-cold480"])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("d", fd.HEAD_DIMS)
def test_cuda_post_append_kernel_bit_identical_to_plain(cuda, d, rep, tiers, dtype, tier):
    """Post-append form: torch.equal to the plain version and one launch,
    over the same grid, tiers in the activations' dtype or fp8; length-0
    slots give zeros."""
    cache, q, _, _, _ = _card_case(d, rep, tiers, dtype, 2 * d + rep, cuda, tier)
    kern = fd.FP8_GQA_KERNEL if tier == "fp8" else fd.GQA_KERNEL
    before = kern.launches
    o = fd.flash_decode_attention(q, cache)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    o_p = fd.flash_decode_attention(q, cache, impl="plain")
    assert torch.equal(o, o_p)
    assert torch.isfinite(o).all() and not o[cache.lengths.eq(0)].any()


# (h, g, d) of the dense families: deepseek-coder-33b (rep 7, the last of
# the kernel's 8 head slots masked), qwen3-8b / qwen3-32b (rep 8, every
# slot) and gemma-7b (MHA: 16 groups of 256)
FAMILY_HEADS = [(56, 8, 128), (64, 8, 128), (16, 16, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["contiguous", "paged"])
@pytest.mark.parametrize("h,g,d", FAMILY_HEADS)
def test_cuda_fused_kernel_bit_identical_at_dense_family_heads(cuda, h, g, d, form, dtype):
    """Kernel 2 (fused RoPE) at the dense families' heads, contiguous and
    paged (page size 32, shuffled table), hot 32 / cold 96 at lengths
    0-128, NaN past each length, an inactive slot: o and k_rot
    torch.equal to the plain version and, paged, to the contiguous
    kernel; one launch of the form's entry point."""
    dt = getattr(torch, dtype)
    cont, paged = _card_pair(cuda, dt, 32, LENGTHS, g=g, d=d, seed=h + d)
    cache = _shuffle_pages(paged, h) if form == "paged" else cont
    gen = torch.Generator(device=cuda).manual_seed(h * d)
    b = len(LENGTHS)
    q = torch.randn((b, h, d), generator=gen, device=cuda).to(dt)
    kn, vn = (torch.randn((b, g, d), generator=gen, device=cuda).to(dt) for _ in range(2))
    active = torch.tensor([True] * (b - 1) + [False], device=cuda)
    kw = dict(k_new=kn, v_new=vn, active=active, rope_theta=THETA)
    kern = fd.PAGED_KERNEL if form == "paged" else fd.KERNEL
    before = kern.launches
    o, k_rot = fd.flash_decode_attention(q, cache, **kw)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    o_p, k_p = fd.flash_decode_attention(q, cache, impl="plain", **kw)
    assert torch.equal(o, o_p) and torch.equal(k_rot, k_p)
    assert torch.isfinite(o).all()
    if form == "paged":
        o_c, k_c = fd.flash_decode_attention(q, cont, **kw)
        assert torch.equal(o, o_c) and torch.equal(k_rot, k_c)
