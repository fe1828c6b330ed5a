"""Port parity for the sliding-window path (mixtral-8x22b): the config, the
ring cold tier of ``core.kv_cache``, the ring form of the fused GQA decode
(A1d) and the window / ring forms of the flash prefill (A3c), MoE at
Mixtral's shape, and the serving engine, against the reference.

Cache writes are copies, so the ring appends, the ring realign of
``fill_fresh`` and ``ring_slot_positions`` match bit for bit. Attention
outputs and the rotated k are f32 arithmetic in another order, held to
TOL = 2e-5 against the reference's Pallas kernels (interpret mode) and
XLA paths, as the other kernel parity tests are. The engine gives the JAX
engine's greedy tokens and ledgers under grouped and chunked admission,
with prompts longer than the window of 8 and sequences that wrap during
decode. The CUDA kernels run only on a card: the ``cuda``-marked tests
hold them against their plain versions there, bit for bit, and skip here.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_config, get_smoke_config, shrink
from repro_torch.core import dr_edram
from repro_torch.core import kv_cache as kvc
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import flash_prefill as fp
from repro_torch.models import attention as tattn
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.layers import apply_rope
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request
from test_torch_threads import share_cpu_threads  # noqa: F401 (autouse: torch threads per worker)

TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
THETA = 1_000_000.0
NAME = "mixtral-8x22b"


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import bitlinear as jbitlinear
    from repro.core import kv_cache as jkvc
    from repro.kernels import flash_decode as jfd
    from repro.kernels import flash_prefill as jfp
    from repro.models import attention as jattn
    from repro.models import moe as jmoe
    from repro.models import pack as jpack
    from repro.models import transformer as jT
    from repro.serving import engine as jengine
    from repro.serving import scheduler as jsched

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs, bitlinear=jbitlinear,
                                 kvc=jkvc, fd=jfd, fp=jfp, attn=jattn, moe=jmoe, pack=jpack,
                                 T=jT, engine=jengine, sched=jsched)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _same(got, want):
    for a, b_ in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))


def _tiered(jcache):
    return kvc.TieredKVCache(*(torch.from_numpy(np.asarray(a).copy()) for a in jcache))


def _ring_cache(jref, lens, hot, cold, g=2, d=16, seed=0):
    """The reference's cache filled through active-masked ring decode
    appends (the serving write path), and the port's copy of it."""
    b = len(lens)
    ks, vs = _rand(seed, b, max(lens + [1]), g, d), _rand(seed + 1, b, max(lens + [1]), g, d)
    jc = jref.kvc.init_cache(b, hot, cold, (g, d), jref.jnp.float32)
    for t in range(max(lens + [0])):
        act = jref.jnp.asarray([t < n for n in lens])
        jc = jref.kvc.append_decode_ring(jc, jref.jnp.asarray(ks[:, t]),
                                         jref.jnp.asarray(vs[:, t]), active=act)
    return jc, _tiered(jc)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def test_config_matches_reference(jref):
    """Every field the port keeps equals the reference's, full and smoke;
    the smoke window is 8, as the reference's shrink sets it."""
    def same(mine, theirs):
        for f in dataclasses.fields(mine):
            a, b = getattr(mine, f.name), getattr(theirs, f.name)
            if dataclasses.is_dataclass(a):
                same(a, b)
            else:
                assert a == b, f.name

    for mine, theirs in ((get_config(NAME), jref.configs.get_config(NAME)),
                         (get_smoke_config(NAME), jref.configs.get_smoke_config(NAME))):
        same(mine, theirs)
    assert get_smoke_config(NAME).swa_window == 8 and get_config(NAME).swa_window == 4096
    assert shrink(get_config("falcon3-1b")).swa_window == 4096


# ---------------------------------------------------------------------------
# the ring cold tier, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hot,cold,lens,valid", [
    (0, 8, [0, 5, 9, 20], [12, 3, 8, 0]),  # t > cold_cap: only the last 8 rows write
    (0, 8, [0, 0, 7, 8], None),  # every row of every slot
    (2, 6, [0, 1, 4, 11], [12, 6, 5, 2]),  # a hot tier before the ring
])
def test_ring_bulk_append_bit_identical(jref, hot, cold, lens, valid):
    b, t, g, d = len(lens), 12, 2, 8
    jc, tc = _ring_cache(jref, lens, hot, cold, g, d, seed=hot + cold)
    k, v = _rand(3, b, t, g, d), _rand(4, b, t, g, d)
    jv = None if valid is None else jref.jnp.asarray(np.asarray(valid, np.int32))
    want = jref.kvc.append(jc, jref.jnp.asarray(k), jref.jnp.asarray(v), valid=jv, ring=True)
    got = kvc.append(tc, torch.from_numpy(k), torch.from_numpy(v), ring=True,
                     valid=None if valid is None else torch.tensor(valid, dtype=torch.int32))
    assert got is tc  # in place
    _same(got, want)


@pytest.mark.parametrize("hot,cold", [(0, 8), (0, 5), (3, 4)])
def test_ring_decode_appends_bit_identical(jref, hot, cold):
    """Active-masked ring decode appends over 23 steps: slots that wrap
    once, twice, not at all, and one never active."""
    lens = [23, 9, 3, 0]
    b, g, d = len(lens), 2, 8
    ks, vs = _rand(5, b, 23, g, d), _rand(6, b, 23, g, d)
    jc = jref.kvc.init_cache(b, hot, cold, (g, d), jref.jnp.float32)
    tc = kvc.init_cache(b, hot, cold, (g, d))
    for t in range(23):
        act = np.asarray([t < n for n in lens])
        jc = jref.kvc.append_decode_ring(jc, jref.jnp.asarray(ks[:, t]),
                                         jref.jnp.asarray(vs[:, t]), active=jref.jnp.asarray(act))
        kvc.append_decode_ring(tc, torch.from_numpy(ks[:, t]), torch.from_numpy(vs[:, t]),
                               active=torch.from_numpy(act))
    _same(tc, jc)
    assert tc.lengths.tolist() == lens


@pytest.mark.parametrize("s", [5, 8, 13, 20])
def test_fill_fresh_ring_bit_identical(jref, s):
    """``fill_fresh(ring=True)``: the prompt as it is while it fits the
    ring, the realign of its last ``cold_cap`` rows when s > cold_cap."""
    k, v = _rand(s, 2, s, 2, 8), _rand(s + 1, 2, s, 2, 8)
    want = jref.kvc.fill_fresh(jref.kvc.init_cache(2, 0, 8, (2, 8), jref.jnp.float32),
                               jref.jnp.asarray(k), jref.jnp.asarray(v), ring=True)
    got = kvc.fill_fresh(kvc.init_cache(2, 0, 8, (2, 8)), torch.from_numpy(k),
                         torch.from_numpy(v), ring=True)
    _same(got, want)


def test_fill_swa_ring_realign_matches_ring_append():
    """The port's case of the reference's ring-realign test: after the
    window prefill, ring row j holds the last position p = j (mod w), and
    a ring append of the same rows on a fresh cache writes the same tier."""
    b, s, g, d, w = 2, 13, 2, 8, 8
    q, k, v = (torch.from_numpy(a) for a in (_rand(8, b, s, 4, d), _rand(9, b, s, g, d),
                                             _rand(10, b, s, g, d)))
    _, k_c, v_c = fp.flash_prefill_attention(q, k, v, window=w, rope_theta=THETA)
    filled = kvc.fill_fresh(kvc.init_cache(b, 0, w, (g, d)), k_c, v_c, ring=True)
    assert filled.lengths.tolist() == [s, s]
    for j in range(w):
        p = max(pp for pp in range(s) if pp % w == j)
        assert torch.equal(filled.cold_k[:, j], k_c[:, p])
        assert torch.equal(filled.cold_v[:, j], v_c[:, p])
    appended = kvc.append(kvc.init_cache(b, 0, w, (g, d)), k_c, v_c, ring=True)
    for a, b_ in zip(filled, appended):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("cap", [8, 5])
def test_ring_slot_positions_and_valid_masks_bit_identical(jref, cap):
    """``ring_slot_positions`` at offsets before, at and past the wrap, and
    the valid masks of a wrapped ring (every row valid once wrapped)."""
    off = np.asarray([0, 1, cap - 1, cap, cap + 1, 3 * cap + 2], np.int32)
    want = jref.kvc.ring_slot_positions(jref.jnp.asarray(off), cap)
    got = kvc.ring_slot_positions(torch.from_numpy(off), cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jc, tc = _ring_cache(jref, off.tolist(), 0, cap, seed=cap)
    for a, b_ in zip(kvc.valid_masks(tc), jref.kvc._valid_masks(jc)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
    assert kvc.valid_masks(tc)[1][off >= cap].all()


def test_paged_cache_refuses_the_ring():
    """A paged cache has no ring layout, as the reference asserts: the
    appends, the chunk reference and the decode entry point raise."""
    paged = kvc.init_paged_cache(1, 2, 4, (1, 8), page_size=2)
    z = torch.zeros(1, 1, 1, 8)
    with pytest.raises(NotImplementedError):
        kvc.append(paged, z, z, ring=True)
    with pytest.raises(NotImplementedError):
        kvc.append_decode_ring(paged, z[:, 0], z[:, 0])
    with pytest.raises(NotImplementedError):
        fd.flash_decode_attention_ring(torch.zeros(1, 1, 8), paged, k_new=z[:, 0],
                                       v_new=z[:, 0], rope_theta=THETA)
    cfg = get_smoke_config(NAME)
    with pytest.raises(NotImplementedError):
        T.init_decode_cache(cfg, 2, 16, paged=True, device="cpu")


# ---------------------------------------------------------------------------
# A1d: the ring form of the fused decode, and kernel 6 over a wrapped ring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("hot,cold,lens,active", [
    (0, 8, [0, 3, 7, 8, 9, 21], [0, 1, 1, 1, 1, 1]),  # before, at and past the wrap
    (0, 8, [8, 9, 21, 5], [0, 0, 1, 0]),  # inactive wrapped slots keep every row
    (0, 40, [39, 40, 41, 100], [1, 1, 1, 1]),  # a ring past one key tile
    (2, 6, [1, 8, 9, 15], [1, 1, 1, 1]),  # a hot tier before the ring
])
def test_fused_ring_decode_matches_reference(jref, impl, hot, cold, lens, active):
    b, h, g, d = len(lens), 6, 2, 16
    jc, tc = _ring_cache(jref, lens, hot, cold, g, d, seed=sum(lens))
    q, kn, vn = _rand(1, b, h, d), _rand(2, b, g, d), _rand(3, b, g, d)
    act = np.asarray(active, bool)
    want_o, want_k = jref.fd.flash_decode_attention_ring(
        *(jref.jnp.asarray(a) for a in (q,)), jc, impl=impl, interpret=True,
        k_new=jref.jnp.asarray(kn), v_new=jref.jnp.asarray(vn), active=jref.jnp.asarray(act),
        rope_theta=THETA)
    o, k_rot = fd.flash_decode_attention_ring(
        torch.from_numpy(q), tc, k_new=torch.from_numpy(kn), v_new=torch.from_numpy(vn),
        active=torch.from_numpy(act), rope_theta=THETA)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(k_rot.numpy(), np.asarray(want_k), **TOL)


def _evictee(cache, active):
    """Cold row of each slot that the coming ring append overwrites, where
    the slot is active and its window has wrapped; -1 elsewhere."""
    n = cache.lengths.long() - cache.hot_cap
    wrapped = active & (n >= cache.cold_cap)
    return torch.where(wrapped, torch.remainder(n, cache.cold_cap), -1)


def test_fused_ring_decode_masks_only_the_evictee():
    """The ring form masks only the evictee: with no slot active it keeps
    every ring row, the one-row ring chunk's rows at valid 0 and no window
    bit for bit; with every slot active it leaves out the row the append
    evicts, the one-row chunk's rows at window = the ring's width bit for
    bit, and differs from the linear fused form where a wrapped slot would
    otherwise read the position that has left its window; it equals the
    f64 softmax over the ring rows but the evictee, then the pending
    token."""
    b, h, g, d, cold = 3, 4, 2, 16, 8
    tc = kvc.init_cache(b, 0, cold, (g, d))
    for t in range(11):
        kvc.append_decode_ring(tc, torch.from_numpy(_rand(t, b, g, d)),
                               torch.from_numpy(_rand(t + 50, b, g, d)),
                               active=torch.tensor([True, t < 8, t < 4]))
    q, kn, vn = (torch.from_numpy(a) for a in (_rand(1, b, h, d), _rand(2, b, g, d),
                                                _rand(3, b, g, d)))
    busy = torch.ones(b, dtype=torch.bool)
    ev = _evictee(tc, busy)
    assert ev.tolist() == [11 % cold, 0, -1]  # wrapped slots only
    for act in (~busy, busy):
        o_ring, _ = fd.flash_decode_attention_ring(q, tc, k_new=kn, v_new=vn, active=act,
                                                   rope_theta=THETA)
        assert torch.equal(o_ring, _one_row_chunk(q, tc, kn, vn, act))
    o_flat, _ = fd.flash_decode_attention(q, tc, k_new=kn, v_new=vn, rope_theta=THETA)
    assert not torch.equal(o_ring[0], o_flat[0])
    # oracle in f64: softmax over the ring rows but the evictee, then the
    # pending token, all rotated at the slot's length
    pos = tc.lengths.long()[:, None]
    qr = apply_rope(q.double()[:, None], pos, THETA)[:, 0]
    kr = apply_rope(kn.double()[:, None], pos, THETA)[:, 0]
    for i in range(b):
        rows = [j for j in range(min(int(tc.lengths[i]), cold)) if j != ev[i]]
        keys = torch.cat([tc.cold_k[i, rows].double(), kr[i][None]])  # (n, g, d)
        vals = torch.cat([tc.cold_v[i, rows].double(), vn[i].double()[None]])
        for hh in range(h):
            lg = keys[:, hh // 2] @ qr[i, hh] * d ** -0.5
            want = torch.softmax(lg, 0) @ vals[:, hh // 2]
            torch.testing.assert_close(o_ring[i, hh].double(), want, rtol=1e-5, atol=1e-5)


def _one_row_chunk(q, cache, k_new, v_new, active):
    """Each slot's row of the one-row ring chunk (A3c at C = 1, with its
    emit and no append): an active slot's at window = the ring's width, an
    inactive one's at valid 0 and no window (every ring row) -> (b, h, d)."""
    args = (q[:, None], k_new[:, None], v_new[:, None], cache)
    o_act = fp.flash_prefill_attention(*args, valid=active.to(torch.int32),
                                       window=cache.cold_cap, ring=True, rope_theta=THETA)[0]
    o_idle = fp.flash_prefill_attention(*args, valid=torch.zeros_like(active, dtype=torch.int32),
                                        ring=True, rope_theta=THETA)[0]
    return torch.where(active[:, None, None], o_act[:, 0], o_idle[:, 0])


def _cpu_ring(lens, cold, g, d, seed, dtype=torch.float32, tier="same", hot=0):
    """A ring cache filled by active-masked ring decode appends ending
    together at ``lens`` (NaN in the rows never written); ``tier`` "fp8"
    casts the tiers through ``to_tier``."""
    cache = _card_ring("cpu", dtype, lens, cold, g, d, seed, hot=hot)
    if tier == "fp8":
        cache = kvc.TieredKVCache(*(kvc.to_tier(t, kvc.FP8) for t in cache[:4]), cache.lengths)
    return cache


# lengths before, at and past the wrap; window starts (length - cold + 1)
# aligned to 32 (cold 40: 71, 103; cold 64: 95, 127) and not
RING_ROW_CASES = {
    "ring8": (8, [0, 1, 7, 8, 9, 21, 40, 41]),
    "ring40": (40, [31, 32, 33, 39, 40, 41, 71, 72, 100, 103]),
    "ring64": (64, [63, 64, 65, 95, 127, 128, 200]),
}


@pytest.mark.parametrize("tier", ["float32", "bfloat16", "fp8"])
@pytest.mark.parametrize("case", sorted(RING_ROW_CASES))
def test_ring_decode_row_equals_ring_chunk_row(case, tier):
    """A1d folds absolute tiles: the plain ring decode's row equals the
    one-row ring chunk's (``flash_prefill_plain(..., ring=True)`` at C = 1)
    bit for bit, and k_rot the chunk's emitted k, at lengths across the
    wrap, window starts aligned and unaligned to 32, inactive slots, f32
    and bf16 tiers, and fp8 tiers under f32 activations."""
    cold, lens = RING_ROW_CASES[case]
    dtype = torch.bfloat16 if tier == "bfloat16" else torch.float32
    b, rep, g, d = len(lens), 3, 2, 16
    cache = _cpu_ring(lens, cold, g, d, seed=cold + len(tier), dtype=dtype, tier=tier)
    gen = torch.Generator().manual_seed(cold)
    q, kn, vn = (torch.randn(s, generator=gen).to(dtype)
                 for s in ((b, g * rep, d), (b, g, d), (b, g, d)))
    act = torch.tensor([i % 3 != 2 for i in range(b)])
    o, k_rot = fd.flash_decode_attention_ring(q, cache, k_new=kn, v_new=vn, active=act,
                                              rope_theta=THETA)
    assert torch.isfinite(o).all() and torch.equal(o, _one_row_chunk(q, cache, kn, vn, act))
    _, k_c, _ = fp.flash_prefill_attention(q[:, None], kn[:, None], vn[:, None], cache,
                                           valid=act.to(torch.int32), window=cold, ring=True,
                                           rope_theta=THETA)
    assert torch.equal(kvc.raw(kvc.to_tier(k_rot[act], k_c.dtype)), kvc.raw(k_c[act, 0]))


def _ring_tile_walk(length, active, hc, cc):
    """The ring kernel's tile walk, transcribed from ``decode_body``'s RING
    branch (csrc/flash_decode.cuh): [(tile start, {lane: ("hot" | "cold",
    row) or None for the pending token})] in fold order."""
    tile = fd.TILE
    n_end, n_hot = length + active, min(length, hc)
    lo = min(max(hc, length - cc + active), length)
    t_hot = -(-n_hot // tile)
    t_up = max(lo // tile, t_hot)
    n_tiles = t_hot + max(-(-n_end // tile) - t_up, 0)
    rbase = (max(lo - hc, 0) % cc if cc else 0) - lo
    walk = []
    for tk in range(n_tiles):
        start = (tk if tk < t_hot else tk - t_hot + t_up) * tile
        n = min(tile, n_end - start)
        lanes = {}
        for j in range(tile):
            pos = start + j
            if not (j < n and (pos < n_hot or pos >= lo)):
                continue
            r = rbase + pos
            r = r - cc if r >= cc else r
            lanes[j] = (None if active and pos == length
                        else ("hot", pos) if pos < hc else ("cold", r))
        walk.append((start, lanes))
    return walk


@pytest.mark.parametrize("hot,cold,lens", [
    (0, 8, [0, 1, 8, 9, 21, 40]),  # a ring narrower than a tile
    (0, 40, [39, 40, 41, 71, 72, 100]),  # window starts aligned and not
    (2, 6, [1, 2, 8, 9, 15]),  # a hot tier before the ring
    (4, 40, [3, 4, 36, 44, 45, 80, 200]),  # hot rows, then a gap of evicted tiles
])
def test_ring_decode_tile_walk_model_equals_plain(hot, cold, lens):
    """The ring kernel's index arithmetic (which tiles it folds, each
    lane's key and ring row, the pending token's lane), transcribed in
    ``_ring_tile_walk``, visits the positions the ring holds, each at its
    ring row, every tile holding a key; folding its tiles one by one gives
    the plain ring decode's bits, active and inactive slots alike."""
    b, rep, g, d = len(lens), 2, 2, 16
    cache = _cpu_ring(lens, cold, g, d, seed=hot + cold, hot=hot)
    gen = torch.Generator().manual_seed(hot + cold)
    q, kn, vn = (torch.randn(s, generator=gen) for s in ((b, g * rep, d), (b, g, d), (b, g, d)))
    scale = d ** -0.5
    for act in (torch.ones(b, dtype=torch.bool), torch.tensor([i % 2 == 0 for i in range(b)])):
        want, k_rot = fd.flash_decode_fused_plain(q, cache, kn, vn, act, scale, THETA, ring=True)
        q_rot = apply_rope(q[:, None], cache.lengths.long()[:, None], THETA)[:, 0]
        for s, length in enumerate(cache.lengths.tolist()):
            walk = _ring_tile_walk(length, int(act[s]), hot, cold)
            held = {st + j for st, lanes in walk for j in lanes}
            lo = min(max(hot, length - cold + int(act[s])), length)
            assert held == set(range(min(length, hot))) | set(range(lo, length + int(act[s])))
            assert all(lanes for _, lanes in walk)
            assert [st for st, _ in walk] == sorted({st for st, _ in walk})
            state = (torch.full((1, g, rep), kvc.NEG_INF), torch.zeros(1, g, rep),
                     torch.zeros(1, g, rep, d))
            for st, lanes in walk:
                kt, vt = torch.zeros(1, fd.TILE, g, d), torch.zeros(1, fd.TILE, g, d)
                valid = torch.zeros(1, fd.TILE, dtype=torch.bool)
                for j, src in lanes.items():
                    if src is None:
                        kt[0, j], vt[0, j] = k_rot[s], vn[s]
                    else:
                        tier, row = src
                        assert tier == "hot" or (st + j - hot) % cold == row
                        kt[0, j] = (cache.hot_k if tier == "hot" else cache.cold_k)[s, row]
                        vt[0, j] = (cache.hot_v if tier == "hot" else cache.cold_v)[s, row]
                    valid[0, j] = True
                state = fd._fold_keys(state, q_rot[s:s + 1].reshape(1, g, rep, 1, d), kt, vt,
                                      valid, scale)
            got = (state[2] / torch.clamp(state[1], min=1e-30)[..., None]).reshape(-1, d)
            assert torch.equal(got, want[s]), (hot, cold, length, bool(act[s]))


def test_ring_decode_at_mixtral_heads(jref):
    """At mixtral-8x22b's head geometry (48 / 8 heads of 128) over a ring of
    96 rows: the plain ring decode equals the one-row ring chunk's rows bit
    for bit at lengths before, at and past the wrap (window starts aligned
    and not), an inactive slot among them; the reference's Pallas ring
    kernel in interpret mode agrees on o to TOL (its own fold order) and on
    k_rot to LOGIT_TOL: at position 290 the two frameworks' f32 RoPE
    angles differ by about 3e-5, which a rotated row carries as it is."""
    lens, cold, g, rep, d = [95, 96, 97, 127, 150, 290], 96, 8, 6, 128
    b = len(lens)
    cache = _cpu_ring(lens, cold, g, d, seed=11)
    gen = torch.Generator().manual_seed(12)
    q, kn, vn = (torch.randn(s, generator=gen) for s in ((b, g * rep, d), (b, g, d), (b, g, d)))
    act = torch.tensor([True, True, False, True, True, True])
    o, k_rot = fd.flash_decode_attention_ring(q, cache, k_new=kn, v_new=vn, active=act,
                                              rope_theta=THETA)
    assert torch.equal(o, _one_row_chunk(q, cache, kn, vn, act))
    jnp = jref.jnp
    jcache = jref.kvc.TieredKVCache(*(jnp.asarray(t.numpy()) for t in cache[:4]),
                                    jnp.asarray(cache.lengths.numpy()))
    want_o, want_k = jref.fd.flash_decode_attention_ring(
        jnp.asarray(q.numpy()), jcache, impl="pallas", interpret=True,
        k_new=jnp.asarray(kn.numpy()), v_new=jnp.asarray(vn.numpy()),
        active=jnp.asarray(act.numpy()), rope_theta=THETA)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(k_rot.numpy(), np.asarray(want_k), **LOGIT_TOL)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_post_append_decode_over_wrapped_ring_matches_reference(jref, impl):
    """Kernel 6 over a ring: the length clip of the post-append form marks
    every row of a wrapped ring valid, which is the reference's valid set
    (``_valid_masks``), and a not yet wrapped slot its prefix."""
    lens = [7, 8, 9, 30, 0]
    jc, tc = _ring_cache(jref, lens, 0, 8, seed=4)
    q = _rand(5, len(lens), 4, 16)
    want = jref.fd.flash_decode_attention_ring(jref.jnp.asarray(q), jc, impl=impl,
                                               interpret=True)
    got = fd.flash_decode_attention_ring(torch.from_numpy(q), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    n_cold = (tc.lengths.long() - tc.hot_cap).clamp(0, tc.cold_cap)
    assert n_cold.tolist() == [7, 8, 8, 8, 0]
    assert kvc.valid_masks(tc)[1].sum(1).tolist() == n_cold.tolist()


# ---------------------------------------------------------------------------
# A3c: the window and ring forms of the flash prefill
# ---------------------------------------------------------------------------


def _prefill_outputs(jref, q, k, v, jcache, tcache, valid, **kw):
    jv = None if valid is None else jref.jnp.asarray(np.asarray(valid, np.int32))
    outs = [jref.fp.flash_prefill_attention(
        *(jref.jnp.asarray(a) for a in (q, k, v)), jcache, jv, rope_theta=THETA, emit_kv=True,
        impl=impl, interpret=True, block_q=4, block_s=4, **kw) for impl in ("pallas", "xla")]
    got = fp.flash_prefill_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), tcache,
        None if valid is None else torch.tensor(valid, dtype=torch.int32),
        rope_theta=THETA, **kw)
    return got, outs


def _assert_prefill(got, outs, valid):
    o, k_c, v_c = got
    for want_o, want_k, want_v in outs:
        for i, n in enumerate(valid):
            np.testing.assert_allclose(o[i, :n].numpy(), np.asarray(want_o)[i, :n], **TOL)
        np.testing.assert_allclose(k_c.numpy(), np.asarray(want_k), **TOL)
        np.testing.assert_array_equal(v_c.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("window", [1, 3, 8])
def test_fresh_swa_window(jref, window):
    """The port's case of the reference's fresh SWA window test (b 2, s 11,
    h 4 over g 2), here with valid counts 11 and 6."""
    b, s, h, g, d = 2, 11, 4, 2, 8
    q, k, v = _rand(window, b, s, h, d), _rand(window + 1, b, s, g, d), _rand(window + 2, b, s, g, d)
    got, outs = _prefill_outputs(jref, q, k, v, None, None, [s, 6], window=window)
    _assert_prefill(got, outs, [s, 6])


def test_fresh_window_against_blockwise_reference():
    """The window form equals full causal attention with the window mask
    over rotated q / k (the plain ``blockwise_attention``), past one tile."""
    b, s, h, g, d, w = 2, 70, 6, 2, 16, 20
    q, k, v = (torch.from_numpy(a) for a in (_rand(11, b, s, h, d), _rand(12, b, s, g, d),
                                             _rand(13, b, s, g, d)))
    o, k_c, _ = fp.flash_prefill_attention(q, k, v, window=w, rope_theta=THETA)
    pos = torch.arange(s)[None]
    qr, kr = apply_rope(q, pos, THETA), apply_rope(k, pos, THETA)
    want = tattn.blockwise_attention(
        qr.reshape(b, s, g, 3, d).permute(0, 2, 3, 1, 4), kr.permute(0, 2, 1, 3),
        v.permute(0, 2, 1, 3), window=w, q_chunk=16, kv_chunk=16)
    torch.testing.assert_close(o, want.permute(0, 3, 1, 2, 4).reshape(b, s, h, d), **TOL)
    assert torch.equal(k_c, kr)


def test_blockwise_window_matches_reference(jref):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 2, 2, 19, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 19, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 19, 16)).astype(np.float32)
    kw = dict(causal=True, window=5, q_chunk=8, kv_chunk=8)
    want = np.asarray(jref.attn.blockwise_attention(*(jref.jnp.asarray(a) for a in (q, k, v)),
                                                    **kw))
    got = tattn.blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("w,lens,c,valid", [
    (8, [10, 3], 6, [6, 4]),  # the reference's wrapped-window case: slot 0 wrapped
    (6, [9, 5], 4, [4, 3]),  # a ring that is not a multiple of the reference's block
    (8, [0, 7, 8, 17], 5, [5, 0, 5, 2]),  # offsets 0, inside and across the wrap; idle slot
])
def test_chunked_ring_prefill_matches_reference(jref, w, lens, c, valid):
    b, g, d = len(lens), 2, 8
    jc, tc = _ring_cache(jref, lens, 0, w, g, d, seed=w + c)
    q, k, v = _rand(w, b, c, 4, d), _rand(w + 1, b, c, g, d), _rand(w + 2, b, c, g, d)
    got, outs = _prefill_outputs(jref, q, k, v, jc, tc, valid, window=w, ring=True)
    assert np.isfinite(got[0].numpy()).all()
    _assert_prefill(got, outs, valid)


@pytest.mark.parametrize("lens,valid", [([0, 9, 21], [6, 6, 3]), ([4, 12, 30], [0, 5, 6])])
def test_tiered_chunk_attention_window_ring_matches_reference(jref, lens, valid):
    b, c, h, g, d, w = len(lens), 6, 4, 2, 16, 8
    jc, tc = _ring_cache(jref, lens, 0, w, g, d, seed=sum(lens))
    q, k, v = _rand(1, b, c, h, d), _rand(2, b, c, g, d), _rand(3, b, c, g, d)
    jv = jref.jnp.asarray(np.asarray(valid, np.int32))
    want = jref.kvc.tiered_chunk_attention(*(jref.jnp.asarray(a) for a in (q, k, v)), jc, jv,
                                           window=w, ring=True)
    got = kvc.tiered_chunk_attention(*(torch.from_numpy(a) for a in (q, k, v)), tc,
                                     torch.tensor(valid, dtype=torch.int32), window=w, ring=True)
    for i, n in enumerate(valid):
        np.testing.assert_allclose(got[i, :n].numpy(), np.asarray(want)[i, :n], **TOL)


@pytest.mark.parametrize("chunk", [5, 8, 32])
def test_ring_chunks_equal_the_fresh_window_form_bit_for_bit(chunk):
    """A prompt streamed in chunks over a ring of the window's size gives
    the fresh window form's output and emitted rows bit for bit (both fold
    the same absolute 32-key tiles; the ring rows hold the positions the
    window still sees), while the prompt wraps the ring several times."""
    b, s, h, g, d, w = 2, 75, 4, 2, 16, 24
    q, k, v = (torch.from_numpy(a) for a in (_rand(20, b, s, h, d), _rand(21, b, s, g, d),
                                             _rand(22, b, s, g, d)))
    o, k_c, v_c = fp.flash_prefill_attention(q, k, v, window=w, rope_theta=THETA)
    cache = kvc.init_cache(b, 0, w, (g, d))
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        oc, kc, vc = fp.flash_prefill_attention(q[:, sl], k[:, sl], v[:, sl], cache, window=w,
                                                ring=True, rope_theta=THETA)
        assert torch.equal(oc, o[:, sl]) and torch.equal(kc, k_c[:, sl])
        assert torch.equal(vc, v_c[:, sl])
        kvc.append(cache, kc, vc, ring=True)
    fresh = kvc.fill_fresh(kvc.init_cache(b, 0, w, (g, d)), k_c, v_c, ring=True)
    for a, b_ in zip(cache, fresh):
        assert torch.equal(a, b_)


# ---------------------------------------------------------------------------
# MoE at Mixtral's shape
# ---------------------------------------------------------------------------


def _moe_params(jref, seed, codec="pack2"):
    jcfg = jref.configs.get_smoke_config(NAME)
    cfg = get_smoke_config(NAME)
    jcfg = dataclasses.replace(jcfg, bitnet=dataclasses.replace(jcfg.bitnet, codec=codec))
    cfg = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, codec=codec))
    jp = jref.moe.init_moe(jref.jax.random.PRNGKey(seed), jcfg)
    jpacked = jref.pack.pack_params({"moe": jp}, jcfg)["moe"]
    return jcfg, cfg, jpacked, interop.from_reference(jpacked)


@pytest.mark.parametrize("codec", ["pack2", "pack243"])
@pytest.mark.parametrize("b,t", [(2, 5), (4, 1)])
def test_apply_moe_matches_reference(jref, codec, b, t):
    """Softmax top-2 of the experts, no shared expert and no adapter, the
    fused per-expert w_gu: the reference's capacity and routing decisions
    exactly, its output to one bfloat16 ulp of the combined sum."""
    jcfg, cfg, jp, tp = _moe_params(jref, seed=b + t, codec=codec)
    assert set(tp) == {"ln", "router", "w_gu", "w_down"}
    assert tp["w_gu"].scale.shape == (cfg.moe.n_experts, 2 * cfg.moe.d_ff_expert)
    x = _rand(b * t, b, t, cfg.d_model)
    jy, jaux = jref.moe.apply_moe(jp, jref.jnp.asarray(x), jcfg, "packed")
    ty, taux = moe.apply_moe(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **BF16_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    for n in (1, 4, 5, 10, 4096, 4200):
        assert moe._capacity(n, cfg) == jref.moe._capacity(n, jcfg)
        assert moe._capacity(n, get_config(NAME)) == jref.moe._capacity(
            n, jref.configs.get_config(NAME))


def test_init_has_moe_blocks_only_with_reference_shapes(jref):
    """No dense layers: the tree and the cache hold the MoE stack alone,
    with the reference's packed leaf shapes and its SWA cache layout (no
    hot tier, a ring of min(window, max_len) rows)."""
    from repro_torch.models.pack import pack_params

    cfg = get_smoke_config(NAME)
    mine = pack_params(T.init_params(cfg, seed=0, device="cpu"), cfg)
    jcfg = jref.configs.get_smoke_config(NAME)
    jpacked = jref.pack.pack_params(jref.T.init_params(jref.jax.random.PRNGKey(0), jcfg), jcfg)
    assert set(mine) == set(jpacked) and "dense_blocks" not in mine
    carried = interop.params_from_reference(_numpy_tree(jref, jpacked))

    def shapes(t):
        if hasattr(t, "packed"):
            return (tuple(t.packed.shape), tuple(t.scale.shape), t.k, getattr(t, "splits", None))
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)

    assert shapes(mine) == shapes(carried)
    for max_len in (6, 32):
        mc = T.init_decode_cache(cfg, 3, max_len, hot_cap=4, device="cpu")
        jc = jref.T.init_decode_cache(jcfg, 3, max_len, hot_cap=4)
        assert set(mc) == set(jc) == {"attn_moe"}
        assert [tuple(t.shape) for t in mc["attn_moe"]] == [
            tuple(np.asarray(t).shape) for t in jc["attn_moe"]]
        assert mc["attn_moe"].hot_cap == 0 and mc["attn_moe"].cold_cap == min(8, max_len)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------


def _numpy_tree(jref, tree):
    if isinstance(tree, (jref.bitlinear.PackedLinear, jref.bitlinear.FusedPackedLinear)):
        out = dict(packed=np.asarray(tree.packed), scale=np.asarray(tree.scale),
                   k=tree.k, codec=tree.codec)
        if isinstance(tree, jref.bitlinear.FusedPackedLinear):
            out["splits"] = tree.splits
        return out
    if isinstance(tree, dict):
        return {k: _numpy_tree(jref, v) for k, v in tree.items()}
    return np.asarray(tree)


def _models(jref, seed, codec="pack2"):
    jcfg = jref.configs.get_smoke_config(NAME)
    jcfg = dataclasses.replace(jcfg, bitnet=dataclasses.replace(jcfg.bitnet, codec=codec))
    cfg = get_smoke_config(NAME)
    cfg = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, codec=codec))
    jpacked = jref.pack.pack_params(jref.T.init_params(jref.jax.random.PRNGKey(seed), jcfg), jcfg)
    return jcfg, jpacked, cfg, interop.params_from_reference(_numpy_tree(jref, jpacked))


def _requests(cls, rng, specs, vocab):
    return [cls(i, rng.integers(0, vocab, (p,)).astype(np.int32), n)
            for i, (p, n) in enumerate(specs)]


@pytest.mark.parametrize("codec", ["pack2", "pack243"])
def test_generate_matches_reference_engine(jref, codec):
    """Grouped admission: 3 x (8 + 16) tokens over a window of 8, so every
    sequence wraps the ring during decode; tokens and ledgers equal, the
    ledger at the engine's hot_cap rule (the reference's)."""
    jcfg, jpacked, cfg, tparams = _models(jref, 1, codec)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)
    kw = dict(hot_cap=4, max_len=48, slots=3)
    jeng = jref.engine.Engine(jcfg, jpacked, **kw)
    want = jeng.generate(jref.jnp.asarray(prompts), max_new_tokens=16)
    eng = Engine(cfg, tparams, device="cpu", **kw)
    got = eng.generate(prompts, max_new_tokens=16)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.traffic == want.traffic
    assert eng.weight_loads == jeng.weight_loads == 0
    assert eng.expected_reduction(24) == jeng.expected_reduction(24)
    closed = dr_edram.closed_form_reduction(8 + 16, 4)
    for f in got.finished:
        assert f.seq_len == 24 and abs(f.external_reduction - closed) <= 1e-12


@pytest.mark.parametrize("chunk", [0, 4])
def test_serve_past_the_window_matches_reference(jref, chunk):
    """The cases of the reference's SWA serving tests: hot_cap 4, max_len
    32, a 12-token prompt longer than the window of 8 (the ring realign
    under grouped admission, the ring continuation under chunked
    admission at prefill_chunk 4) beside a 3-token one that wraps during
    decode; per-request tokens and ledgers equal to the JAX engine's, and
    each request served alone gives its batched tokens."""
    jcfg, jpacked, cfg, tparams = _models(jref, 1)
    specs = [(12, 6), (3, 10), (9, 7)]
    kw = dict(hot_cap=4, max_len=32, prefill_chunk=chunk)
    jeng = jref.engine.Engine(jcfg, jpacked, **kw)
    want = jeng.serve(_requests(jref.sched.Request, np.random.default_rng(90), specs,
                                cfg.vocab_size), slots=2)
    eng = Engine(cfg, tparams, device="cpu", **kw)
    reqs = _requests(Request, np.random.default_rng(90), specs, cfg.vocab_size)
    got = eng.serve(reqs, slots=2)
    assert eng._chunked_capable() and (eng.chunk_shapes != set()) == bool(chunk)
    assert [f.rid for f in got] == [f.rid for f in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert (g.seq_len, g.steps, g.traffic) == (w.seq_len, w.steps, w.traffic)
        assert abs(g.external_reduction - dr_edram.closed_form_reduction(g.seq_len, 4)) <= 1e-12
    by_rid = {f.rid: f for f in got}
    for r in reqs:
        solo = eng.serve([Request(9, r.tokens, r.max_new_tokens)], slots=1)[0]
        np.testing.assert_array_equal(by_rid[r.rid].tokens, solo.tokens)


def test_chunked_and_grouped_admission_agree():
    """On the port alone: the same requests admitted whole and in chunks of
    3, 4 and 8 give the same tokens and ledgers (the chunked ring form
    folds the fresh window form's tiles)."""
    cfg = get_smoke_config(NAME)
    params = T.init_params(cfg, seed=3, device="cpu")
    specs = [(20, 9), (5, 12), (8, 4), (13, 6)]

    def run(chunk):
        eng = Engine(cfg, params, hot_cap=4, max_len=40, prefill_chunk=chunk, device="cpu")
        fin = eng.serve(_requests(Request, np.random.default_rng(7), specs, cfg.vocab_size),
                        slots=3, sync_every=3)
        return {f.rid: (f.tokens.tolist(), f.traffic) for f in fin}

    want = run(0)
    for chunk in (3, 4, 8):
        assert run(chunk) == want


def test_prefill_and_first_step_logits_match_reference(jref):
    """T.prefill (ring realign: 11 > 8) and one ring decode step."""
    jcfg, jpacked, cfg, tparams = _models(jref, 5)
    prompts = np.random.default_rng(6).integers(0, cfg.vocab_size, (3, 11)).astype(np.int32)
    jl, jcache = jref.T.prefill(jpacked, jcfg, {"tokens": jref.jnp.asarray(prompts)},
                                hot_cap=4, max_len=24)
    tl, tcache = T.prefill(tparams, cfg, torch.from_numpy(prompts), hot_cap=4, max_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for a, b_ in zip(tcache["attn_moe"], jcache["attn_moe"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **TOL)
    first = np.asarray(jl).argmax(-1).astype(np.int32)
    jl1, _ = jref.T.decode_step(jpacked, jcfg, jref.jnp.asarray(first), jcache)
    tl1, tcache = T.decode_step(tparams, cfg, torch.from_numpy(first), tcache)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), **LOGIT_TOL)
    assert tcache["attn_moe"].lengths.tolist() == [[12] * 3] * cfg.n_layers


def test_kernel_sources_cover_every_entry_point():
    """Each source in ``csrc`` is built, and each kernel wrapper binds a
    built source (the sliding-window forms live in sources of their own,
    beside the shared kernel headers, so the sources build in parallel)."""
    from repro_torch.kernels import build, lora, rms_norm, ternary_matmul

    cu = {p.stem for p in build.CSRC_DIR.glob("*.cu")}
    assert cu == set(build.KERNEL_SOURCES)
    kernels = [v for m in (fd, fp, lora, rms_norm, ternary_matmul) for v in vars(m).values()
               if isinstance(v, build.CudaKernel)]
    assert {k.source for k in kernels} == cu
    assert (fd.RING_KERNEL.source, fp.WINDOW_KERNEL.source, fp.CHUNK_RING_KERNEL.source) == (
        "flash_decode_ring", "flash_prefill_swa", "flash_prefill_swa")


def test_a_header_edit_rebuilds_only_the_sources_that_include_it(tmp_path, monkeypatch):
    """A library's name hashes its source and the csrc headers that source
    includes: an edit to ``flash_prefill.cuh`` renames the three prefill
    libraries and no other, and an edit to ``fp8.cuh``, which the attention
    headers include, renames every attention library."""
    import shutil

    from repro_torch.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    before = {n: build._lib_path(n) for n in build.KERNEL_SOURCES}
    with open(csrc / "flash_prefill.cuh", "a") as f:
        f.write("\n// edited\n")
    changed = {n for n in build.KERNEL_SOURCES if build._lib_path(n) != before[n]}
    assert changed == {"flash_prefill", "flash_prefill_swa", "flash_prefill_fp8"}
    before = {n: build._lib_path(n) for n in build.KERNEL_SOURCES}
    with open(csrc / "fp8.cuh", "a") as f:
        f.write("\n// edited\n")
    changed = {n for n in build.KERNEL_SOURCES if build._lib_path(n) != before[n]}
    assert changed == {n for n in build.KERNEL_SOURCES if n.startswith("flash_")}


def test_init_params_packs_as_drawn():
    """``init_params(pack=True)`` packs each layer as it is drawn, with the
    same draws: equal to packing the float tree afterwards."""
    from repro_torch.models.pack import pack_params

    cfg = get_smoke_config(NAME)

    def flat(t):
        if hasattr(t, "packed"):
            return [t.packed, t.scale]
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in flat(t[k])]
        if isinstance(t, list):
            return [x for v in t for x in flat(v)]
        return [t]

    a = flat(pack_params(T.init_params(cfg, seed=4, device="cpu"), cfg))
    b = flat(T.init_params(cfg, seed=4, device="cpu", pack=True))
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_paged_swa_engine_raises():
    """Paged serving has no ring: the SWA cache refuses the pool."""
    cfg = get_smoke_config(NAME)
    params = T.init_params(cfg, seed=0, device="cpu")
    eng = Engine(cfg, params, hot_cap=4, max_len=32, prefill_chunk=4, paged=True, device="cpu")
    with pytest.raises(NotImplementedError):
        eng.serve([Request(0, np.arange(5, dtype=np.int32), 2)])


# ---------------------------------------------------------------------------
# on the card: the kernels against their plain versions, bit for bit
# ---------------------------------------------------------------------------


def _card_ring(dev, dtype, lens, cold, g, d, seed, hot=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = len(lens)
    cache = kvc.init_cache(b, hot, cold, (g, d), dtype=dtype, device=dev)
    for tier in cache[:4]:  # stale rows past each length: NaN, never read
        tier.fill_(float("nan"))
    steps = max(lens + [0])
    for t in range(steps):
        act = torch.tensor([t >= steps - n for n in lens], device=dev)  # ends together
        kvc.append_decode_ring(cache, torch.randn((b, g, d), generator=gen, device=dev).to(dtype),
                               torch.randn((b, g, d), generator=gen, device=dev).to(dtype),
                               active=act)
    return cache


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(6, 8, 128), (2, 4, 256), (6, 2, 16)])  # rep, g, d
@pytest.mark.parametrize("cold", [64, 4096])
def test_cuda_ring_decode_kernel_bit_identical(cuda, dtype, shape, cold):
    """A1d: o and k_rot of the ring kernel equal to its plain version at
    lengths before, at and past the wrap, inactive wrapped slots
    included, and one launch of ``flash_decode_gqa_fused_ring``."""
    rep, g, d = shape
    lens = [0, cold - 1, cold, cold + 1, 2 * cold + 5] if cold == 64 else [cold - 1, cold, cold + 37]
    act = torch.tensor([True, True, True, False, True][: len(lens)], device=cuda)
    cache = _card_ring(cuda, dtype, lens, cold, g, d, seed=cold + d)
    gen = torch.Generator(device=cuda).manual_seed(d)
    b = len(lens)
    q, kn, vn = (torch.randn(s, generator=gen, device=cuda).to(dtype)
                 for s in ((b, g * rep, d), (b, g, d), (b, g, d)))
    before = fd.RING_KERNEL.launches
    o, k_rot = fd.flash_decode_attention_ring(q, cache, k_new=kn, v_new=vn, active=act,
                                              rope_theta=THETA)
    torch.cuda.synchronize()
    assert fd.RING_KERNEL.launches == before + 1
    o_p, k_p = fd.flash_decode_attention_ring(q, cache, k_new=kn, v_new=vn, active=act,
                                              rope_theta=THETA, impl="plain")
    assert torch.equal(o, o_p) and torch.equal(k_rot, k_p)
    post = fd.flash_decode_attention_ring(q, cache)
    assert torch.equal(post, fd.flash_decode_attention_ring(q, cache, impl="plain"))


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["same", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(6, 8, 128), (2, 4, 256)])  # rep, g, d
@pytest.mark.parametrize("cold", [64, 4096])
def test_cuda_ring_decode_row_equals_ring_chunk_row(cuda, dtype, shape, cold, tier):
    """A1d (A1c over fp8 tiers) folds absolute tiles on the card: the ring
    decode kernel's row equals the one-row ring chunk kernel's (A3c / A3d
    at C = 1 with its emit, no append) bit for bit, at lengths before, at
    and past the wrap, window starts aligned (cold + 31, cold + 63) and
    unaligned to 32, inactive slots; one launch of each."""
    rep, g, d = shape
    far = 3 * cold + 5 if cold == 64 else cold + 40  # a short fill for the 4096 ring
    lens = [0, cold - 1, cold, cold + 1, cold + 31, far, cold + 2, cold + 63]
    act = torch.tensor([False, True, True, True, True, True, False, True], device=cuda)
    cache = _card_ring(cuda, dtype, lens, cold, g, d, seed=cold + d + 1)
    if tier == "fp8":
        cache = kvc.TieredKVCache(*(kvc.to_tier(t, kvc.FP8) for t in cache[:4]), cache.lengths)
    gen = torch.Generator(device=cuda).manual_seed(d + 1)
    b = len(lens)
    q, kn, vn = (torch.randn(s, generator=gen, device=cuda).to(dtype)
                 for s in ((b, g * rep, d), (b, g, d), (b, g, d)))
    fp8 = tier == "fp8"
    dec, chunk = ((fd.FP8_RING_KERNEL, fp.FP8_CHUNK_RING_KERNEL) if fp8
                  else (fd.RING_KERNEL, fp.CHUNK_RING_KERNEL))
    before = (dec.launches, chunk.launches)
    o, _ = fd.flash_decode_attention_ring(q, cache, k_new=kn, v_new=vn, active=act,
                                          rope_theta=THETA)
    row = _one_row_chunk(q, cache, kn, vn, act)
    torch.cuda.synchronize()
    assert (dec.launches, chunk.launches) == (before[0] + 1, before[1] + 2)
    assert torch.isfinite(o).all() and torch.equal(o, row)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(6, 8, 128), (2, 4, 256)])
@pytest.mark.parametrize("s,window", [(40, 8), (100, 64), (300, 256)])
def test_cuda_window_prefill_kernel_bit_identical(cuda, dtype, shape, s, window):
    """A3c, fresh: o, k_cast and v_cast of ``flash_prefill_window`` equal to
    the plain version, valid 0 / partial / full."""
    rep, g, d = shape
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    b = 3
    q, k, v = (torch.randn(sh, generator=gen, device=cuda).to(dtype)
               for sh in ((b, s, g * rep, d), (b, s, g, d), (b, s, g, d)))
    valid = torch.tensor([s, s // 2 + 3, 0], dtype=torch.int32, device=cuda)
    before = fp.WINDOW_KERNEL.launches
    got = fp.flash_prefill_attention(q, k, v, valid=valid, window=window, rope_theta=THETA)
    torch.cuda.synchronize()
    assert fp.WINDOW_KERNEL.launches == before + 1
    want = fp.flash_prefill_attention(q, k, v, valid=valid, window=window, rope_theta=THETA,
                                      impl="plain")
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(6, 8, 128), (2, 4, 256)])
@pytest.mark.parametrize("cold,c", [(64, 16), (64, 48), (4096, 256)])
def test_cuda_chunk_ring_kernel_bit_identical(cuda, dtype, shape, cold, c):
    """A3c, chunked over the ring: offsets 0, inside and across the wrap,
    far past it; valid 0 / partial / full; one launch of
    ``flash_prefill_chunk_ring``."""
    rep, g, d = shape
    lens = [0, cold - 5, cold + 3, 3 * cold + 1]
    cache = _card_ring(cuda, dtype, lens, cold, g, d, seed=cold + c)
    gen = torch.Generator(device=cuda).manual_seed(c)
    b = len(lens)
    q, k, v = (torch.randn(sh, generator=gen, device=cuda).to(dtype)
               for sh in ((b, c, g * rep, d), (b, c, g, d), (b, c, g, d)))
    valid = torch.tensor([c, c - 5, 0, c // 2], dtype=torch.int32, device=cuda)
    before = fp.CHUNK_RING_KERNEL.launches
    got = fp.flash_prefill_attention(q, k, v, cache, valid=valid, window=cold, ring=True,
                                     rope_theta=THETA)
    torch.cuda.synchronize()
    assert fp.CHUNK_RING_KERNEL.launches == before + 1
    want = fp.flash_prefill_attention(q, k, v, cache, valid=valid, window=cold, ring=True,
                                      rope_theta=THETA, impl="plain")
    for i, n in enumerate(valid.tolist()):
        assert torch.equal(got[0][i, :n], want[0][i, :n])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.cuda
def test_cuda_ring_chunks_equal_the_window_kernel(cuda):
    """f32 chunks of 48 over a ring of 64 give the fresh window kernel's
    rows bit for bit, while the prompt wraps the ring three times."""
    b, s, h, g, d, w = 2, 200, 12, 2, 128, 64
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(sh, generator=gen, device=cuda)
               for sh in ((b, s, h, d), (b, s, g, d), (b, s, g, d)))
    o, k_c, v_c = fp.flash_prefill_attention(q, k, v, window=w, rope_theta=THETA)
    cache = kvc.init_cache(b, 0, w, (g, d), device=cuda)
    for c0 in range(0, s, 48):
        sl = slice(c0, c0 + 48)
        oc, kc, vc = fp.flash_prefill_attention(q[:, sl], k[:, sl], v[:, sl], cache, window=w,
                                                ring=True, rope_theta=THETA)
        assert torch.equal(oc, o[:, sl]) and torch.equal(kc, k_c[:, sl])
        kvc.append(cache, kc, vc, ring=True)


@pytest.mark.cuda
def test_cuda_swa_engine_matches_plain_run(cuda):
    """mixtral-8x22b-smoke on the card: grouped and chunked admission give
    the plain run's tokens and each other's; the ring decode and both
    window prefill forms launched."""
    cfg = get_smoke_config(NAME)
    params = T.init_params(cfg, seed=0, device="cuda")
    specs = [(12, 6), (3, 10), (9, 7)]
    kernels = (fd.RING_KERNEL, fp.WINDOW_KERNEL, fp.CHUNK_RING_KERNEL)
    plain = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, impl="plain"))
    runs = {}
    for name, c, chunk in (("grouped", cfg, 0), ("chunked", cfg, 4), ("plain", plain, 0),
                           ("plain chunked", plain, 4)):
        before = [kk.launches for kk in kernels]
        fin = Engine(c, params, hot_cap=4, max_len=32, prefill_chunk=chunk).serve(
            _requests(Request, np.random.default_rng(90), specs, cfg.vocab_size), slots=2)
        runs[name] = {f.rid: (f.tokens.tolist(), f.traffic) for f in fin}
        delta = [kk.launches - n for kk, n in zip(kernels, before)]
        if name == "grouped":
            assert delta[0] > 0 and delta[1] > 0 and delta[2] == 0
        elif name == "chunked":
            assert delta[0] > 0 and delta[1] == 0 and delta[2] > 0
    assert runs["grouped"] == runs["chunked"] == runs["plain"] == runs["plain chunked"]
