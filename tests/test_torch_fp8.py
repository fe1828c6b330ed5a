"""Port parity for fp8 (e4m3) KV-cache tiers (``BitNetConfig.kv_fp8``): the
cast into a tier, every append, the plain versions of the fp8 forms of
kernels 2, 3, 6 and 8, the MLA latent fake-quant and the serving engine on
three smoke configs, against the reference.

The cast (``kv_cache.to_tier``) and every append are byte for byte. The
attention outputs are f32 arithmetic in another order, held to TOL = 2e-5
against the reference's Pallas kernels in interpret mode, which upcast each
fp8 tile to f32 as the port does; the emitted fp8 k / v are byte for byte.
(The reference's XLA path upcasts fp8 to bf16 and rounds the pending token
into the tier first, so it computes something else: the port follows the
Pallas kernels.) The engines give the JAX engine's greedy tokens and
ledgers at ``impl="pallas"``. fp8 tensors are compared by their bytes,
since NaN != NaN. The CUDA kernels run only on a card: the ``cuda``-marked
tests hold the fp8 forms against their plain versions there, bit for bit,
and skip here.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.core import dr_edram
from repro_torch.core import kv_cache as kvc
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import flash_prefill as fp
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request
from test_torch_threads import share_cpu_threads  # noqa: F401 (autouse: torch threads per worker)

TOL = dict(rtol=2e-5, atol=2e-5)
THETA = 1_000_000.0
F8 = kvc.FP8
# the cast's boundaries: the largest finite value 448, the tie at 464 (to
# 448), past it NaN; infinities and NaN; the subnormal range and its ties
SWEEP = [448.0, 449.0, 463.9, 464.0, 464.01, 470.0, 480.0, 500.0, np.inf, -np.inf, np.nan,
         2.0 ** -10, 1.5 * 2.0 ** -9, 2.0 ** -9, 2.5 * 2.0 ** -9, 0.0, -0.0, -448.0, -464.0,
         -464.01, -480.0, 2.0 ** -6, 0.99 * 2.0 ** -6, 1.0625, 1.1875]


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import bitlinear as jbitlinear
    from repro.core import kv_cache as jkvc
    from repro.core import ternary as jternary
    from repro.kernels import flash_decode as jfd
    from repro.kernels import flash_prefill as jfp
    from repro.models import pack as jpack
    from repro.models import transformer as jT
    from repro.serving import engine as jengine
    from repro.serving import scheduler as jsched

    return types.SimpleNamespace(jax=jax, jnp=jnp, f8=jnp.float8_e4m3fn, configs=jconfigs,
                                 bitlinear=jbitlinear, kvc=jkvc, ternary=jternary, fd=jfd,
                                 fp=jfp, pack=jpack, T=jT, engine=jengine, sched=jsched)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _with_sweep(a, n=None):
    """``a`` with its first elements replaced by the boundary sweep."""
    flat = a.reshape(-1).copy()
    sweep = np.asarray(SWEEP[:n], np.float32)
    flat[:sweep.size] = sweep
    return flat.reshape(a.shape)


def _bytes(x) -> np.ndarray:
    """A tier's bytes (fp8) or values, from either side."""
    if isinstance(x, torch.Tensor):
        return kvc.raw(x).numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _same(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bytes(a), _bytes(b))


# ---------------------------------------------------------------------------
# the cast
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src", ["f32", "bf16"])
@pytest.mark.parametrize("k", [-3, -2, -1, 0, 1, 2, 3])
def test_to_tier_matches_the_reference_cast(jref, src, k):
    """``to_tier`` against ``jnp.astype(float8_e4m3fn)``, byte for byte:
    the boundary sweep and 10^5 seeded normals times 10^k, from f32 and
    from bf16 (the reference's bf16 -> fp8 cast taken as it is)."""
    x = np.concatenate([np.asarray(SWEEP, np.float32), _rand(k + 10, 100_000, scale=10.0 ** k)])
    jx = jref.jnp.asarray(x)
    if src == "bf16":  # one set of bf16 bits for both (the two round NaN's sign apart)
        jx = jx.astype(jref.jnp.bfloat16)
    tx = interop.to_tensor(np.asarray(jx))
    want = np.asarray(jx.astype(jref.f8)).view(np.uint8)
    got = kvc.to_tier(tx, F8)
    assert got.dtype == F8
    np.testing.assert_array_equal(kvc.raw(got).numpy(), want)


def test_to_tier_covers_every_bf16_value(jref):
    """Every one of the 65536 bf16 bit patterns, NaNs of both signs
    included, casts as the reference casts it."""
    bits = np.arange(1 << 16, dtype=np.uint16)
    want = np.asarray(jref.jnp.asarray(bits).view(jref.jnp.bfloat16).astype(jref.f8)).view(
        np.uint8)
    got = kvc.to_tier(torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16), F8)
    np.testing.assert_array_equal(kvc.raw(got).numpy(), want)


def test_to_tier_differs_from_torch_only_past_the_overflow():
    """The reason for ``to_tier``: torch's own cast agrees below 464 and
    saturates above it, where the reference gives NaN."""
    x = torch.tensor([1.0, 448.0, 463.9, 464.0, 464.01, 1000.0, -1000.0, float("inf")])
    mine, theirs = kvc.raw(kvc.to_tier(x, F8)), kvc.raw(x.to(F8))
    assert torch.equal(mine[:4], theirs[:4])
    assert mine[4:].tolist() == [0x7F, 0x7F, 0xFF, 0x7F]
    assert kvc.to_tier(x, torch.bfloat16).dtype == torch.bfloat16  # other tiers: .to()


def test_interop_carries_fp8_bytes(jref):
    a = np.asarray(jref.jnp.asarray(np.asarray(SWEEP, np.float32)).astype(jref.f8))
    t = interop.to_tensor(a)
    assert t.dtype == F8
    np.testing.assert_array_equal(kvc.raw(t).numpy(), a.view(np.uint8))


# ---------------------------------------------------------------------------
# the appends, byte for byte
# ---------------------------------------------------------------------------


def _jcache(jref, b, hot, cold, g, d):
    return jref.kvc.init_cache(b, hot, cold, (g, d), jref.f8)


def _tcache(jc):
    return kvc.TieredKVCache(*(interop.to_tensor(a) for a in jc))


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("src", [torch.float32, torch.bfloat16])
def test_decode_appends_bit_identical(jref, ring, src):
    """Active-masked decode appends of rows carrying the boundary sweep,
    over a hot tier and a linear or ring cold tier, from f32 or bf16."""
    lens, g, d = [14, 9, 3, 0], 2, 8
    b, hot, cold = len(lens), (0 if ring else 3), 5
    ks, vs = _with_sweep(_rand(5, b, 14, g, d), 12), _with_sweep(_rand(6, b, 14, g, d) * 300)
    jc, tc = _jcache(jref, b, hot, cold, g, d), kvc.init_cache(b, hot, cold, (g, d), F8)
    jdt = jref.jnp.bfloat16 if src == torch.bfloat16 else jref.jnp.float32
    jks, jvs = jref.jnp.asarray(ks).astype(jdt), jref.jnp.asarray(vs).astype(jdt)
    tks, tvs = interop.to_tensor(np.asarray(jks)), interop.to_tensor(np.asarray(jvs))
    for t in range(14):
        act = np.asarray([t < n for n in lens])
        jappend = jref.kvc.append_decode_ring if ring else jref.kvc.append_decode
        jc = jappend(jc, jks[:, t], jvs[:, t], active=jref.jnp.asarray(act))
        (kvc.append_decode_ring if ring else kvc.append_decode)(
            tc, tks[:, t], tvs[:, t], active=torch.from_numpy(act))
    _same(tc, jc)


@pytest.mark.parametrize("ring,hot,cold,lens,valid", [
    (False, 4, 12, [0, 3, 9, 2], [7, 7, 3, 0]),
    (True, 0, 8, [0, 5, 9, 20], [12, 3, 8, 0]),
    (True, 2, 6, [0, 1, 4, 11], [12, 6, 5, 2]),
])
def test_bulk_appends_bit_identical(jref, ring, hot, cold, lens, valid):
    """Bulk (chunk) appends into fp8 tiers at per-slot offsets, linear and
    ring, -0.0 arriving as +0.0 as the reference's one-hot scatter makes
    it. Values stay within +-464, the boundary ones included: past it see
    ``test_bulk_append_writes_copies_where_the_reference_spreads_nan``."""
    b, t, g, d = len(lens), 12, 2, 8
    jc, tc = _jcache(jref, b, hot, cold, g, d), kvc.init_cache(b, hot, cold, (g, d), F8)
    pre = np.asarray(lens, np.int32)
    kp, vp = _rand(1, b, max(lens), g, d), _rand(2, b, max(lens), g, d)
    jc = jref.kvc.append(jc, jref.jnp.asarray(kp), jref.jnp.asarray(vp),
                         valid=jref.jnp.asarray(pre), ring=ring)
    kvc.append(tc, torch.from_numpy(kp), torch.from_numpy(vp), valid=torch.from_numpy(pre),
               ring=ring)
    k = _with_sweep(_rand(3, b, t, g, d), 4)  # 448 .. 464
    k.reshape(-1)[4:9] = [2.0 ** -10, -2.0 ** -11, 1.5 * 2.0 ** -9, -0.0, -448.0]
    v = np.clip(_rand(4, b, t, g, d) * 200, -464, 464)
    jv = jref.jnp.asarray(np.asarray(valid, np.int32))
    want = jref.kvc.append(jc, jref.jnp.asarray(k), jref.jnp.asarray(v), valid=jv, ring=ring)
    got = kvc.append(tc, torch.from_numpy(k), torch.from_numpy(v),
                     valid=torch.tensor(valid, dtype=torch.int32), ring=ring)
    _same(got, want)


def test_bulk_append_writes_copies_where_the_reference_spreads_nan(jref):
    """A framework property of the reference, not ported: its bulk append
    scatters by a one-hot product, so a NaN anywhere in a call's rows of a
    slot (in fp8, any |x| > 464, padding rows included) reaches that element
    of every row the call writes to the tier (0 * NaN = NaN). The port
    writes each row as a copy: the rows without NaN keep their values."""
    jc, tc = _jcache(jref, 1, 4, 4, 1, 4), kvc.init_cache(1, 4, 4, (1, 4), F8)
    k = np.ones((1, 3, 1, 4), np.float32)
    k[0, 2, 0, 1] = 1000.0  # a padding row: past valid = 2
    jv, tv = jref.jnp.asarray([2], jref.jnp.int32), torch.tensor([2], dtype=torch.int32)
    want = jref.kvc.append(jc, jref.jnp.asarray(k), jref.jnp.asarray(k), valid=jv)
    got = kvc.append(tc, torch.from_numpy(k), torch.from_numpy(k), valid=tv)
    assert np.isnan(np.asarray(want.hot_k.astype(jref.jnp.float32))[0, :2, 0, 1]).all()
    assert got.hot_k[0, :2].float().eq(1.0).all()


@pytest.mark.parametrize("ps", [4, 8])
def test_paged_appends_bit_identical(jref, ps):
    """Decode and bulk appends into a paged fp8 cache, the decode rows
    carrying the boundary sweep (cold rows are pool scatters, as in the
    reference), and a hot snapshot and paged admission of its bytes."""
    b, hot, cold, g, d = 3, 4, 12, 2, 8
    jc = jref.kvc.init_paged_cache(b, hot, cold, (g, d), jref.f8, page_size=ps)
    tc = kvc.init_paged_cache(b, hot, cold, (g, d), F8, page_size=ps)
    pre = np.asarray([3, 6, 0], np.int32)
    k, v = _rand(7, b, 6, g, d), np.clip(_rand(8, b, 6, g, d) * 300, -464, 464)
    jc = jref.kvc.append(jc, jref.jnp.asarray(k), jref.jnp.asarray(v), valid=jref.jnp.asarray(pre))
    kvc.append(tc, torch.from_numpy(k), torch.from_numpy(v), valid=torch.from_numpy(pre))
    ks, vs = _with_sweep(_rand(9, b, 9, g, d)), _rand(10, b, 9, g, d) * 400
    for t in range(9):
        act = np.asarray([True, t < 4, t % 2 == 0])
        jc = jref.kvc.append_decode(jc, jref.jnp.asarray(ks[:, t]), jref.jnp.asarray(vs[:, t]),
                                    active=jref.jnp.asarray(act))
        kvc.append_decode(tc, torch.from_numpy(ks[:, t]), torch.from_numpy(vs[:, t]),
                          active=torch.from_numpy(act))
    _same(tc, jc)
    n_hot = -(-hot // ps)
    page_ids = np.arange(tc.n_pages - n_hot, tc.n_pages, dtype=np.int32)
    jc = jref.kvc.save_hot(jc, jref.jnp.int32(1), jref.jnp.asarray(page_ids))
    kvc.save_hot(tc, 1, torch.from_numpy(page_ids))
    _same(tc, jc)
    reset = np.asarray([False, False, True])
    new_len = np.asarray([0, 0, 5], np.int32)
    table = np.asarray(tc.page_table).copy()
    hot_src = np.full((b, n_hot), -1, np.int32)
    hot_src[2] = page_ids
    cow = np.asarray([-1, -1, int(table[1, 0])], np.int32), np.asarray([-1, -1, int(table[2, 0])],
                                                                        np.int32)
    jc = jref.kvc.paged_admit(jc, *(jref.jnp.asarray(a) for a in (reset, new_len, table, hot_src,
                                                                   *cow)))
    kvc.paged_admit(tc, *(torch.from_numpy(a) for a in (reset, new_len, table, hot_src, *cow)))
    _same(tc, jc)


@pytest.mark.parametrize("ring,s", [(False, 5), (False, 13), (True, 5), (True, 13), (True, 20)])
def test_fill_fresh_bit_identical(jref, ring, s):
    """``fill_fresh`` into fp8 tiers, with the ring realign when s > the
    ring, rows carrying the boundary sweep."""
    hot, cold = (0, 8) if ring else (4, 12)
    k, v = _with_sweep(_rand(s, 2, s, 2, 8)), _rand(s + 1, 2, s, 2, 8) * 300
    want = jref.kvc.fill_fresh(_jcache(jref, 2, hot, cold, 2, 8), jref.jnp.asarray(k),
                               jref.jnp.asarray(v), ring=ring)
    got = kvc.fill_fresh(kvc.init_cache(2, hot, cold, (2, 8), F8), torch.from_numpy(k),
                         torch.from_numpy(v), ring=ring)
    _same(got, want)


# ---------------------------------------------------------------------------
# the plain versions of the fp8 forms against the reference's Pallas kernels
# ---------------------------------------------------------------------------


def _filled(jref, b, hot, cold, g, d, lens, seed, ring=False, paged_ps=0):
    """The reference's fp8 cache (contiguous, ring or paged) after
    active-masked decode appends, and the port's copy of its bytes."""
    ks, vs = _rand(seed, b, max(lens + [1]), g, d), _rand(seed + 1, b, max(lens + [1]), g, d)
    if paged_ps:
        jc = jref.kvc.init_paged_cache(b, hot, cold, (g, d), jref.f8, page_size=paged_ps)
    else:
        jc = _jcache(jref, b, hot, cold, g, d)
    append = jref.kvc.append_decode_ring if ring else jref.kvc.append_decode
    for t in range(max(lens + [0])):
        act = jref.jnp.asarray([t < n for n in lens])
        jc = append(jc, jref.jnp.asarray(ks[:, t]), jref.jnp.asarray(vs[:, t]), active=act)
    tc = type(jc)._make(interop.to_tensor(a) for a in jc)
    cls = kvc.PagedKVCache if paged_ps else kvc.TieredKVCache
    return jc, cls(*tc)


@pytest.mark.parametrize("layout,hot,cold,lens,fused", [
    ("contiguous", 4, 40, [0, 3, 20, 44], True),
    ("contiguous", 4, 40, [0, 3, 20, 44], False),
    ("paged", 4, 40, [1, 9, 33, 44], True),
    ("paged", 4, 40, [1, 9, 33, 44], False),
    ("ring", 0, 8, [0, 3, 8, 21], True),
    ("ring", 2, 40, [1, 8, 41, 100], True),
])
def test_gqa_decode_fp8_matches_reference(jref, layout, hot, cold, lens, fused):
    """Kernels 2 (fused RoPE: contiguous, paged, ring) and 6 (post-append:
    contiguous, paged) over fp8 tiers: the plain versions against the
    reference's Pallas kernels in interpret mode."""
    b, h, g, d = len(lens), 6, 2, 16
    jc, tc = _filled(jref, b, hot, cold, g, d, lens, seed=sum(lens), ring=layout == "ring",
                     paged_ps=8 if layout == "paged" else 0)
    assert tc.hot_k.dtype == F8
    q, kn, vn = _rand(1, b, h, d), _rand(2, b, g, d), _rand(3, b, g, d)
    act = np.asarray([True, False, True, True][:b])
    entry, jentry = ((fd.flash_decode_attention_ring, jref.fd.flash_decode_attention_ring)
                     if layout == "ring" else
                     (fd.flash_decode_attention, jref.fd.flash_decode_attention))
    if fused:
        want_o, want_k = jentry(jref.jnp.asarray(q), jc, impl="pallas", interpret=True,
                                k_new=jref.jnp.asarray(kn), v_new=jref.jnp.asarray(vn),
                                active=jref.jnp.asarray(act), rope_theta=THETA)
        o, k_rot = entry(torch.from_numpy(q), tc, k_new=torch.from_numpy(kn),
                         v_new=torch.from_numpy(vn), active=torch.from_numpy(act),
                         rope_theta=THETA)
        np.testing.assert_allclose(k_rot.numpy(), np.asarray(want_k), **TOL)
    else:
        want_o = jentry(jref.jnp.asarray(q), jc, impl="pallas", interpret=True)
        o = entry(torch.from_numpy(q), tc)
    assert o.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)


@pytest.mark.parametrize("lens,hot,cold,d,dv", [
    ([0, 1, 4, 5, 16], 4, 12, 24, 16),
    ([1, 40, 80], 32, 96, 576, 512),  # DeepSeek-V3's row and value widths
])
def test_latent_decode_fp8_matches_reference(jref, lens, hot, cold, d, dv):
    """Kernel 8 over fp8 latent tiers (A4a): the plain version against the
    reference's ``_flash_latent`` in interpret mode."""
    b, h = len(lens), 4
    rows = _rand(11, b, max(lens), d)
    jc = jref.kvc.init_cache(b, hot, cold, (d,), jref.f8)
    jc = jc._replace(hot_v=jref.jnp.zeros((b, hot, 0), jref.f8),
                     cold_v=jref.jnp.zeros((b, cold, 0), jref.f8))
    for t in range(max(lens)):
        act = jref.jnp.asarray([t < n for n in lens])
        jc = jref.kvc.append_decode(jc, jref.jnp.asarray(rows[:, t]),
                                    jref.jnp.zeros((b, 0)), active=act)
    tc = kvc.TieredKVCache(*(interop.to_tensor(a) for a in jc))
    q = _rand(12, b, h, d)
    scale = 24 ** -0.5
    want = jref.fd.flash_decode_attention_latent(jref.jnp.asarray(q), jc, value_dim=dv,
                                                 scale=scale, impl="pallas", interpret=True)
    got = fd.flash_decode_attention_latent(torch.from_numpy(q), tc, dv, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("rank,bits", [(16, 8), (512, 8), (16, 4)])
def test_fake_quant_latent_fp8_bit_identical(jref, rank, bits):
    """``_fake_quant_latent`` on fp8 latent rows against the reference's
    ``_q`` (act_quant_ste of the latent part, rounded back to fp8, then the
    rope dims as they are), byte for byte."""
    d = rank + 8
    rows = _rand(13, 3, 7, d) * 50
    jbuf = jref.jnp.asarray(rows).astype(jref.f8)
    want = jref.jnp.concatenate(
        [jref.ternary.act_quant_ste(jbuf[..., :rank], bits=bits), jbuf[..., rank:]], axis=-1)
    got = tattn._fake_quant_latent(interop.to_tensor(np.asarray(jbuf)), rank, bits)
    assert got.dtype == F8
    np.testing.assert_array_equal(kvc.raw(got).numpy(), np.asarray(want).view(np.uint8))


def _prefill_pair(jref, q, k, v, jcache, tcache, valid, fp8_emit=False, **kw):
    jv = jref.jnp.asarray(np.asarray(valid, np.int32))
    want = jref.fp.flash_prefill_attention(
        *(jref.jnp.asarray(a) for a in (q, k, v)), jcache, jv, rope_theta=THETA, emit_kv=True,
        kv_dtype=jref.f8 if fp8_emit else None, impl="pallas", interpret=True, block_q=4,
        block_s=4, **kw)
    got = fp.flash_prefill_attention(*(torch.from_numpy(a) for a in (q, k, v)), tcache,
                                     torch.tensor(valid, dtype=torch.int32), rope_theta=THETA,
                                     kv_dtype=F8 if fp8_emit else None, **kw)
    return got, want


@pytest.mark.parametrize("form", ["fresh", "window", "chunk", "paged", "ring"])
def test_prefill_fp8_matches_reference(jref, form):
    """Kernel 3's GQA forms with an fp8 emit (A3d): fresh and window with
    ``kv_dtype`` fp8, and the chunked forms over fp8 tiers (contiguous,
    paged, ring); outputs to TOL against the reference's Pallas kernel in
    interpret mode, the emitted k / v byte for byte, v carrying the
    boundary sweep."""
    b, s, g, rep, d = 3, 9, 2, 2, 16
    q, k = _rand(20, b, s, g * rep, d), _rand(21, b, s, g, d)
    v = _with_sweep(_rand(22, b, s, g, d))
    valid = [9, 6, 0] if form in ("chunk", "paged", "ring") else [9, 6, 3]
    kw, jcache, tcache = {}, None, None
    if form in ("fresh", "window"):
        kw["fp8_emit"] = True
        if form == "window":
            kw["window"] = 3
    else:
        lens = [5, 13, 7]
        ring = form == "ring"
        jcache, tcache = _filled(jref, b, 0 if ring else 4, 8 if ring else 28, g, d, lens,
                                 seed=30, ring=ring, paged_ps=8 if form == "paged" else 0)
        if ring:
            kw.update(window=8, ring=True)
    (o, k_c, v_c), (want_o, want_k, want_v) = _prefill_pair(jref, q, k, v, jcache, tcache,
                                                            valid, **kw)
    assert k_c.dtype == v_c.dtype == F8
    for i, n in enumerate(valid):
        np.testing.assert_allclose(o[i, :n].numpy(), np.asarray(want_o)[i, :n], **TOL)
    np.testing.assert_array_equal(kvc.raw(k_c).numpy(), np.asarray(want_k).view(np.uint8))
    np.testing.assert_array_equal(kvc.raw(v_c).numpy(), np.asarray(want_v).view(np.uint8))


def test_prefill_emit_in_bf16_rounds_through_bf16(jref):
    """With bf16 inputs the emit is the input-dtype value cast to fp8 (the
    reference's ``.astype(k_in_dtype).astype(fp8)``), v carrying the sweep."""
    b, s, g, rep, d = 2, 8, 1, 2, 16
    q, k, v = _rand(40, b, s, g * rep, d), _rand(41, b, s, g, d), _with_sweep(_rand(42, b, s, g, d))
    jqkv = [jref.jnp.asarray(a).astype(jref.jnp.bfloat16) for a in (q, k, v)]
    want = jref.fp.flash_prefill_attention(
        *jqkv, None, jref.jnp.asarray([8, 5], jref.jnp.int32), rope_theta=THETA, emit_kv=True,
        kv_dtype=jref.f8, impl="pallas", interpret=True, block_q=4, block_s=4)
    got = fp.flash_prefill_attention(*(interop.to_tensor(np.asarray(a)) for a in jqkv),
                                     None, torch.tensor([8, 5], dtype=torch.int32),
                                     rope_theta=THETA, kv_dtype=F8)
    np.testing.assert_array_equal(kvc.raw(got[2]).numpy(), np.asarray(want[2]).view(np.uint8))
    np.testing.assert_array_equal(kvc.raw(got[1]).numpy(), np.asarray(want[1]).view(np.uint8))


# ---------------------------------------------------------------------------
# the engine against the JAX engine at impl="pallas"
# ---------------------------------------------------------------------------


def _numpy_tree(jref, tree):
    """Reference tree -> numpy, packed leaves as plain field dicts; MLA's
    w_uk / w_uv as the reference's fake-quantized values ``{"fq"}``."""
    if isinstance(tree, (jref.bitlinear.PackedLinear, jref.bitlinear.FusedPackedLinear)):
        out = dict(packed=np.asarray(tree.packed), scale=np.asarray(tree.scale),
                   k=tree.k, codec=tree.codec)
        if isinstance(tree, jref.bitlinear.FusedPackedLinear):
            out["splits"] = tree.splits
        return out
    if isinstance(tree, dict):
        return {k: ({"fq": np.stack([np.asarray(jref.ternary.weight_quant_ste(w))
                                     for w in v["w"]])}
                    if k in ("w_uk", "w_uv") else _numpy_tree(jref, v))
                for k, v in tree.items()}
    return np.asarray(tree)


_MODELS: dict = {}


def _models(jref, name, seed, kv_fp8=True):
    """The reference's packed seeded weights and the port's copy, built
    once per (name, seed, kv_fp8) for the module (engines only read them)."""
    key = (name, seed, kv_fp8)
    if key not in _MODELS:
        _MODELS[key] = _build_models(jref, name, seed, kv_fp8)
    return _MODELS[key]


def _build_models(jref, name, seed, kv_fp8):
    jcfg = jref.configs.get_smoke_config(name)
    jcfg = dataclasses.replace(jcfg, bitnet=dataclasses.replace(
        jcfg.bitnet, kv_fp8=kv_fp8, impl="pallas"))
    cfg = get_smoke_config(name)
    cfg = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, kv_fp8=kv_fp8))
    jpacked = jref.pack.pack_params(jref.T.init_params(jref.jax.random.PRNGKey(seed), jcfg), jcfg)
    return jcfg, jpacked, cfg, interop.params_from_reference(_numpy_tree(jref, jpacked))


def _requests(cls, rng, specs, vocab):
    return [cls(i, rng.integers(0, vocab, (p,)).astype(np.int32), n)
            for i, (p, n) in enumerate(specs)]


def test_init_decode_cache_is_fp8_in_every_layout():
    """``kv_fp8`` makes the contiguous, paged and ring tiers fp8, the
    latent cache's too; lengths and tables stay int32."""
    for name, kw in (("falcon3-1b", {}), ("falcon3-1b", dict(paged=True, page_size=8)),
                     ("mixtral-8x22b", {}), ("deepseek-v3-671b", {})):
        cfg = get_smoke_config(name)
        cfg = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, kv_fp8=True))
        for stack in T.init_decode_cache(cfg, 2, 24, 4, device="cpu", **kw).values():
            assert all(t.dtype == F8 for t in stack[:4]) and stack.lengths.dtype == torch.int32


@pytest.mark.parametrize("name", ["falcon3-1b", "deepseek-v3-671b", "mixtral-8x22b"])
def test_generate_fp8_matches_reference_engine(jref, name):
    """Grouped admission over fp8 tiers: 3 x (8 + 16) tokens, tokens and
    ledgers equal to the JAX engine's at impl="pallas", the ledger at the
    closed form (2 bytes a value, as the reference charges)."""
    jcfg, jpacked, cfg, tparams = _models(jref, name, seed=1)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)
    kw = dict(hot_cap=4, max_len=48, slots=3)
    jeng = jref.engine.Engine(jcfg, jpacked, **kw)
    want = jeng.generate(jref.jnp.asarray(prompts), max_new_tokens=16)
    eng = Engine(cfg, tparams, device="cpu", **kw)
    got = eng.generate(prompts, max_new_tokens=16)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.traffic == want.traffic
    assert eng.weight_loads == jeng.weight_loads == 0
    assert eng._kv_token_bytes() == jeng._kv_token_bytes()
    closed = dr_edram.closed_form_reduction(8 + 16, 4)
    for f in got.finished:
        assert f.seq_len == 24 and abs(f.external_reduction - closed) <= 1e-12


@pytest.mark.parametrize("name,kw", [
    ("falcon3-1b", dict(prefill_chunk=4)),
    ("falcon3-1b", dict(prefill_chunk=4, paged=True, page_size=8)),
    ("mixtral-8x22b", dict(prefill_chunk=0)),
    ("mixtral-8x22b", dict(prefill_chunk=4)),
])
def test_serve_fp8_matches_reference_engine(jref, name, kw):
    """Chunked (and paged, with two prompts sharing a prefix) admission and
    the sliding-window ring, grouped and chunked, over fp8 tiers: per
    request tokens and ledgers equal to the JAX engine's."""
    jcfg, jpacked, cfg, tparams = _models(jref, name, seed=1)
    rng = np.random.default_rng(90)
    specs = [(12, 6), (3, 10), (9, 7), (17, 5)]
    reqs = _requests(Request, rng, specs, cfg.vocab_size)
    if kw.get("paged"):
        reqs[3] = Request(3, np.concatenate([reqs[0].tokens, reqs[3].tokens[:5]]), 5)
    jreqs = [jref.sched.Request(r.rid, r.tokens, r.max_new_tokens) for r in reqs]
    ekw = dict(hot_cap=4, max_len=40, **kw)
    want = jref.engine.Engine(jcfg, jpacked, **ekw).serve(jreqs, slots=2)
    got = Engine(cfg, tparams, device="cpu", **ekw).serve(reqs, slots=2)
    assert [f.rid for f in got] == [f.rid for f in want]
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_.tokens, w.tokens)
        assert (g_.seq_len, g_.steps, g_.traffic) == (w.seq_len, w.steps, w.traffic)


def test_fp8_tiers_change_deepseek_tokens(jref):
    """A guard that the tiers really are fp8: on deepseek-v3-671b-smoke
    (the reference's seed-1 weights, prompts 3 x 8) fp8 tiers change row
    0's tokens against f32 tiers and leave rows 1 and 2, in the port as in
    the reference, so a port that quietly kept f32 tiers fails here."""
    rows = {}
    for kv_fp8 in (False, True):
        jcfg, jpacked, cfg, tparams = _models(jref, "deepseek-v3-671b", seed=1, kv_fp8=kv_fp8)
        prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)
        rows[kv_fp8] = Engine(cfg, tparams, hot_cap=4, max_len=48, slots=3, device="cpu").generate(
            prompts, max_new_tokens=16).tokens.numpy()
    assert (rows[False] == rows[True]).all(axis=1).tolist() == [False, True, True]


def test_chunked_and_grouped_admission_differ_under_fp8(jref):
    """A framework property that holds in the reference too: the kernels
    attend to a chunk's own keys at full precision and to cached keys
    fp8-rounded, so a prompt admitted whole and in chunks reads different
    key values. falcon3-1b-smoke, prompts 3 x 12, prefill_chunk 4: both
    engines give the same tokens in each mode, and chunked differs from
    grouped in the same rows."""
    jcfg, jpacked, cfg, tparams = _models(jref, "falcon3-1b", seed=1)
    specs = [(12, 10)] * 3
    got, want = {}, {}
    for chunk in (0, 4):
        kw = dict(hot_cap=4, max_len=40, prefill_chunk=chunk)
        reqs = _requests(Request, np.random.default_rng(5), specs, cfg.vocab_size)
        jreqs = [jref.sched.Request(r.rid, r.tokens, r.max_new_tokens) for r in reqs]
        got[chunk] = [f.tokens for f in
                      Engine(cfg, tparams, device="cpu", **kw).serve(reqs, slots=3)]
        want[chunk] = [f.tokens for f in
                       jref.engine.Engine(jcfg, jpacked, **kw).serve(jreqs, slots=3)]
        for g_, w in zip(got[chunk], want[chunk]):
            np.testing.assert_array_equal(g_, w)
    same = [np.array_equal(a, b) for a, b in zip(got[0], got[4])]
    assert same == [np.array_equal(a, b) for a, b in zip(want[0], want[4])]
    assert not all(same)


def test_preempted_and_speculative_serves_differ_under_fp8(jref):
    """The same framework property for recompute and speculation: a
    re-prefill after a preemption and a verify chunk read their own rows
    at full precision where the sequential decode read them back from the
    fp8 cache. falcon3-1b-smoke over fp8 tiers (hot 4, max_len 64,
    prefill_chunk 4, page size 8; eight prompts of 10-17 tokens + 30, 4
    slots): (a) a paged serve on 7 pages, which preempts, against the
    default pool; (b) a speculative serve (K 4) against the sequential
    one, with the target as its own draft: a verify row reads the chunk's
    earlier rows at full precision only where proposals were accepted
    (with none accepted every emitted row is the decode's own). Both
    engines give the same tokens in every run, and each pressured or
    speculative serve differs from its baseline in the same requests in
    both, on at least one request."""
    jcfg, jpacked, cfg, tparams = _models(jref, "falcon3-1b", seed=1)
    rng = np.random.default_rng(9)
    specs = [(10 + i, 30) for i in range(8)]
    base = dict(hot_cap=4, max_len=64, prefill_chunk=4)
    paged = dict(base, paged=True, page_size=8)
    runs = {"unpressured": (paged, {}), "preempted": (paged, dict(n_pages=7)),
            "sequential": (base, {}), "speculative": (base, dict(spec_k=4))}
    reqs = _requests(Request, rng, specs, cfg.vocab_size)
    got, want = {}, {}
    for name, (kw, extra) in runs.items():
        pkw, jkw = dict(kw, **extra), dict(kw, **extra)
        if "spec_k" in extra:
            pkw.update(draft_cfg=cfg, draft_params=tparams)
            jkw.update(draft_cfg=jcfg, draft_params=jpacked)
        eng = Engine(cfg, tparams, device="cpu", **pkw)
        jeng = jref.engine.Engine(jcfg, jpacked, **jkw)
        fresh = [Request(r.rid, r.tokens, r.max_new_tokens) for r in reqs]
        jreqs = [jref.sched.Request(r.rid, r.tokens, r.max_new_tokens) for r in reqs]
        got[name] = {f.rid: f.tokens for f in eng.serve(fresh, slots=4, sync_every=4)}
        want[name] = {f.rid: np.asarray(f.tokens) for f in jeng.serve(jreqs, slots=4,
                                                                        sync_every=4)}
        for rid in got[name]:
            np.testing.assert_array_equal(got[name][rid], want[name][rid])
        if name == "preempted":
            assert eng.last_stats.preemptions == jeng.last_stats.preemptions > 0
        if name == "speculative":
            assert eng.last_stats.accepted_tokens == jeng.last_stats.accepted_tokens > 0
    for run, ref in (("preempted", "unpressured"), ("speculative", "sequential")):
        same = [np.array_equal(got[run][r], got[ref][r]) for r in sorted(got[run])]
        assert same == [np.array_equal(want[run][r], want[ref][r]) for r in sorted(want[run])]
        assert not all(same), run


# ---------------------------------------------------------------------------
# on the card: the fp8 forms against their plain versions, bit for bit
# ---------------------------------------------------------------------------


def _card_cache(dev, dtype, lens, hot, cold, g, d, seed, paged_ps=0, ring=False):
    gen = torch.Generator().manual_seed(seed)
    b, t = len(lens), max(lens + [1])
    if paged_ps:
        c = kvc.init_paged_cache(b, hot, cold, (g, d), F8, page_size=paged_ps, device=dev)
    else:
        c = kvc.init_cache(b, hot, cold, (g, d), F8, device=dev)
    k = torch.randn(b, t, g, d, generator=gen).to(dev, dtype)
    v = torch.randn(b, t, g, d, generator=gen).to(dev, dtype)
    if ring:
        for i in range(t):
            kvc.append_decode_ring(c, k[:, i], v[:, i],
                                   active=torch.tensor([i < n for n in lens], device=dev))
    else:
        kvc.append(c, k, v, valid=torch.tensor(lens, dtype=torch.int32, device=dev))
    return c


def _equal_bytes(a, b):
    return torch.equal(kvc.raw(a).cpu(), kvc.raw(b).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 256), (6, 8, 128), (4, 2, 16)])  # rep, g, d
@pytest.mark.parametrize("layout", ["contiguous", "paged", "ring"])
def test_cuda_fp8_decode_kernels_bit_identical(cuda, dtype, shape, layout):
    """Kernel 2 over fp8 tiers (A1c; contiguous, paged, ring) and kernel 6
    (contiguous, paged): o and k_rot equal to the plain version, one launch
    of the fp8 entry point each."""
    rep, g, d = shape
    lens = [0, 37, 100, 129] if layout != "ring" else [5, 64, 64, 200]
    ring = layout == "ring"
    c = _card_cache(cuda, dtype, lens, 0 if ring else 32, 64 if ring else 96, g, d, seed=d,
                    paged_ps=16 if layout == "paged" else 0, ring=ring)
    b, h = len(lens), rep * g
    gen = torch.Generator().manual_seed(1)
    q, kn, vn = (torch.randn(*s_, generator=gen).to(cuda, dtype)
                 for s_ in ((b, h, d), (b, g, d), (b, g, d)))
    act = torch.tensor([True, False, True, True], device=cuda)
    kw = dict(k_new=kn, v_new=vn, active=act, rope_theta=THETA)
    entry = fd.flash_decode_attention_ring if ring else fd.flash_decode_attention
    kernel = {"contiguous": fd.FP8_KERNEL, "paged": fd.FP8_PAGED_KERNEL,
              "ring": fd.FP8_RING_KERNEL}[layout]
    n0 = kernel.launches
    o, k_rot = entry(q, c, **kw)
    assert kernel.launches == n0 + 1
    o_p, k_p = entry(q, c, impl="plain", **kw)
    assert torch.equal(o.cpu(), o_p.cpu()) and torch.equal(k_rot.cpu(), k_p.cpu())
    if not ring:
        post = fd.FP8_GQA_PAGED_KERNEL if layout == "paged" else fd.FP8_GQA_KERNEL
        n0 = post.launches
        o = fd.flash_decode_attention(q, c)
        assert post.launches == n0 + 1
        assert torch.equal(o.cpu(), fd.flash_decode_attention(q, c, impl="plain").cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(576, 512), (24, 16)])
def test_cuda_fp8_latent_kernel_bit_identical(cuda, dims):
    """Kernel 8 over fp8 latent tiers (A4a) at DeepSeek-V3's and the smoke
    widths: equal to the plain version, one launch."""
    d, dv = dims
    b, h = 4, 128
    gen = torch.Generator().manual_seed(d)
    c = kvc.init_cache(b, 32, 96, (d,), F8, device=cuda, v_shape=(0,))
    rows = torch.randn(b, 128, d, generator=gen).to(cuda)
    kvc.append(c, rows, rows[..., :0], valid=torch.tensor([0, 1, 40, 128], device=cuda))
    q = torch.randn(b, h, d, generator=gen).to(cuda)
    n0 = fd.LATENT_FP8_KERNEL.launches
    got = fd.flash_decode_attention_latent(q, c, dv, 0.05)
    assert fd.LATENT_FP8_KERNEL.launches == n0 + 1
    assert torch.equal(got.cpu(), fd.flash_decode_attention_latent(q, c, dv, 0.05,
                                                                   impl="plain").cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 256), (6, 8, 128)])
@pytest.mark.parametrize("form", ["fresh", "window", "chunk", "paged", "ring"])
def test_cuda_fp8_prefill_kernels_bit_identical(cuda, dtype, shape, form):
    """Kernel 3's fp8 forms (A3d): o equal to the plain version and the
    emitted fp8 k / v byte-equal, one launch of the fp8 entry point each;
    then v rows carrying the boundary sweep: the emitted v byte-equal to
    the plain version's (o then holds inf / NaN and is not compared)."""
    rep, g, d = shape
    b, s = 3, 40
    gen = torch.Generator().manual_seed(7)
    q = torch.randn(b, s, rep * g, d, generator=gen).to(cuda, dtype)
    k = torch.randn(b, s, g, d, generator=gen).to(cuda, dtype)
    v = torch.randn(b, s, g, d, generator=gen)
    v_sweep = torch.from_numpy(_with_sweep(v.numpy())).to(cuda, dtype)
    v = v.to(cuda, dtype)
    valid = torch.tensor([s, 33, 0 if form in ("chunk", "paged", "ring") else 7],
                         dtype=torch.int32, device=cuda)
    kw, cache = dict(valid=valid, rope_theta=THETA, kv_dtype=F8), None
    kernel = {"fresh": fp.FP8_KERNEL, "window": fp.FP8_WINDOW_KERNEL, "chunk": fp.FP8_CHUNK_KERNEL,
              "paged": fp.FP8_CHUNK_PAGED_KERNEL, "ring": fp.FP8_CHUNK_RING_KERNEL}[form]
    if form == "window":
        kw["window"] = 8
    if form in ("chunk", "paged", "ring"):
        ring = form == "ring"
        cache = _card_cache(cuda, dtype, [0, 45, 100], 0 if ring else 32, 64 if ring else 96, g,
                            d, seed=3, paged_ps=16 if form == "paged" else 0, ring=ring)
        if ring:
            kw.update(window=64, ring=True)
    n0 = kernel.launches
    got = fp.flash_prefill_attention(q, k, v, cache, **kw)
    assert kernel.launches == n0 + 1
    want = fp.flash_prefill_attention(q, k, v, cache, impl="plain", **kw)
    assert torch.equal(got[0].cpu(), want[0].cpu())
    assert _equal_bytes(got[1], want[1]) and _equal_bytes(got[2], want[2])
    got_v = fp.flash_prefill_attention(q, k, v_sweep, cache, **kw)[2]
    assert kernel.launches == n0 + 2
    assert _equal_bytes(got_v, fp.flash_prefill_attention(q, k, v_sweep, cache, impl="plain",
                                                          **kw)[2])
