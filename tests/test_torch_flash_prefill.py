"""Port parity for the causal flash prefill and the attention layer around
it (repro_torch.kernels.flash_prefill, models.attention,
core.kv_cache.fill_fresh) against the reference's ``_flash_prefill``
Pallas kernel (interpret mode) and its XLA path: the fresh form
(``cache=None``) and, across group sizes, the chunked form over a live
cache (``tests/test_torch_chunked_prefill.py`` holds the rest of it).

The emitted v is a copy and must match bit for bit; the attention output
and the rotated k are f32 arithmetic in another order (and cos / sin
differ by an ulp between the frameworks), held to TOL = 2e-5. The CUDA
kernels run only on a card: the ``cuda``-marked tests hold the GQA kernel
against the plain version there, bit for bit, over the rep / d / s /
valid layouts its 16-row blocks meet, check that the MLA form has its own
entry point, and skip here. What the kernels' bit-identity rests on is
checked here too: a model of their dot-product order over a head width
zero-padded to a power of two equals the plain version's ``tree_sum``.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.core import kv_cache as kvc
from repro_torch.kernels import flash_prefill as fp
from repro_torch.kernels.flash_decode import tree_sum
from repro_torch.models import attention as tattn
from test_torch_paged import _card_pair, _shuffle_pages
from test_torch_threads import share_cpu_threads  # noqa: F401 (autouse: torch threads per worker)

TOL = dict(rtol=2e-5, atol=2e-5)
THETA = 1_000_042.0


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import kv_cache as jkvc
    from repro.kernels import flash_prefill as jfp
    from repro.models import attention as jattn

    return types.SimpleNamespace(jnp=jnp, kvc=jkvc, fp=jfp, attn=jattn)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _qkv(seed, b, s, h, g, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, g, d), (b, s, g, d)))


@pytest.mark.parametrize("s,valid", [
    (8, [8, 8, 8]),
    (13, [13, 7, 0]),  # partial and empty slots
    (40, [40, 33, 1]),  # two key tiles
])
def test_fresh_prefill_matches_pallas_and_xla(jref, s, valid):
    b, h, g, d = 3, 4, 2, 16
    q, k, v = _qkv(s, b, s, h, g, d)
    jv = jref.jnp.asarray(np.asarray(valid, np.int32))
    jq, jk, jvv = (jref.jnp.asarray(a) for a in (q, k, v))
    outs = [jref.fp.flash_prefill_attention(jq, jk, jvv, None, jv, rope_theta=THETA,
                                            emit_kv=True, impl=impl, interpret=True)
            for impl in ("pallas", "xla")]
    o, k_c, v_c = fp.flash_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        valid=torch.tensor(valid, dtype=torch.int32), rope_theta=THETA)
    for want_o, want_k, want_v in outs:
        np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
        np.testing.assert_allclose(k_c.numpy(), np.asarray(want_k), **TOL)
        np.testing.assert_array_equal(v_c.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("s", [1, 33])
@pytest.mark.parametrize("rep", [1, 4, 7])
def test_fresh_prefill_matches_pallas_and_xla_across_group_sizes(jref, s, rep):
    """The GQA kernel's block tiling spreads rows over (token, grouped
    head): the rep / d spread of the served models (gemma-7b rep 1,
    qwen3-8b rep 4, deepseek-coder-33b rep 7) at a small size."""
    b, g, d = 3, 2, 32
    valid = [s, max(s - 5, 1), 0]
    q, k, v = _qkv(100 * rep + s, b, s, g * rep, g, d)
    jv = jref.jnp.asarray(np.asarray(valid, np.int32))
    jq, jk, jvv = (jref.jnp.asarray(a) for a in (q, k, v))
    outs = [jref.fp.flash_prefill_attention(jq, jk, jvv, None, jv, rope_theta=THETA,
                                            emit_kv=True, impl=impl, interpret=True)
            for impl in ("pallas", "xla")]
    o, k_c, v_c = fp.flash_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        valid=torch.tensor(valid, dtype=torch.int32), rope_theta=THETA)
    for want_o, want_k, want_v in outs:
        np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
        np.testing.assert_allclose(k_c.numpy(), np.asarray(want_k), **TOL)
        np.testing.assert_array_equal(v_c.numpy(), np.asarray(want_v))


def test_blockwise_attention_matches_reference(jref):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 2, 2, 19, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 19, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 19, 16)).astype(np.float32)
    kw = dict(causal=True, q_chunk=8, kv_chunk=8)
    want = np.asarray(jref.attn.blockwise_attention(*(jref.jnp.asarray(a) for a in (q, k, v)),
                                                    **kw))
    got = tattn.blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_prefill_matches_blockwise_reference():
    """The fresh prefill equals full causal attention over rotated q / k."""
    from repro_torch.models.layers import apply_rope

    b, s, h, g, d = 2, 37, 4, 2, 16
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, b, s, h, g, d))
    o, k_c, _ = fp.flash_prefill_attention(q, k, v, rope_theta=THETA)
    pos = torch.arange(s)[None]
    qr, kr = apply_rope(q, pos, THETA), apply_rope(k, pos, THETA)
    want = tattn.blockwise_attention(
        qr.reshape(b, s, g, 2, d).permute(0, 2, 3, 1, 4), kr.permute(0, 2, 1, 3),
        v.permute(0, 2, 1, 3), q_chunk=16, kv_chunk=16)
    torch.testing.assert_close(o, want.permute(0, 3, 1, 2, 4).reshape(b, s, h, d), **TOL)
    assert torch.equal(k_c, kr)


@pytest.mark.parametrize("s,hot,cold", [(6, 4, 12), (3, 4, 12), (16, 4, 12)])
def test_fill_fresh_bit_identical(jref, s, hot, cold):
    k, v, _ = _qkv(s, 2, s, 2, 2, 16)
    want = jref.kvc.fill_fresh(jref.kvc.init_cache(2, hot, cold, (2, 16), jref.jnp.float32),
                               jref.jnp.asarray(k), jref.jnp.asarray(v))
    got = kvc.fill_fresh(kvc.init_cache(2, hot, cold, (2, 16)), torch.from_numpy(k),
                         torch.from_numpy(v))
    for a, b_ in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))


@pytest.mark.parametrize("form", ["window", "ring", "paged", "kv_dtype", "mla_cache",
                                  "mla_emit"])
def test_forms_not_ported_raise(form):
    """The forms that do not exist raise, on the CPU as on the card: an SWA
    window, the ring cold tier, or both over a paged cache (the window and
    ring forms themselves, A3c, are ported; the reference has no paged
    window or ring: tests/test_torch_swa.py holds the ported forms), an
    emit dtype other than the cache tiers' (the fp8 emit and tiers, A3d,
    are ported: tests/test_torch_fp8.py), and the MLA form over a cache
    (the reference never chunks MLA) or with whole-head emits."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 4, 2, 1, 16))
    cache = kvc.init_cache(1, 2, 2, (1, 16))
    paged = kvc.init_paged_cache(1, 2, 2, (1, 16), page_size=2)
    kw = {"window": dict(cache=paged, window=2), "ring": dict(cache=paged, ring=True),
          "paged": dict(cache=paged, window=2, ring=True),
          "kv_dtype": dict(cache=cache, kv_dtype=torch.bfloat16),
          "mla_cache": dict(cache=cache, rope_dims=8, emit_kv=False),
          "mla_emit": dict(emit_kv=False)}[form]
    with pytest.raises(NotImplementedError):
        fp.flash_prefill_attention(q, k, v, **kw)


@pytest.mark.parametrize("form", ["window", "ring"])
def test_window_and_ring_forms_match_pallas_and_xla(jref, form):
    """The two raise cases above before the forms were ported, now parity
    cases: a window over the fresh form, and a chunk over a wrapped ring
    (hot 0, cold 8; offsets past, at and before the wrap) with the window
    of the ring's size; o on valid rows and k_cast to TOL, v_cast exactly."""
    b, g, d, w = 3, 2, 16, 8
    valid = [6, 4, 0]
    q, k, v = _qkv(50 + len(form), b, 6, 4, g, d)
    jcache, cache, kw = None, None, dict(window=w)
    if form == "ring":
        rng = np.random.default_rng(51)
        jcache = jref.kvc.init_cache(b, 0, w, (g, d), jref.jnp.float32)
        for t in range(13):
            act = jref.jnp.asarray([True, t < 8, t < 3])
            jcache = jref.kvc.append_decode_ring(
                jcache, *(jref.jnp.asarray(rng.standard_normal((b, g, d)).astype(np.float32))
                          for _ in range(2)), active=act)
        cache = kvc.TieredKVCache(*(torch.from_numpy(np.asarray(a).copy()) for a in jcache))
        kw["ring"] = True
    jv = jref.jnp.asarray(np.asarray(valid, np.int32))
    outs = [jref.fp.flash_prefill_attention(
        *(jref.jnp.asarray(a) for a in (q, k, v)), jcache, jv, rope_theta=THETA, emit_kv=True,
        impl=impl, interpret=True, **kw) for impl in ("pallas", "xla")]
    o, k_c, v_c = fp.flash_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), cache,
        torch.tensor(valid, dtype=torch.int32), rope_theta=THETA, **kw)
    for want_o, want_k, want_v in outs:
        for i, n in enumerate(valid):
            np.testing.assert_allclose(o[i, :n].numpy(), np.asarray(want_o)[i, :n], **TOL)
        np.testing.assert_allclose(k_c.numpy(), np.asarray(want_k), **TOL)
        np.testing.assert_array_equal(v_c.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("s", [1, 33])
@pytest.mark.parametrize("rep", [1, 4, 7])
def test_chunk_form_matches_pallas_and_xla_across_group_sizes(jref, s, rep):
    """The chunked form (a live cache of hot 4 / cold 12, offsets 0, 3 and
    9) at the group sizes of the fresh test above: o on valid rows and
    k_cast to TOL, v_cast exactly."""
    b, g, d = 3, 2, 32
    lens, valid = [0, 3, 9], [s, max(s - 5, 1), 0]
    rng = np.random.default_rng(rep + s)
    tiers = [rng.standard_normal((b, cap, g, d)).astype(np.float32)
             for cap in (4, 4, 12, 12)] + [np.asarray(lens, np.int32)]
    q, k, v = _qkv(200 * rep + s, b, s, g * rep, g, d)
    jv = jref.jnp.asarray(np.asarray(valid, np.int32))
    jc = jref.kvc.TieredKVCache(*(jref.jnp.asarray(a) for a in tiers))
    got = fp.flash_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kvc.TieredKVCache(*(torch.from_numpy(a) for a in tiers)),
        torch.tensor(valid, dtype=torch.int32), rope_theta=THETA)
    for impl in ("pallas", "xla"):
        want = jref.fp.flash_prefill_attention(
            *(jref.jnp.asarray(a) for a in (q, k, v)), jc, jv, rope_theta=THETA, impl=impl,
            interpret=True)
        for i, n in enumerate(valid):
            np.testing.assert_allclose(got[0][i, :n].numpy(), np.asarray(want[0])[i, :n], **TOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def _bit_reverse(x, bits):
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def _trailing_ones(x):
    return len(bin(x)) - len(bin(x).rstrip("1"))


def _dot_rows_order(prod):
    """The kernels' dot product (``dot_rows`` in csrc/flash_prefill.cuh) of
    each row of f32 products (rows, d), in their order: the width padded to
    a power of two dp, the dims split by residue p mod 4, each residue's
    dp / 4 steps taken in bit-reversed order in groups of 16 on binary-
    counter stacks, the groups pushed on a second stack, and
    ((T0 + T2) + (T1 + T3)) at the end. A step past d is padding: its
    products are the constant +0.0, never read."""
    d = prod.shape[1]
    n = (1 << (d - 1).bit_length()) // 4
    ni = min(n, 16)
    ng = n // ni
    lbi, lbo = ni.bit_length() - 1, ng.bit_length() - 1
    zero = np.zeros(prod.shape[0], np.float32)
    ost = [[None] * (lbo + 1) for _ in range(4)]
    for grp in range(ng):
        base = 4 * _bit_reverse(grp, lbo)
        st = [[None] * (lbi + 1) for _ in range(4)]
        for c in range(ni):
            off, t = 4 * ng * _bit_reverse(c, lbi), _trailing_ones(c)
            for p in range(4):
                x = zero if off >= d else prod[:, base + off + p]
                for lvl in range(t):
                    x = st[p][lvl] + x
                st[p][t] = x
        t = _trailing_ones(grp)
        for p in range(4):
            x = st[p][lbi]
            for lvl in range(t):
                x = ost[p][lvl] + x
            ost[p][t] = x
    return (ost[0][lbo] + ost[2][lbo]) + (ost[1][lbo] + ost[3][lbo])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("d", [24, 128, 192, 256])
def test_padded_dot_order_equals_tree_sum(d, seed):
    """The order the prefill kernels sum a dot product in, with the padded
    dims as constant +0.0, equals the plain version's zero-padded halving
    tree bit for bit: on random rows, on rows of every sign of zero (where
    -0 + +0 = +0 shows), and on rows of mixed magnitudes."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((256, d)).astype(np.float32)
    k = rng.standard_normal((256, d)).astype(np.float32)
    q[1] = 0.0  # products -0 or +0 by the sign of k
    k[2] = -np.abs(k[2])
    q[2] = 0.0  # every product -0
    q[3:64] *= np.exp2(rng.integers(-30, 30, (61, d))).astype(np.float32)
    prod = q * k  # the kernels' products, each rounded to f32
    got = _dot_rows_order(prod)
    want = tree_sum(torch.from_numpy(prod), -1).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 31, 32, 33, 128])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("rep", [1, 2, 4, 7, 8])
def test_cuda_kernel_bit_identical_to_plain(cuda, rep, d, s, dtype):
    """Every layout the kernel's 16-row blocks meet: rep 1 / 2 / 4 / 7 / 8
    (gemma-7b, falcon3-1b, qwen3-8b, deepseek-coder-33b, rep > block rows),
    ragged and empty slots; o, k_cast and v_cast equal bit for bit."""
    b, g = 4, 2
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(cuda, dt)
               for a in _qkv(1000 * rep + s, b, s, g * rep, g, d))
    valid = torch.tensor([0, 1, max(s - 5, 0), s], dtype=torch.int32, device=cuda)
    before = fp.KERNEL.launches
    got = fp.flash_prefill_attention(q, k, v, valid=valid, rope_theta=THETA)
    torch.cuda.synchronize()
    assert fp.KERNEL.launches == before + 1
    want = fp.flash_prefill_attention(q, k, v, valid=valid, rope_theta=THETA, impl="plain")
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("s,dtype", [(32, "float32"), (77, "float32"), (128, "float32"),
                                     (32, "bfloat16")])
def test_cuda_kernel_bit_identical_to_plain_falcon_shape(cuda, s, dtype):
    b, h, g, d = 6, 8, 4, 256
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(cuda, dt) for a in _qkv(s, b, s, h, g, d))
    valid = torch.tensor([s, s - 5, 0, s, 1, s], dtype=torch.int32, device=cuda)
    before = fp.KERNEL.launches
    got = fp.flash_prefill_attention(q, k, v, valid=valid, rope_theta=THETA)
    want = fp.flash_prefill_attention(q, k, v, valid=valid, rope_theta=THETA, impl="plain")
    torch.cuda.synchronize()
    assert fp.KERNEL.launches == before + 1
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mla_form_has_its_own_entry_point(cuda, dtype):
    """The MLA form (dk 192 of which 64 rotate, dv 128) launches its own
    entry point, bit-identical to plain, and never the GQA one."""
    b, s, h, dk, dv = 2, 33, 4, 192, 128
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        cuda, getattr(torch, dtype)) for shape in ((b, s, h, dk), (b, s, h, dk), (b, s, h, dv)))
    valid = torch.tensor([s, 7], dtype=torch.int32, device=cuda)
    kw = dict(valid=valid, rope_theta=THETA, rope_dims=64, emit_kv=False, scale=dk ** -0.5)
    gqa, mla = fp.KERNEL.launches, fp.MLA_KERNEL.launches
    got = fp.flash_prefill_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (fp.KERNEL.launches, fp.MLA_KERNEL.launches) == (gqa, mla + 1)
    assert torch.equal(got, fp.flash_prefill_attention(q, k, v, impl="plain", **kw))


# (h, g, d) of the dense families: deepseek-coder-33b (rep 7), qwen3-8b /
# qwen3-32b (rep 8), gemma-7b (MHA: 16 groups of 256)
FAMILY_HEADS = [(56, 8, 128), (64, 8, 128), (16, 16, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [32, 77])
@pytest.mark.parametrize("h,g,d", FAMILY_HEADS)
def test_cuda_fresh_kernel_bit_identical_at_dense_family_heads(cuda, h, g, d, s, dtype):
    """Kernel 3's fresh form at the dense families' heads, ragged and empty
    slots: o, k_cast and v_cast equal to the plain version bit for bit."""
    b = 6
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(cuda, dt) for a in _qkv(h + s, b, s, h, g, d))
    valid = torch.tensor([s, s - 5, 0, s, 1, s], dtype=torch.int32, device=cuda)
    before = fp.KERNEL.launches
    got = fp.flash_prefill_attention(q, k, v, valid=valid, rope_theta=THETA)
    torch.cuda.synchronize()
    assert fp.KERNEL.launches == before + 1
    want = fp.flash_prefill_attention(q, k, v, valid=valid, rope_theta=THETA, impl="plain")
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["chunked", "paged chunked"])
@pytest.mark.parametrize("h,g,d", FAMILY_HEADS)
def test_cuda_chunk_kernels_bit_identical_at_dense_family_heads(cuda, h, g, d, form, dtype):
    """Kernel 3's chunked and paged chunked forms at the dense families'
    heads: C 32 at offsets 0-96 (hot 32 / cold 96, page size 32, shuffled
    table), valid 0 / 1 / 27 / 32; o, k_cast and v_cast equal to the plain
    version and, paged, to the contiguous chunked kernel bit for bit; one
    launch of the form's entry point."""
    lens = [0, 1, 31, 32, 33, 64, 80, 96]
    dt = getattr(torch, dtype)
    cont, paged = _card_pair(cuda, dt, 32, lens, g=g, d=d, seed=h + d)
    cache = _shuffle_pages(paged, h) if form == "paged chunked" else cont
    b, c = len(lens), 32
    gen = torch.Generator(device=cuda).manual_seed(h * d)
    q = torch.randn((b, c, h, d), generator=gen, device=cuda).to(dt)
    k, v = (torch.randn((b, c, g, d), generator=gen, device=cuda).to(dt) for _ in range(2))
    valid = torch.tensor([32, 1, 27, 0, 32, 5, 32, 32], dtype=torch.int32, device=cuda)
    kern = fp.CHUNK_PAGED_KERNEL if form == "paged chunked" else fp.CHUNK_KERNEL
    before = kern.launches
    got = fp.flash_prefill_attention(q, k, v, cache, valid, rope_theta=THETA)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = fp.flash_prefill_attention(q, k, v, cache, valid, rope_theta=THETA, impl="plain")
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    if form == "paged chunked":
        for x, z in zip(got, fp.flash_prefill_attention(q, k, v, cont, valid, rope_theta=THETA)):
            assert torch.equal(x, z)
