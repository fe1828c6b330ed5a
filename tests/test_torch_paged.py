"""The paged cold tier and refcounted prefix sharing in the port against the
reference (``tests/test_paged.py``, case for case, at smoke size).

Three layers, as in the reference's tests:

* paging parity: the paged cache (``kv_cache.PagedKVCache``) and its
  appends hold the reference's pools, tables and lengths bit for bit, and
  ``as_tiered`` gives the contiguous cache's rows; the plain versions of
  the paged kernel forms (kernel 2's fused decode, kernel 6's post-append
  decode, kernel 3's chunked prefill) equal the contiguous forms bit for
  bit over identity and shuffled page tables, and the reference's Pallas
  kernels (interpret mode) to TOL = 2e-5 (f32 in another order, the
  reference's own tolerance); ``save_hot`` / ``paged_admit`` with a
  copy-on-write page equal the reference's bit for bit;
* the host control plane: the port's ``PagePool`` and ``PrefixCache`` give
  the reference's refcounts, matches and evictions on the same calls;
* serving end to end on falcon3-1b-smoke against the reference's engine,
  page size 8: shared prefixes, copy-on-write, paged against grouped
  admission and construction checks; tokens, ``prefix_tokens_reused`` and
  ledgers are exact.

The CUDA kernels run only on a card: the ``cuda`` tests hold each paged
form against its plain version and against the contiguous kernel on the
same content, bit for bit, and skip here.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.core import kv_cache as kvc
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import flash_prefill as fp
from repro_torch.models import transformer as T
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import Engine
from repro_torch.serving.paging import PagePool, PagePoolError, PrefixCache, pages_needed
from repro_torch.serving.scheduler import Request
from test_torch_threads import share_cpu_threads  # noqa: F401 (autouse: torch threads per worker)

TOL = dict(rtol=2e-5, atol=2e-5)
THETA = 1e4
NAME = "falcon3-1b"


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import bitlinear as jbitlinear
    from repro.core import kv_cache as jkvc
    from repro.kernels import flash_decode as jfd
    from repro.kernels import flash_prefill as jfp
    from repro.models import pack as jpack
    from repro.models import transformer as jT
    from repro.serving import engine as jengine
    from repro.serving import paging as jpaging
    from repro.serving import scheduler as jsched

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs, bitlinear=jbitlinear,
                                 kvc=jkvc, fd=jfd, fp=jfp, pack=jpack, T=jT, engine=jengine,
                                 paging=jpaging, sched=jsched)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _rows(seed, steps, b, g, d):
    """Per-step decode rows (k, v) from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, g, d)).astype(np.float32),
             rng.standard_normal((b, g, d)).astype(np.float32)) for _ in range(steps)]


def _build_pair(b, hot, cold, g, d, lens, ps=8, seed=0, n_pages=None, device="cpu",
                dtype=torch.float32):
    """Contiguous and paged caches filled with the same per-slot content by
    active-masked decode appends (mixed lengths), and the rows used."""
    cont = kvc.init_cache(b, hot, cold, (g, d), dtype, device=device)
    paged = kvc.init_paged_cache(b, hot, cold, (g, d), dtype, page_size=ps, n_pages=n_pages,
                                 device=device)
    rows = _rows(seed, max(lens), b, g, d)
    for t, (kn, vn) in enumerate(rows):
        act = torch.tensor([t < n for n in lens], device=device)
        k_, v_ = (torch.from_numpy(a).to(device, dtype) for a in (kn, vn))
        kvc.append_decode(cont, k_, v_, active=act)
        kvc.append_decode(paged, k_, v_, active=act)
    return cont, paged, rows


def _jpair(jref, b, hot, cold, g, d, lens, rows, ps=8, n_pages=None):
    """The reference's caches after the same appends."""
    jnp = jref.jnp
    cont = jref.kvc.init_cache(b, hot, cold, (g, d), jnp.float32)
    paged = jref.kvc.init_paged_cache(b, hot, cold, (g, d), jnp.float32, page_size=ps,
                                      n_pages=n_pages)
    for t, (kn, vn) in enumerate(rows):
        act = jnp.asarray([t < n for n in lens])
        cont = jref.kvc.append_decode(cont, jnp.asarray(kn), jnp.asarray(vn), active=act)
        paged = jref.kvc.append_decode(paged, jnp.asarray(kn), jnp.asarray(vn), active=act)
    return cont, paged


def _perm(n_pages, seed):
    return np.random.default_rng(seed).permutation(n_pages)


def _shuffle_pages(cache, seed=0):
    """The same logical content re-addressed through a random page
    permutation (a maximally non-identity table)."""
    perm = _perm(cache.n_pages, seed)
    inv = torch.as_tensor(np.argsort(perm))  # new_pool[perm[p]] = old_pool[p]
    table = torch.as_tensor(perm, dtype=torch.int32, device=cache.page_table.device)
    return cache._replace(pool_k=cache.pool_k[inv.to(cache.pool_k.device)].contiguous(),
                          pool_v=cache.pool_v[inv.to(cache.pool_v.device)].contiguous(),
                          page_table=table[cache.page_table.long()])


def _jshuffle(jref, cache, seed=0):
    perm = _perm(cache.n_pages, seed)
    inv = np.argsort(perm)
    jnp = jref.jnp
    return cache._replace(pool_k=jnp.asarray(np.asarray(cache.pool_k)[inv]),
                          pool_v=jnp.asarray(np.asarray(cache.pool_v)[inv]),
                          page_table=jnp.asarray(perm, jnp.int32)[cache.page_table])


def _assert_paged_equal(got, want):
    """Port and reference paged caches field by field, bit for bit."""
    for name in kvc.PagedKVCache._fields:
        np.testing.assert_array_equal(getattr(got, name).cpu().numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


def _prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (n,)).astype(np.int32)


# ---------------------------------------------------------------------------
# paging parity
# ---------------------------------------------------------------------------


def test_paged_append_and_as_tiered_match_contiguous(jref):
    """Decode appends into a paged cache: the reference's pool, table and
    lengths bit for bit, and ``as_tiered`` gives the contiguous cache's
    rows."""
    b, hot, cold, g, d = 3, 4, 24, 2, 8
    lens = [2, 9, 23]
    cont, paged, rows = _build_pair(b, hot, cold, g, d, lens)
    _, jpaged = _jpair(jref, b, hot, cold, g, d, lens, rows)
    _assert_paged_equal(paged, jpaged)
    tv = kvc.as_tiered(paged)
    assert torch.equal(tv.lengths, cont.lengths) and torch.equal(tv.hot_k, cont.hot_k)
    for s, n in enumerate(lens):
        nc = max(n - hot, 0)
        assert torch.equal(tv.cold_k[s, :nc], cont.cold_k[s, :nc])
        assert torch.equal(tv.cold_v[s, :nc], cont.cold_v[s, :nc])


def test_paged_bulk_append_valid_matches_contiguous(jref):
    """The bulk append with ``valid`` into a paged cache: the reference's
    cache bit for bit and the contiguous append's rows."""
    b, hot, cold, g, d, c = 2, 4, 16, 2, 8, 6
    lens = [3, 11]
    cont, paged, rows = _build_pair(b, hot, cold, g, d, lens)
    _, jpaged = _jpair(jref, b, hot, cold, g, d, lens, rows)
    rng = np.random.default_rng(7)
    kn, vn = (rng.standard_normal((b, c, g, d)).astype(np.float32) for _ in range(2))
    valid = np.asarray([4, 6], np.int32)
    kvc.append(cont, torch.from_numpy(kn), torch.from_numpy(vn), valid=torch.from_numpy(valid))
    kvc.append(paged, torch.from_numpy(kn), torch.from_numpy(vn), valid=torch.from_numpy(valid))
    jnp = jref.jnp
    jpaged = jref.kvc.append(jpaged, jnp.asarray(kn), jnp.asarray(vn), valid=jnp.asarray(valid))
    _assert_paged_equal(paged, jpaged)
    tv = kvc.as_tiered(paged)
    for s in range(b):
        n = int(cont.lengths[s])
        assert n == int(tv.lengths[s])
        assert torch.equal(tv.hot_k[s], cont.hot_k[s])
        assert torch.equal(tv.cold_k[s, : max(n - hot, 0)], cont.cold_k[s, : max(n - hot, 0)])


@pytest.mark.parametrize("shuffled", [False, True])
def test_flash_decode_paged_parity(jref, shuffled):
    """Post-append decode (kernel 6's form) over a paged cache: the plain
    version equals the contiguous one bit for bit, and the reference's
    Pallas kernel over the contiguous and the paged cache to TOL; the
    reference's XLA path agrees too."""
    b, hot, cold, g, d, rep = 3, 4, 24, 2, 16, 2
    lens = [2, 9, 23]
    cont, paged, rows = _build_pair(b, hot, cold, g, d, lens, n_pages=12)
    jcont, jpaged = _jpair(jref, b, hot, cold, g, d, lens, rows, n_pages=12)
    if shuffled:
        paged, jpaged = _shuffle_pages(paged, 3), _jshuffle(jref, jpaged, 3)
    q = np.random.default_rng(5).standard_normal((b, g * rep, d)).astype(np.float32)
    got = fd.flash_decode_attention(torch.from_numpy(q), paged)
    assert torch.equal(got, fd.flash_decode_attention(torch.from_numpy(q), cont))
    jq = jref.jnp.asarray(q)
    for jc in (jcont, jpaged):
        want = jref.fd.flash_decode_attention(jq, jc, impl="pallas", interpret=True, block_s=8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.fd.flash_decode_attention(jq, jpaged, impl="xla")), **TOL)


@pytest.mark.parametrize("shuffled", [False, True])
def test_flash_decode_fused_paged_parity(jref, shuffled):
    """Fused-RoPE decode (kernel 2's form, the pre-append cache): the plain
    paged version equals the contiguous one bit for bit (o and k_rot), the
    reference's paged Pallas kernel to TOL, its k_rot to 1e-6."""
    b, hot, cold, g, d, rep = 3, 4, 24, 2, 16, 2
    lens = [1, 7, 20]
    cont, paged, rows = _build_pair(b, hot, cold, g, d, lens, n_pages=12)
    _, jpaged = _jpair(jref, b, hot, cold, g, d, lens, rows, n_pages=12)
    if shuffled:
        paged, jpaged = _shuffle_pages(paged, 11), _jshuffle(jref, jpaged, 11)
    rng = np.random.default_rng(9)
    q = rng.standard_normal((b, g * rep, d)).astype(np.float32)
    kn, vn = (rng.standard_normal((b, g, d)).astype(np.float32) for _ in range(2))
    active = np.asarray([True, False, True])
    kw = dict(k_new=torch.from_numpy(kn), v_new=torch.from_numpy(vn),
              active=torch.from_numpy(active), rope_theta=THETA)
    o, k_rot = fd.flash_decode_attention(torch.from_numpy(q), paged, **kw)
    o_c, k_rot_c = fd.flash_decode_attention(torch.from_numpy(q), cont, **kw)
    assert torch.equal(o, o_c) and torch.equal(k_rot, k_rot_c)
    jnp = jref.jnp
    jo, jk = jref.fd.flash_decode_attention(
        jnp.asarray(q), jpaged, impl="pallas", interpret=True, block_s=8, k_new=jnp.asarray(kn),
        v_new=jnp.asarray(vn), active=jnp.asarray(active), rope_theta=THETA)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(k_rot.numpy(), np.asarray(jk), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shuffled", [False, True])
def test_flash_prefill_paged_parity(jref, shuffled):
    """Chunked prefill (kernel 3's chunked form) over a paged cache: the
    plain version equals the contiguous one bit for bit, the reference's
    paged Pallas kernel to TOL (o on valid rows, k_cast; v_cast exactly);
    appending the emitted rows through the paged bulk append gives the
    reference's paged cache."""
    b, hot, cold, g, d, rep, c = 3, 4, 24, 2, 16, 2, 6
    lens = [0, 5, 14]
    cont, paged, rows = _build_pair(b, hot, cold, g, d, lens, n_pages=11)
    _, jpaged = _jpair(jref, b, hot, cold, g, d, lens, rows, n_pages=11)
    if shuffled:
        paged, jpaged = _shuffle_pages(paged, 4), _jshuffle(jref, jpaged, 4)
    rng = np.random.default_rng(13)
    q = rng.standard_normal((b, c, g * rep, d)).astype(np.float32)
    kn, vn = (rng.standard_normal((b, c, g, d)).astype(np.float32) for _ in range(2))
    valid = np.asarray([6, 3, 5], np.int32)
    args = [torch.from_numpy(a) for a in (q, kn, vn)]
    got = fp.flash_prefill_attention(*args, paged, torch.from_numpy(valid), rope_theta=THETA)
    ref = fp.flash_prefill_attention(*args, cont, torch.from_numpy(valid), rope_theta=THETA)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    jnp = jref.jnp
    want = jref.fp.flash_prefill_attention(
        *(jnp.asarray(a) for a in (q, kn, vn)), jpaged, jnp.asarray(valid), rope_theta=THETA,
        impl="pallas", interpret=True, block_q=4, block_s=8)
    for i, n in enumerate(valid):
        np.testing.assert_allclose(got[0][i, :n].numpy(), np.asarray(want[0])[i, :n], **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    kvc.append(paged, got[1], got[2], valid=torch.from_numpy(valid))
    jpaged = jref.kvc.append(jpaged, want[1], want[2], valid=jnp.asarray(valid))
    np.testing.assert_array_equal(paged.lengths.numpy(), np.asarray(jpaged.lengths))
    np.testing.assert_allclose(paged.pool_k.numpy(), np.asarray(jpaged.pool_k), **TOL)
    np.testing.assert_array_equal(paged.pool_v.numpy(), np.asarray(jpaged.pool_v))


def test_chunk_attention_reference_reads_paged_through_as_tiered(jref):
    """``tiered_chunk_attention`` (the plain reference of the chunk read)
    takes a paged cache through ``as_tiered``: the contiguous result bit
    for bit, and the reference's to 1e-6."""
    b, hot, cold, g, d, rep, c = 2, 4, 16, 2, 8, 2, 5
    lens = [6, 13]
    cont, paged, rows = _build_pair(b, hot, cold, g, d, lens)
    _, jpaged = _jpair(jref, b, hot, cold, g, d, lens, rows)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, c, g * rep, d)).astype(np.float32)
    kn, vn = (rng.standard_normal((b, c, g, d)).astype(np.float32) for _ in range(2))
    valid = np.asarray([5, 2], np.int32)
    args = [torch.from_numpy(a) for a in (q, kn, vn)]
    got = kvc.tiered_chunk_attention(*args, paged, torch.from_numpy(valid))
    assert torch.equal(got, kvc.tiered_chunk_attention(*args, cont, torch.from_numpy(valid)))
    jnp = jref.jnp
    want = jref.kvc.tiered_chunk_attention(*(jnp.asarray(a) for a in (q, kn, vn)), jpaged,
                                           jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    qd = torch.from_numpy(q[:, 0])
    assert torch.equal(kvc.tiered_decode_attention(qd, paged), kvc.tiered_decode_attention(qd, cont))


def test_save_hot_paged_admit_roundtrip_with_cow(jref):
    """Snapshot slot 1's hot tier, then readmit slot 0 with the snapshot,
    slot 1's first cold page shared and a copy-on-write boundary page: the
    reference's cache bit for bit after each step; slot 0's rows [0, M)
    equal slot 1's, and slot 0's append into its copy leaves slot 1's page
    as it was."""
    b, hot, cold, g, d, ps = 2, 4, 16, 2, 8, 8
    lens = [0, 14]
    _, paged, rows = _build_pair(b, hot, cold, g, d, lens, ps=ps, n_pages=8)
    _, jpaged = _jpair(jref, b, hot, cold, g, d, lens, rows, ps=ps, n_pages=8)
    jnp = jref.jnp
    kvc.save_hot(paged, 1, torch.tensor([6], dtype=torch.int32))
    jpaged = jref.kvc.save_hot(jpaged, jnp.int32(1), jnp.asarray([6], jnp.int32))
    _assert_paged_equal(paged, jpaged)
    m = 13  # hot 4 + a full page of 8 + 1 boundary row
    args = (np.asarray([True, False]), np.asarray([m, 0], np.int32),
            np.asarray([[2, 5], [2, 3]], np.int32), np.asarray([[6], [-1]], np.int32),
            np.asarray([3, -1], np.int32), np.asarray([5, -1], np.int32))
    kvc.paged_admit(paged, *(torch.from_numpy(a) for a in args))
    jpaged = jref.kvc.paged_admit(jpaged, *(jnp.asarray(a) for a in args))
    _assert_paged_equal(paged, jpaged)
    assert int(paged.lengths[0]) == m
    tv = kvc.as_tiered(paged)
    assert torch.equal(tv.hot_k[0], tv.hot_k[1])
    assert torch.equal(tv.cold_k[0, : m - hot], tv.cold_k[1, : m - hot])
    before = paged.pool_k[3].clone()
    ones = torch.ones((b, g, d))
    kvc.append_decode(paged, ones, ones, active=torch.tensor([True, False]))
    jpaged = jref.kvc.append_decode(jpaged, jnp.ones((b, g, d)), jnp.ones((b, g, d)),
                                    active=jnp.asarray([True, False]))
    _assert_paged_equal(paged, jpaged)
    assert torch.equal(paged.pool_k[3], before)
    assert torch.equal(paged.pool_k[5, (m - hot) % ps], torch.ones((g, d)))


def test_paged_cache_init_matches_reference(jref):
    """``init_paged_cache``: the identity table clipped to the pool, zero
    tiers, the reference's shapes; the model's stacked paged cache per
    layer."""
    for n_pages in (None, 5):
        got = kvc.init_paged_cache(3, 4, 20, (2, 8), page_size=8, n_pages=n_pages)
        want = jref.kvc.init_paged_cache(3, 4, 20, (2, 8), jref.jnp.float32, page_size=8,
                                         n_pages=n_pages)
        _assert_paged_equal(got, want)
        assert (got.hot_cap, got.page_size, got.n_pages, got.pages_per_slot, got.cold_cap) == (
            want.hot_cap, want.page_size, want.n_pages, want.pages_per_slot, want.cold_cap)
    cfg = get_smoke_config(NAME)
    stack = T.init_decode_cache(cfg, 2, 40, 4, device="cpu", paged=True, page_size=8,
                                n_pages=9)["attn"]
    one = kvc.layer(stack, 1)
    assert isinstance(one, kvc.PagedKVCache)
    assert stack.pool_k.shape == (cfg.n_layers, 9, 8, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert (one.hot_cap, one.page_size, one.n_pages, one.pages_per_slot) == (4, 8, 9, 5)
    with pytest.raises(ValueError, match="cold tier"):
        kvc.init_paged_cache(1, 4, 0, (2, 8))


def test_default_page_size_is_one_key_tile():
    """The port's default page is one 32-key tile of its kernels (the
    reference reads its TPU kernel's block table, which does not carry
    over: a framework difference)."""
    assert engine_mod.DEFAULT_PAGE_SIZE == fd.TILE == 32
    cfg = get_smoke_config(NAME)
    params = T.init_params(cfg, seed=0, device="cpu")
    eng = Engine(cfg, params, hot_cap=4, max_len=100, prefill_chunk=4, paged=True, device="cpu")
    assert (eng._page_size, eng._pps, eng._n_hot_pages) == (32, 3, 1)
    assert eng._pool_pages(2) == 2 * 3 + 3 + 2 * 2 + 1


# ---------------------------------------------------------------------------
# host control plane: the port's PagePool / PrefixCache against the reference's
# ---------------------------------------------------------------------------


def test_pagepool_refcount_lifecycle(jref):
    """Refcounts never go negative; a page frees exactly when its last
    reader leaves; the reference's pool gives the same free list and
    counts after every call."""
    pools = (PagePool(4), jref.paging.PagePool(4))
    a = [p.alloc(2) for p in pools]
    assert a[0] == a[1] and len(a[0]) == 2
    for p in pools:
        assert p.available() == 2 and p.used() == 2
        p.incref(a[0])
        p.decref(a[0])
        assert p.available() == 2 and all(p.refs[i] == 1 for i in a[0])
        p.decref(a[0])
        assert p.available() == 4 and p.alloc(5) is None
    np.testing.assert_array_equal(pools[0].refs, pools[1].refs)
    assert pools[0]._free == pools[1]._free
    b = pools[0].alloc(1)
    pools[0].decref(b)
    with pytest.raises(PagePoolError, match="decref on free page"):
        pools[0].decref(b)
    with pytest.raises(PagePoolError, match="incref on free page"):
        pools[0].incref(b)
    try:
        pools[0].decref(b)
    except PagePoolError as e:
        assert e.page == b[0] and e.refcount == 0
    pools[0].quarantine(b[0])
    assert pools[0].available() == 3 and b[0] not in pools[0].alloc(3)


def _match_fields(m):
    return (m.length, tuple(m.hot_pages), tuple(m.shared_pages), m.cow_src, m.cow_len)


def test_prefix_cache_match_insert_roundtrip(jref):
    """Insert, full re-match capped at len - 1, an extended prompt, a
    divergence inside a run (copy-on-write boundary) and another hot
    prefix: every match equal to the reference tree's, and the same
    refcounts."""
    hc, ps = 4, 4
    trees = []
    for pool_cls, tree_cls in ((PagePool, PrefixCache),
                               (jref.paging.PagePool, jref.paging.PrefixCache)):
        pool = pool_cls(16)
        trees.append((pool, tree_cls(pool, hot_cap=hc, page_size=ps)))
    toks = np.arange(100, 115, dtype=np.int32)
    ext = np.concatenate([toks[:12], np.asarray([7, 8, 9, 10], np.int32)])
    div = toks.copy()
    div[10] = 999
    other = toks.copy()
    other[1] = 999
    results = []
    for pool, tree in trees:
        slot_pages = pool.alloc(3)
        saved = []
        out = [_match_fields(tree.match(toks)), tree.insert(toks, slot_pages, saved.extend),
               len(saved)]
        out += [_match_fields(tree.match(t)) for t in (toks, ext, div, other)]
        out.append(pool.refs.tolist())
        results.append(out)
    assert results[0] == results[1]
    got = results[0]
    pages = trees[0][0]
    assert got[3][0] == hc + 2 * ps and got[5][0] == hc + ps + 2 and got[5][4] == 2
    assert got[6][0] == 0 and pages.refs[got[3][2][0]] == 2


def test_prefix_cache_insert_dedup_keeps_one_copy(jref):
    """A second insert of the same prompt adopts nothing: the tree keeps its
    copy, as the reference's does."""
    outs = []
    for pool_cls, tree_cls in ((PagePool, PrefixCache),
                               (jref.paging.PagePool, jref.paging.PrefixCache)):
        pool = pool_cls(12)
        tree = tree_cls(pool, hot_cap=2, page_size=2)
        toks = np.asarray([1, 2, 3, 4, 5, 6], np.int32)
        first = pool.alloc(2)
        assert tree.insert(toks, first, lambda ids: None)
        second = pool.alloc(2)
        assert tree.insert(toks, second, lambda ids: None)
        assert all(pool.refs[p] == 2 for p in first) and all(pool.refs[p] == 1 for p in second)
        outs.append(pool.refs.tolist())
    assert outs[0] == outs[1]


def test_prefix_cache_eviction_is_leaf_only_lru_and_respects_readers(jref):
    """Eviction peels only childless nodes whose pages no slot reads, least
    recently used first; the same pages freed as in the reference."""
    outs = []
    for pool_cls, tree_cls in ((PagePool, PrefixCache),
                               (jref.paging.PagePool, jref.paging.PrefixCache)):
        pool = pool_cls(8)
        tree = tree_cls(pool, hot_cap=2, page_size=2)
        a = np.asarray([1, 2, 3, 4, 5, 6], np.int32)
        pa = pool.alloc(2)
        assert tree.insert(a, pa, lambda ids: None)
        b = np.asarray([9, 9, 7, 7], np.int32)
        pb = pool.alloc(1)
        assert tree.insert(b, pb, lambda ids: None)
        assert pool.available() == 3
        assert not tree.evict_for(8)  # live readers pin 3 pages
        pool.decref(pa)
        tree.match(b)  # a's chain is now the least recently used
        assert tree.evict_for(6) and pool.available() >= 6
        assert pool.refs[pb[0]] == 2
        outs.append((pool.refs.tolist(), sorted(pool._free), tree.tree_pages()))
    assert outs[0] == outs[1]


def test_prefix_cache_flush_and_evict_pages(jref):
    """``evict_pages`` drops the nodes holding a page and their subtrees,
    ``flush`` the whole tree: the same refcounts as the reference."""
    outs = []
    for pool_cls, tree_cls in ((PagePool, PrefixCache),
                               (jref.paging.PagePool, jref.paging.PrefixCache)):
        pool = pool_cls(10)
        tree = tree_cls(pool, hot_cap=2, page_size=2)
        pages = pool.alloc(3)
        tree.insert(np.arange(8, dtype=np.int32), pages, lambda ids: None)
        n1 = tree.evict_pages([pages[1]])
        refs1 = pool.refs.tolist()
        n2 = tree.flush()
        outs.append((n1, refs1, n2, pool.refs.tolist(), tree.tree_pages()))
    assert outs[0] == outs[1] and outs[0][0] == 2 and outs[0][-1] == []
    assert pages_needed(40, 4, 8) == 5 and pages_needed(3, 4, 8) == 0


# ---------------------------------------------------------------------------
# serving end to end against the reference's engine (falcon3-1b-smoke)
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


def _with_lora_b(jref, params, seed):
    """LoRA B factors (zero at init) filled, so the adapters count."""
    rng = np.random.default_rng(seed)

    def walk(t, name=""):
        if isinstance(t, dict):
            if name.startswith("lora_"):
                return {"a": t["a"], "b": jref.jnp.asarray(
                    rng.normal(0.0, 0.05, t["b"].shape).astype(np.float32))}
            return {k: walk(v, k) for k, v in t.items()}
        return t

    return walk(params)


@pytest.fixture(scope="module")
def models(jref):
    """falcon3-1b-smoke's packed parameters (LoRA B filled) in both
    packages."""
    jcfg = jref.configs.get_smoke_config(NAME)
    params = _with_lora_b(jref, jref.T.init_params(jref.jax.random.PRNGKey(0), jcfg), 0)
    jpacked = jref.pack.pack_params(params, jcfg)
    return types.SimpleNamespace(jcfg=jcfg, jpacked=jpacked, cfg=get_smoke_config(NAME),
                                 params=interop.params_from_reference(_numpy_tree(jref, jpacked)))


def _reqs(specs, cls=Request):
    return [cls(rid, toks, n) for rid, toks, n in specs]


def _shared_specs(vocab):
    shared = _prompt(1, 21, vocab)
    specs = [(i, np.concatenate([shared, _prompt(10 + i, 5, vocab)]), 6) for i in range(3)]
    return specs + [(3, _prompt(99, 7, vocab), 5)]  # unrelated


class RecordingPool(PagePool):
    """A pool that records each page's peak reader count."""

    def __init__(self, n_pages):
        super().__init__(n_pages)
        self.peak = np.zeros(n_pages, np.int32)

    def alloc(self, n):
        pages = super().alloc(n)
        for p in pages or ():
            self.peak[p] = max(self.peak[p], 1)
        return pages

    def incref(self, pages):
        super().incref(pages)
        for p in pages:
            self.peak[p] = max(self.peak[p], self.refs[p])


def test_paged_serving_shared_prefix_end_to_end(jref, models, monkeypatch):
    """Three requests sharing a 21-token prefix and one unrelated, one slot,
    page size 8: the reference engine's tokens, ``prefix_tokens_reused``
    and ledgers; the prefix stored once (peak refcount 2 on tree pages,
    every other page free at the end); unshared paged and contiguous
    chunked runs give the same tokens, and the unshared ledger minus the
    shared one is the skipped prompt work, per request and traffic key."""
    m = models
    monkeypatch.setattr(engine_mod, "PagePool", RecordingPool)
    kw = dict(hot_cap=4, max_len=64, prefill_chunk=4, slots=1)
    specs = _shared_specs(m.cfg.vocab_size)
    eng = Engine(m.cfg, m.params, paged=True, page_size=8, device="cpu", **kw)
    fin = {f.rid: f for f in eng.serve(_reqs(specs), slots=1, sync_every=3)}
    jeng = jref.engine.Engine(m.jcfg, m.jpacked, paged=True, page_size=8, **kw)
    want = {f.rid: f for f in jeng.serve(_reqs(specs, jref.sched.Request), slots=1,
                                         sync_every=3)}
    assert set(fin) == {0, 1, 2, 3}
    for rid, f in fin.items():
        np.testing.assert_array_equal(f.tokens, want[rid].tokens)
        assert (f.prefix_tokens_reused, f.traffic, f.seq_len) == (
            want[rid].prefix_tokens_reused, want[rid].traffic, want[rid].seq_len)
    assert [fin[i].prefix_tokens_reused for i in range(4)] == [0, 20, 20, 0]
    pool, tree = eng._last_pool, eng._last_ptree
    tree_pages = set(tree.tree_pages())
    assert any(pool.peak[p] >= 2 for p in tree_pages)
    for p in range(pool.n_pages):
        assert pool.refs[p] == (1 if p in tree_pages else 0)
    assert pool.available() == pool.n_pages - len(tree_pages)
    assert eng.weight_loads == 0 and eng.chunk_shapes == {(1, 4)}
    eng_n = Engine(m.cfg, m.params, paged=True, page_size=8, prefix_sharing=False,
                   device="cpu", **kw)
    fin_n = {f.rid: f for f in eng_n.serve(_reqs(specs), slots=1, sync_every=3)}
    eng_c = Engine(m.cfg, m.params, device="cpu", **kw)
    fin_c = {f.rid: f for f in eng_c.serve(_reqs(specs), slots=1, sync_every=3)}
    tb = eng._kv_token_bytes()
    for rid, toks, _ in specs:
        np.testing.assert_array_equal(fin[rid].tokens, fin_n[rid].tokens)
        np.testing.assert_array_equal(fin[rid].tokens, fin_c[rid].tokens)
        assert fin_n[rid].prefix_tokens_reused == 0 and fin_n[rid].traffic == fin_c[rid].traffic
        reused = fin[rid].prefix_tokens_reused
        full = kvc.prompt_traffic_tokens(len(toks), 4)
        resumed = kvc.prompt_traffic_tokens_resumed(len(toks), reused, 4)
        for k in kvc.TRAFFIC_KEYS:
            assert fin_n[rid].traffic[k] - fin[rid].traffic[k] == (full[k] - resumed[k]) * tb


def test_paged_serving_cow_divergent_prompts(jref, models):
    """Two prompts that part inside a cold page: the second adopts the
    boundary page copy-on-write (reuse hot 4 + page 8 + 3 rows), decodes
    the reference engine's tokens, and each equals its solo serve."""
    m = models
    base = _prompt(2, 26, m.cfg.vocab_size)
    div = base.copy()
    div[15] = (int(div[15]) + 1) % m.cfg.vocab_size
    specs = [(0, base, 6), (1, div, 6)]
    kw = dict(hot_cap=4, max_len=64, prefill_chunk=4, paged=True, page_size=8, slots=1)
    eng = Engine(m.cfg, m.params, device="cpu", **kw)
    fin = {f.rid: f for f in eng.serve(_reqs(specs), slots=1)}
    want = {f.rid: f for f in jref.engine.Engine(m.jcfg, m.jpacked, **kw).serve(
        _reqs(specs, jref.sched.Request), slots=1)}
    assert fin[0].prefix_tokens_reused == 0 and fin[1].prefix_tokens_reused == 4 + 8 + 3
    for rid, toks, n in specs:
        np.testing.assert_array_equal(fin[rid].tokens, want[rid].tokens)
        assert fin[rid].traffic == want[rid].traffic
        solo = eng.serve([Request(9, toks, n)], slots=1)[0]
        np.testing.assert_array_equal(fin[rid].tokens, solo.tokens)


def test_paged_matches_grouped_admission_tokens(jref, models):
    """Paged chunked serving (two slots, default pool) gives the grouped
    engine's tokens, and the reference paged engine's tokens and ledgers;
    the pool ends with only the tree's pages held."""
    m = models
    v = m.cfg.vocab_size
    specs = [(0, _prompt(40, 5, v), 9), (1, _prompt(41, 12, v), 3), (2, _prompt(42, 1, v), 5)]
    kw = dict(hot_cap=4, max_len=64)
    fin_p = {f.rid: f for f in Engine(m.cfg, m.params, prefill_chunk=4, paged=True, page_size=8,
                                      device="cpu", **kw).serve(_reqs(specs), slots=2,
                                                                sync_every=3)}
    fin_g = {f.rid: f for f in Engine(m.cfg, m.params, device="cpu", **kw).serve(
        _reqs(specs), slots=2, sync_every=3)}
    want = {f.rid: f for f in jref.engine.Engine(
        m.jcfg, m.jpacked, prefill_chunk=4, paged=True, page_size=8, **kw).serve(
        _reqs(specs, jref.sched.Request), slots=2, sync_every=3)}
    for rid, _, n in specs:
        np.testing.assert_array_equal(fin_p[rid].tokens, fin_g[rid].tokens)
        np.testing.assert_array_equal(fin_p[rid].tokens, want[rid].tokens)
        assert fin_p[rid].traffic == want[rid].traffic and len(fin_p[rid].tokens) == n


def test_paged_decode_grows_pages_mid_run(jref, models):
    """A request whose decode crosses several page boundaries (prompt 6,
    40 new tokens, page size 8) gets its pages chunk by chunk and gives
    the reference paged engine's and the contiguous engine's tokens."""
    m = models
    specs = [(0, _prompt(7, 6, m.cfg.vocab_size), 40)]
    kw = dict(hot_cap=4, max_len=64, prefill_chunk=4)
    eng = Engine(m.cfg, m.params, paged=True, page_size=8, device="cpu", **kw)
    got = eng.serve(_reqs(specs), slots=1, sync_every=5)[0]
    want = jref.engine.Engine(m.jcfg, m.jpacked, paged=True, page_size=8, **kw).serve(
        _reqs(specs, jref.sched.Request), slots=1, sync_every=5)[0]
    cont = Engine(m.cfg, m.params, device="cpu", **kw).serve(_reqs(specs), slots=1,
                                                             sync_every=5)[0]
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.tokens, cont.tokens)
    assert got.traffic == want.traffic == cont.traffic and got.seq_len == 46
    assert eng._last_pool.available() == eng._last_pool.n_pages - len(eng._last_ptree.tree_pages())


def test_paged_engine_validates_construction(models):
    """Paging needs chunked admission and a cold tier (the reference's
    ValueErrors); MLA cannot page; a request whose peak page set exceeds
    the pool is refused up front; an empty prompt too."""
    m = models
    with pytest.raises(ValueError, match="chunked prefill"):
        Engine(m.cfg, m.params, hot_cap=4, max_len=64, paged=True, device="cpu")
    with pytest.raises(ValueError, match="cold tier"):
        Engine(m.cfg, m.params, hot_cap=64, max_len=64, prefill_chunk=4, paged=True,
               device="cpu")
    mla = get_smoke_config("deepseek-v3-671b")
    with pytest.raises(ValueError, match="full-attention"):
        Engine(mla, T.init_params(mla, seed=0, device="cpu"), hot_cap=4, max_len=64,
               prefill_chunk=4, paged=True, device="cpu")
    eng = Engine(m.cfg, m.params, hot_cap=4, max_len=64, prefill_chunk=4, paged=True,
                 page_size=8, n_pages=2, device="cpu")
    with pytest.raises(ValueError, match="cold pages"):
        eng.serve([Request(0, _prompt(1, 20, m.cfg.vocab_size), 10)], slots=1)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.serve([Request(0, np.zeros((0,), np.int32), 4)], slots=1)


def test_page_pool_exhaustion_raises_where_the_reference_preempts(jref, models):
    """A pool that fits each request alone but not both at once: where the
    port raised, it now degrades as the reference does (overload control,
    ``serving/engine.py``): the fill the pool cannot fund goes back to the
    queue and is admitted once the first request's pages return. Both
    requests finish with the reference engine's tokens, counters and
    ledgers, and the pool ends with only the tree's pages held."""
    m = models
    v = m.cfg.vocab_size
    kw = dict(hot_cap=4, max_len=64, prefill_chunk=4, paged=True, page_size=8, n_pages=5)
    specs = [(0, _prompt(1, 30, v), 4), (1, _prompt(2, 30, v), 4)]
    eng = Engine(m.cfg, m.params, device="cpu", **kw)
    fin = {f.rid: f for f in eng.serve(_reqs(specs), slots=2)}
    jeng = jref.engine.Engine(m.jcfg, m.jpacked, **kw)
    want = {f.rid: f for f in jeng.serve(_reqs(specs, jref.sched.Request), slots=2)}
    for k in ("preemptions", "recompute_tokens", "grown_pages", "iterations"):
        assert getattr(eng.last_stats, k) == getattr(jeng.last_stats, k)
    for rid, _, n in specs:
        f, w = fin[rid], want[rid]
        np.testing.assert_array_equal(f.tokens, w.tokens)
        assert (f.outcome, f.n_preemptions, f.traffic, f.prefix_tokens_reused) == (
            w.outcome, w.n_preemptions, w.traffic, w.prefix_tokens_reused)
        assert f.outcome == "finished" and len(f.tokens) == n
    assert eng._last_pool.available() == eng._last_pool.n_pages - len(
        eng._last_ptree.tree_pages())


# ---------------------------------------------------------------------------
# the CUDA kernels' paged forms (card only)
# ---------------------------------------------------------------------------

LENGTHS = [0, 1, 31, 32, 33, 80, 127, 128]


def _card_pair(cuda, dtype, ps, lens, hot=32, cold=96, g=4, d=256, seed=0):
    """Contiguous and paged caches of the same content on the card, rows
    past each length NaN in both (no form may read them), the paged pool
    with one spare page."""
    b = len(lens)
    rng = np.random.default_rng(seed)
    tiers = [rng.standard_normal((b, cap, g, d)).astype(np.float32)
             for cap in (hot, hot, cold, cold)]
    L = np.asarray(lens, np.int32)
    for t, cap, off in zip(tiers, (hot, hot, cold, cold), (0, 0, hot, hot)):
        t[np.arange(cap)[None] >= np.clip(L - off, 0, cap)[:, None]] = np.nan
    cont = kvc.TieredKVCache(*(torch.from_numpy(t).to(cuda, dtype) for t in tiers),
                             torch.from_numpy(L).to(cuda))
    pps = -(-cold // ps)
    paged = kvc.init_paged_cache(b, hot, cold, (g, d), dtype, page_size=ps,
                                 n_pages=b * pps + 1, device=cuda)
    paged.hot_k.copy_(cont.hot_k)
    paged.hot_v.copy_(cont.hot_v)
    pad = pps * ps - cold
    for src, pool in ((cont.cold_k, paged.pool_k), (cont.cold_v, paged.pool_v)):
        full = torch.nn.functional.pad(src, (0, 0, 0, 0, 0, pad), value=float("nan"))
        pool[: b * pps].copy_(full.reshape(b * pps, ps, g, d))
    paged.lengths.copy_(cont.lengths)
    return cont, paged


def _forms(cuda, dtype, ps, shuffled):
    cont, paged = _card_pair(cuda, getattr(torch, dtype), ps, LENGTHS)
    return cont, (_shuffle_pages(paged, ps) if shuffled else paged)


@pytest.mark.cuda
@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("ps", [32, 16, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_fused_decode_bit_identical(cuda, dtype, ps, shuffled):
    """A1b (kernel 2's paged form) at falcon3-1b's heads (h 8, g 4, d 256),
    hot 32 / cold 96 at lengths 0-128, page size 32, 16 or 48, identity and
    shuffled tables: o and k_rot equal the plain version and the
    contiguous kernel bit for bit; one launch of the paged entry point."""
    cont, paged = _forms(cuda, dtype, ps, shuffled)
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(ps)
    b = len(LENGTHS)
    q = torch.randn((b, 8, 256), generator=gen, device=cuda).to(dt)
    kn, vn = (torch.randn((b, 4, 256), generator=gen, device=cuda).to(dt) for _ in range(2))
    active = torch.tensor([True] * (b - 1) + [False], device=cuda)
    kw = dict(k_new=kn, v_new=vn, active=active, rope_theta=THETA)
    before = (fd.PAGED_KERNEL.launches, fd.KERNEL.launches)
    o, k_rot = fd.flash_decode_attention(q, paged, **kw)
    assert (fd.PAGED_KERNEL.launches, fd.KERNEL.launches) == (before[0] + 1, before[1])
    o_p, k_p = fd.flash_decode_attention(q, paged, impl="plain", **kw)
    o_c, k_c = fd.flash_decode_attention(q, cont, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o_p) and torch.equal(k_rot, k_p)
    assert torch.equal(o, o_c) and torch.equal(k_rot, k_c)


@pytest.mark.cuda
@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("ps", [32, 16, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_post_append_decode_bit_identical(cuda, dtype, ps, shuffled):
    """A2a (kernel 6's paged form): as above, post-append (no pending
    token); a length-0 slot gives zeros."""
    cont, paged = _forms(cuda, dtype, ps, shuffled)
    q = torch.randn((len(LENGTHS), 8, 256), generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda).to(getattr(torch, dtype))
    before = (fd.GQA_PAGED_KERNEL.launches, fd.GQA_KERNEL.launches)
    o = fd.flash_decode_attention(q, paged)
    assert (fd.GQA_PAGED_KERNEL.launches, fd.GQA_KERNEL.launches) == (before[0] + 1, before[1])
    want = fd.flash_decode_attention(q, paged, impl="plain")
    o_c = fd.flash_decode_attention(q, cont)
    torch.cuda.synchronize()
    assert torch.equal(o, want) and torch.equal(o, o_c) and not o[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("ps", [32, 16, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_paged_chunk_prefill_bit_identical(cuda, dtype, ps, shuffled):
    """A3b (kernel 3's paged chunked form): C 32 at offsets 0-96 (lengths
    capped so the chunk fits), valid 0 / 1 / 27 / 32: o, k_cast and v_cast
    equal the plain version and the contiguous chunked kernel bit for
    bit; one launch of the paged entry point."""
    lens = [0, 1, 31, 32, 33, 64, 80, 96]
    dt = getattr(torch, dtype)
    cont, paged = _card_pair(cuda, dt, ps, lens)
    if shuffled:
        paged = _shuffle_pages(paged, ps)
    b, c = len(lens), 32
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((b, c, 8, 256), generator=gen, device=cuda).to(dt)
    k, v = (torch.randn((b, c, 4, 256), generator=gen, device=cuda).to(dt) for _ in range(2))
    valid = torch.tensor([32, 1, 27, 0, 32, 5, 32, 32], dtype=torch.int32, device=cuda)
    before = (fp.CHUNK_PAGED_KERNEL.launches, fp.CHUNK_KERNEL.launches)
    got = fp.flash_prefill_attention(q, k, v, paged, valid, rope_theta=THETA)
    assert (fp.CHUNK_PAGED_KERNEL.launches, fp.CHUNK_KERNEL.launches) == (before[0] + 1,
                                                                          before[1])
    want = fp.flash_prefill_attention(q, k, v, paged, valid, rope_theta=THETA, impl="plain")
    cont_out = fp.flash_prefill_attention(q, k, v, cont, valid, rope_theta=THETA)
    torch.cuda.synchronize()
    for x, y, z in zip(got, want, cont_out):
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.cuda
def test_cuda_paged_engine_matches_plain_run(cuda):
    """falcon3-1b-smoke served paged with prefix sharing on the card: the
    paged chunk and decode forms launch (the contiguous ones never) and the
    tokens, reuse counts and ledgers equal the plain paged run's and the
    contiguous chunked run's tokens."""
    cfg = get_smoke_config(NAME)
    params = T.init_params(cfg, seed=0, device="cuda")
    specs = _shared_specs(cfg.vocab_size)
    kw = dict(hot_cap=4, max_len=64, prefill_chunk=4, paged=True, page_size=8, slots=2)
    counters = (fp.CHUNK_KERNEL, fp.CHUNK_PAGED_KERNEL, fd.KERNEL, fd.PAGED_KERNEL)
    before = [k.launches for k in counters]
    got = {f.rid: f for f in Engine(cfg, params, **kw).serve(_reqs(specs), sync_every=3)}
    after = [k.launches - n for k, n in zip(counters, before)]
    assert after[0] == 0 and after[2] == 0 and after[1] > 0 and after[3] > 0, after
    plain = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, impl="plain"))
    want = {f.rid: f for f in Engine(plain, params, **kw).serve(_reqs(specs), sync_every=3)}
    cont = {f.rid: f for f in Engine(cfg, params, hot_cap=4, max_len=64, prefill_chunk=4,
                                     slots=2).serve(_reqs(specs), sync_every=3)}
    for rid, f in got.items():
        np.testing.assert_array_equal(f.tokens, want[rid].tokens)
        np.testing.assert_array_equal(f.tokens, cont[rid].tokens)
        assert (f.traffic, f.prefix_tokens_reused) == (want[rid].traffic,
                                                       want[rid].prefix_tokens_reused)
