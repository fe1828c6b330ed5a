"""Port parity for fused-RoPE flash decode and the contiguous tiered KV
cache (repro_torch.kernels.flash_decode, core.kv_cache) against the
reference's ``_flash_gqa_fused`` Pallas kernel (interpret mode) and its
XLA path (rotate -> append -> tiered attention).

Cache writes are copies, so appends must match bit for bit. The attention
output is f32 arithmetic in another order (tiles and halving trees here,
the reference's blocks there) and RoPE's cos / sin differ by an ulp
between the frameworks, so outputs and the rotated k are held to
TOL = 2e-5 (the reference's own flash-decode tolerance). The CUDA kernel
runs only on a card: ``cuda``-marked tests hold it against the plain
version there, bit for bit, and skip here.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.core import kv_cache as kvc
from repro_torch.kernels import flash_decode as fd

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


@pytest.mark.parametrize("lens,hot,cold,active", [
    ([0, 1, 4, 5, 15], 4, 12, [False, True, True, True, True]),
    ([3, 9, 40, 70], 8, 64, [True, False, True, True]),
    ([2, 33, 34, 60], 32, 96, [True, True, True, True]),
])
def test_fused_decode_matches_pallas_and_xla(jref, lens, hot, cold, active):
    b, h, g, d = len(lens), 4, 2, 16
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
    cache, _ = _build([1], 2, 2)
    with pytest.raises(NotImplementedError):
        fd.flash_decode_attention(torch.zeros(1, 4, 16), cache)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_bit_identical_to_plain(cuda, dtype):
    lens = [0, 1, 31, 32, 33, 127]
    b, h, g, d = 6, 8, 4, 256
    cache, _ = _build(lens, 32, 96, g, d, seed=3)
    dt = getattr(torch, dtype)
    cache = kvc.TieredKVCache(*(t.to(cuda, dt) for t in cache[:4]), cache.lengths.to(cuda))
    rng = np.random.default_rng(4)
    q, kn, vn = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda, dt)
                 for s in ((b, h, d), (b, g, d), (b, g, d)))
    act = torch.tensor([False, True, True, True, True, True], device=cuda)
    kw = dict(k_new=kn, v_new=vn, active=act, rope_theta=THETA)
    before = fd.KERNEL.launches
    o, k_rot = fd.flash_decode_attention(q, cache, **kw)
    o_p, k_rot_p = fd.flash_decode_attention(q, cache, impl="plain", **kw)
    torch.cuda.synchronize()
    assert fd.KERNEL.launches == before + 1
    assert torch.equal(k_rot, k_rot_p) and torch.equal(o, o_p)
