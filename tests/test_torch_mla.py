"""Port parity for MLA attention (repro_torch.models.attention mla_*, the
latent flash-decode kernel's plain version, the flash-prefill kernel's MLA
form and the latent cache) against the reference: its XLA paths and its
Pallas kernels in interpret mode.

Integer and copy stages are bit-exact: cache appends and fills, and the
fake-quantized factors, which are carried across as the reference
computed them (``weight_quant_ste`` of ``w_uk`` / ``w_uv``), never
re-quantized. Attention outputs are f32 arithmetic in another order (tiles
and halving trees here, the reference's blocks there) and RoPE's cos / sin
differ by an ulp between the frameworks: TOL = 2e-5, the reference's own
flash-decode tolerance. Whole-layer outputs go through f32 matmuls in
another order and are held to LAYER_TOL = 1e-4. The CUDA kernels run only
on a card: ``cuda``-marked tests hold them against their plain versions
there, bit for bit, and skip here.
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
from repro_torch.models import attention as attn

TOL = dict(rtol=2e-5, atol=2e-5)
LAYER_TOL = dict(rtol=1e-4, atol=1e-4)
THETA = 10_000.0
NAME = "deepseek-v3-671b"


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
    from repro.models import attention as jattn
    from repro.models import pack as jpack

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs, bitlinear=jbitlinear,
                                 kvc=jkvc, ternary=jternary, fd=jfd, fp=jfp, attn=jattn,
                                 pack=jpack)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def numpy_tree(jref, tree):
    """Reference tree -> numpy for ``interop``: packed leaves as field
    dicts, ``w_uk`` / ``w_uv`` as their fake-quantized values ``{"fq"}``
    (computed by the reference, per layer when stacked)."""
    if isinstance(tree, (jref.bitlinear.PackedLinear, jref.bitlinear.FusedPackedLinear)):
        out = dict(packed=np.asarray(tree.packed), scale=np.asarray(tree.scale),
                   k=tree.k, codec=tree.codec)
        if isinstance(tree, jref.bitlinear.FusedPackedLinear):
            out["splits"] = tree.splits
        return out
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in ("w_uk", "w_uv"):
                w = v["w"]
                fq = (jref.jax.vmap(jref.ternary.weight_quant_ste)(w) if w.ndim == 3
                      else jref.ternary.weight_quant_ste(w))
                out[k] = {"fq": np.asarray(fq)}
            else:
                out[k] = numpy_tree(jref, v)
        return out
    return np.asarray(tree)


def _latent_cache(lens, hot, cold, d, seed=0):
    """An empty port latent cache (empty v-slot) and the rows that
    ``_fill`` appends to it."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    rows = rng.standard_normal((b, max(max(lens), 1), d)).astype(np.float32)
    cache = kvc.init_cache(b, hot, cold, (d,), v_shape=(0,))
    return cache, rows


def _fill(cache, rows, lens):
    """Decode appends, active-masked per slot, as serving fills a cache."""
    for t in range(rows.shape[1]):
        act = torch.tensor([t < n for n in lens])
        kvc.append_decode(cache, torch.from_numpy(rows[:, t]), torch.zeros((len(lens), 0)),
                          active=act)
    return cache


def _jcache(jref, cache):
    return jref.kvc.TieredKVCache(*(jref.jnp.asarray(t.numpy()) for t in cache))


@pytest.mark.parametrize("lens,hot,cold", [
    ([0, 1, 4, 5, 16], 4, 12),  # empty slot, hot edge, first cold row, full
    ([3, 40, 70], 32, 96),  # multi-tile cold tier, serving layout
])
def test_latent_append_bit_identical(jref, lens, hot, cold):
    d = 24
    cache, rows = _latent_cache(lens, hot, cold, d)
    _fill(cache, rows, lens)
    jc = jref.kvc.init_cache(len(lens), hot, cold, (d,), jref.jnp.float32)
    jc = jc._replace(hot_v=jref.jnp.zeros((len(lens), hot, 0)),
                     cold_v=jref.jnp.zeros((len(lens), cold, 0)))
    for t in range(rows.shape[1]):
        act = np.asarray([t < n for n in lens])
        jc = jref.kvc.append_decode(jc, jref.jnp.asarray(rows[:, t]),
                                    jref.jnp.zeros((len(lens), 0)), active=jref.jnp.asarray(act))
    for got, want in zip(cache, jc):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (cache.hot_cap, cache.cold_cap) == (hot, cold)


@pytest.mark.parametrize("lens,hot,cold,d,dv", [
    ([0, 1, 4, 5, 16], 4, 12, 24, 16),
    ([3, 33, 70, 96], 32, 96, 24, 16),
    ([1, 40, 80], 32, 96, 576, 512),  # DeepSeek-V3's row and value widths
])
def test_latent_decode_matches_reference(jref, lens, hot, cold, d, dv):
    """The plain kernel version and the plain tiered reader against the
    reference's XLA reader and its ``_flash_latent`` kernel (interpret)."""
    h = 4
    cache, rows = _latent_cache(lens, hot, cold, d, seed=1)
    _fill(cache, rows, lens)
    q = np.random.default_rng(2).standard_normal((len(lens), h, d)).astype(np.float32)
    scale = 24 ** -0.5
    jc = _jcache(jref, cache)
    want_xla = np.asarray(jref.fd.flash_decode_attention_latent(
        jref.jnp.asarray(q), jc, value_dim=dv, scale=scale, impl="xla"))
    want_pallas = np.asarray(jref.fd.flash_decode_attention_latent(
        jref.jnp.asarray(q), jc, value_dim=dv, scale=scale, impl="pallas", interpret=True))
    got = fd.flash_decode_attention_latent(torch.from_numpy(q), cache, dv, scale)
    reader = kvc.tiered_decode_attention_latent(torch.from_numpy(q), cache, dv, scale)
    assert got.dtype == torch.float32 and got.shape == (len(lens), h, dv)
    for out in (got, reader):
        np.testing.assert_allclose(out.numpy(), want_xla, **TOL)
        np.testing.assert_allclose(out.numpy(), want_pallas, **TOL)
    assert not got[np.asarray(lens) == 0].any()  # a length-0 slot returns zeros


def test_latent_plain_never_reads_masked_rows():
    lens = [2, 35]
    cache, rows = _latent_cache(lens, 32, 96, 24, seed=3)
    _fill(cache, rows, lens)
    q = torch.randn((2, 4, 24), generator=torch.Generator().manual_seed(0))
    want = fd.flash_decode_attention_latent(q, cache, 16, 0.2)
    hot_valid, cold_valid = kvc.valid_masks(cache)
    poisoned = cache._replace(hot_k=torch.where(hot_valid[..., None], cache.hot_k, float("nan")),
                              cold_k=torch.where(cold_valid[..., None], cache.cold_k,
                                                 float("nan")))
    assert torch.equal(fd.flash_decode_attention_latent(q, poisoned, 16, 0.2), want)


def _mla_qkv(seed, b, s, h, dk, dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, dk)).astype(np.float32),
            rng.standard_normal((b, s, h, dk)).astype(np.float32),
            rng.standard_normal((b, s, h, dv)).astype(np.float32))


@pytest.mark.parametrize("s,valid", [(8, None), (40, [40, 33]), (77, [5, 77])])
def test_mla_prefill_form_matches_reference(jref, s, valid):
    """rope_dims < head, emit_kv=False, dv != dk, g == h."""
    b, h, dk, dv, rd = 2, 3, 24, 16, 8
    q, k, v = _mla_qkv(s, b, s, h, dk, dv)
    val = None if valid is None else np.asarray(valid, np.int32)
    kw = dict(rope_theta=THETA, rope_dims=rd, emit_kv=False)
    jargs = [jref.jnp.asarray(a) for a in (q, k, v)]
    jval = None if val is None else jref.jnp.asarray(val)
    want_xla = np.asarray(jref.fp.flash_prefill_attention(*jargs, None, jval, impl="xla", **kw))
    want_pallas = np.asarray(jref.fp.flash_prefill_attention(
        *jargs, None, jval, impl="pallas", interpret=True, **kw))
    got = fp.flash_prefill_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                     valid=None if val is None else torch.from_numpy(val), **kw)
    assert got.shape == (b, s, h, dv)
    rows = np.arange(s)[None] < (np.full(b, s) if val is None else val)[:, None]
    for want in (want_xla, want_pallas):  # rows past valid are padding
        np.testing.assert_allclose(got.numpy()[rows], want[rows], **TOL)


def test_mla_prefill_form_checks():
    q, k, v = (torch.from_numpy(a) for a in _mla_qkv(0, 1, 4, 2, 24, 16))
    with pytest.raises(NotImplementedError):  # rope_dims < head needs emit_kv=False
        fp.flash_prefill_attention(q, k, v, rope_dims=8)
    out = fp.flash_prefill_attention(q, k, v, rope_dims=8, emit_kv=False)
    assert isinstance(out, torch.Tensor) and out.shape == (1, 4, 2, 16)


def _layer(jref, seed=0):
    """One MLA layer of the smoke config: the reference's packed params and
    the port's carried copy."""
    jcfg = jref.configs.get_smoke_config(NAME)
    jp = jref.attn.init_mla(jref.jax.random.PRNGKey(seed), jcfg)
    jpacked = jref.pack.pack_params({"attn": jp}, jcfg)["attn"]
    return jcfg, get_smoke_config(NAME), jpacked, interop.from_reference(
        numpy_tree(jref, jpacked))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mla_prefill_and_decode_match_reference(jref, impl):
    """A layer's prefill (output and latent cache fill), then two decode
    steps with an inactive slot, against the reference's XLA path and
    its Pallas path (kernels in interpret mode)."""
    jcfg, cfg, jp, tp = _layer(jref, seed=1)
    jcfg = dataclasses.replace(jcfg, bitnet=dataclasses.replace(jcfg.bitnet, impl=impl))
    b, s, hot, cold = 3, 6, 4, 12
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    jc = jref.kvc.init_cache(b, hot, cold, (cfg.mla.kv_cache_dim,), jref.jnp.float32)
    jc = jc._replace(hot_v=jref.jnp.zeros((b, hot, 0)), cold_v=jref.jnp.zeros((b, cold, 0)))
    jy, jc = jref.attn.mla_prefill(jp, jref.jnp.asarray(x), jcfg, "packed", jc)
    cache = kvc.init_cache(b, hot, cold, (cfg.mla.kv_cache_dim,), v_shape=(0,))
    ty, _ = attn.mla_prefill(tp, torch.from_numpy(x), cfg, cache)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
    for got, want in zip(cache, jc):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    active = np.asarray([True, False, True])
    for step in range(2):
        xd = rng.standard_normal((b, cfg.d_model)).astype(np.float32)
        jy, jc = jref.attn.mla_decode(jp, jref.jnp.asarray(xd), jcfg, "packed", jc,
                                      active=jref.jnp.asarray(active))
        ty, _ = attn.mla_decode(tp, torch.from_numpy(xd), cfg, cache,
                                active=torch.from_numpy(active))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
        np.testing.assert_array_equal(cache.lengths.numpy(), np.asarray(jc.lengths))
        for got, want in zip(cache, jc):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fake_quantized_factors_match_reference(jref):
    """``pack_params`` turns w_uk / w_uv into the forward value of the
    reference's weight_quant_ste (trits x absmean). The absmean may sit a
    few ulps off the reference's (another summation order; 4 measured on
    these shapes, bound 8), so the
    values differ by that much and a trit may flip at the rounding
    boundary: no more than one trit in a thousand differs. That is why the
    parity tests carry the reference's own values."""
    from repro_torch.models.pack import pack_params

    jcfg = jref.configs.get_smoke_config(NAME)
    jp = jref.attn.init_mla(jref.jax.random.PRNGKey(4), jcfg)
    floats = interop.from_reference(jref.jax.tree.map(np.asarray, jp))
    tp = pack_params({"attn": floats}, get_smoke_config(NAME))["attn"]
    for name in ("w_uk", "w_uv"):
        want = np.asarray(jref.ternary.weight_quant_ste(jp[name]["w"]))
        got = tp[name]["fq"].numpy()
        s_got, s_want = np.abs(got).max(), np.abs(want).max()
        assert got.shape == want.shape
        assert abs(s_got - s_want) <= 8 * np.spacing(s_want)
        assert np.mean(np.sign(got) != np.sign(want)) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,dv", [(24, 16), (576, 512)])
def test_cuda_latent_kernel_bit_identical_to_plain(cuda, dtype, d, dv):
    lens = [0, 1, 31, 32, 33, 128]
    hot, cold, h = 32, 96, 128 if d == 576 else 4
    g = torch.Generator(device=cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    cache = kvc.init_cache(6, hot, cold, (d,), dtype=dt, device=cuda, v_shape=(0,))
    cache = cache._replace(
        hot_k=torch.randn(cache.hot_k.shape, generator=g, device=cuda).to(dt),
        cold_k=torch.randn(cache.cold_k.shape, generator=g, device=cuda).to(dt),
        lengths=torch.tensor(lens, dtype=torch.int32, device=cuda))
    hot_valid, cold_valid = kvc.valid_masks(cache)
    cache = cache._replace(  # masked rows hold NaN: neither version may read them
        hot_k=torch.where(hot_valid[..., None], cache.hot_k, float("nan")).to(dt),
        cold_k=torch.where(cold_valid[..., None], cache.cold_k, float("nan")).to(dt))
    q = torch.randn((6, h, d), generator=g, device=cuda)
    before = fd.LATENT_KERNEL.launches
    got = fd.flash_decode_attention_latent(q, cache, dv, 192 ** -0.5)
    want = fd.flash_decode_attention_latent(q, cache, dv, 192 ** -0.5, impl="plain")
    torch.cuda.synchronize()
    assert fd.LATENT_KERNEL.launches == before + 1
    assert torch.isfinite(got).all() and torch.equal(got, want)
    assert not got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("s,dtype", [(32, "float32"), (77, "float32"), (32, "bfloat16")])
@pytest.mark.parametrize("h,dk,dv,rd", [(3, 24, 16, 8), (128, 192, 128, 64)])
def test_cuda_mla_prefill_bit_identical_to_plain(cuda, s, dtype, h, dk, dv, rd):
    b = 6
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(cuda, dt) for a in _mla_qkv(s, b, s, h, dk, dv))
    valid = torch.tensor([s, s - 5, 0, s, 1, s], dtype=torch.int32, device=cuda)
    kw = dict(valid=valid, rope_theta=THETA, rope_dims=rd, emit_kv=False)
    before = fp.MLA_KERNEL.launches
    got = fp.flash_prefill_attention(q, k, v, **kw)
    want = fp.flash_prefill_attention(q, k, v, impl="plain", **kw)
    torch.cuda.synchronize()
    assert fp.MLA_KERNEL.launches == before + 1
    assert torch.equal(got, want)
