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
from repro_torch.core.ternary import act_quant
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels.flash_decode import NEG_INF, tree_sum
from repro_torch.kernels import flash_prefill as fp
from repro_torch.models import attention as attn
from repro_torch.models import layers, qops
from test_torch_threads import share_cpu_threads  # noqa: F401 (autouse: torch threads per worker)

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
    from repro.models import layers as jlayers
    from repro.models import pack as jpack
    from repro.models import qops as jqops

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs, bitlinear=jbitlinear,
                                 kvc=jkvc, ternary=jternary, fd=jfd, fp=jfp, attn=jattn,
                                 pack=jpack, layers=jlayers, qops=jqops)


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


def _poisoned_latent_cache(lens, hot, cold, d, seed, dtype=torch.float32, device="cpu"):
    """A latent cache of random rows at the given lengths whose masked rows
    (at or past each slot's length) hold NaN: no reader may touch them."""
    rng = np.random.default_rng(seed)
    cache = kvc.init_cache(len(lens), hot, cold, (d,), v_shape=(0,))
    cache = cache._replace(
        hot_k=torch.from_numpy(rng.standard_normal(cache.hot_k.shape).astype(np.float32)),
        cold_k=torch.from_numpy(rng.standard_normal(cache.cold_k.shape).astype(np.float32)),
        lengths=torch.tensor(lens, dtype=torch.int32))
    hot_valid, cold_valid = kvc.valid_masks(cache)
    return cache._replace(
        hot_k=kvc.to_tier(torch.where(hot_valid[..., None], cache.hot_k, float("nan")),
                          dtype).to(device),
        cold_k=kvc.to_tier(torch.where(cold_valid[..., None], cache.cold_k, float("nan")),
                           dtype).to(device),
        lengths=cache.lengths.to(device))


def _latent_dot_order(prod):
    """The latent kernel's dot product (``dot_sum`` in csrc/flash_latent.cu)
    of each row of f32 products (rows, d), every lane's result (rows, 32).
    Lane L holds dims L + 32 t, t < tl = ceil(d / 32) (+0.0 past d). Of the
    first in-lane level of the width zero-padded to 32 * pow2(tl) only the
    real steps t + h -> t are taken, then the lane halves t < h, then the
    xor butterfly sums across lanes."""
    rows, d = prod.shape
    tl = -(-d // 32)
    x = torch.zeros(rows, tl * 32)
    x[:, :d] = prod
    x = x.reshape(rows, tl, 32)  # [row, t, lane]
    h = (1 << (tl - 1).bit_length()) // 2
    if h:
        x = torch.cat([x[:, : tl - h] + x[:, h:], x[:, tl - h: h]], 1)
        while x.shape[1] > 1:
            x = x[:, : x.shape[1] // 2] + x[:, x.shape[1] // 2:]
    s = x[:, 0]
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, lanes ^ o]
    return s


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("d", [576, 24])
def test_latent_unpadded_dot_order_equals_tree_sum(d, seed):
    """The latent kernel's dot order, which leaves out the padded width's
    +0.0 steps, equals the plain version's zero-padded ``tree_sum`` on
    random rows, rows of mixed magnitudes and rows mostly of signed zeros,
    except in the sign of a zero sum: -0.0 + +0.0 is +0.0, so at d = 576 an
    all-(-0.0) row sums to -0.0 here and to +0.0 there. At d = 24 the two
    orders are the same."""
    rng = np.random.default_rng(seed)
    prod = rng.standard_normal((3000, d)).astype(np.float32)
    prod[1000:2000] *= np.exp2(rng.integers(-40, 40, (1000, d))).astype(np.float32)
    zeros = rng.random((1000, d)) < 0.9
    prod[2000:][zeros] = np.where(rng.random(zeros.sum()) < 0.5, -0.0, 0.0)
    prod[2000] = -0.0
    lanes = _latent_dot_order(torch.from_numpy(prod))
    want = tree_sum(torch.from_numpy(prod), -1)
    got = lanes[:, 0]
    assert torch.equal(lanes, got[:, None].expand(-1, 32).contiguous())  # every lane, same sum
    assert torch.equal(got, want)  # equal values; -0.0 == +0.0
    differ = got.view(torch.int32) != want.view(torch.int32)
    assert (got[differ] == 0).all()  # a differing bit pattern is a zero's sign
    if d == 24:  # the padding sits in lanes 24-31 of the butterfly, as in tree_sum
        assert not differ.any()
    else:
        assert differ[2000] and got[2000].view(torch.int32) == np.float32(-0.0).view(np.int32)


def _latent_schedule_model(q, cache, dv, scale, chunk):
    """The latent kernel's schedule (csrc/flash_latent.cu, one tile per
    chunk) in torch, per slot: the valid rows' 32-key tiles, hot tier then
    cold tier; per chunk of ``chunk`` tiles every logit first
    (``_latent_dot_order``, valid rows only), then per tile m_new, alpha, p
    and l for every head, then P.V with 32-value halving trees
    (``tile_dot``'s order)."""
    b, h, _ = q.shape
    out = torch.zeros(b, h, dv)
    for s, n_valid in enumerate(cache.lengths.tolist()):
        n_hot = min(n_valid, cache.hot_cap)
        n_cold = min(max(n_valid - cache.hot_cap, 0), cache.cold_cap)
        tiles = ([cache.hot_k[s, i: min(i + 32, n_hot)] for i in range(0, n_hot, 32)]
                 + [cache.cold_k[s, i: min(i + 32, n_cold)] for i in range(0, n_cold, 32)])
        m, l, acc = torch.full((h,), NEG_INF), torch.zeros(h), torch.zeros(h, dv)
        for c0 in range(0, len(tiles), chunk):
            part = [rows.float() for rows in tiles[c0: c0 + chunk]]
            logits = [_latent_dot_order((q[s, :, None] * rows[None]).flatten(0, 1))[:, 0]
                      .reshape(h, -1) * scale for rows in part]
            for rows, lg in zip(part, logits):
                n = rows.shape[0]
                m_new = torch.maximum(m, lg.amax(-1))
                alpha = torch.exp(m - m_new)
                p, v = torch.zeros(h, 32), torch.zeros(32, dv)
                p[:, :n], v[:n] = torch.exp(lg - m_new[:, None]), rows[:, :dv]
                l = l * alpha + tree_sum(p, -1)
                acc = acc * alpha[:, None] + tree_sum(p[:, :, None] * v, -2)
                m = m_new
        out[s] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("lens,hot,cold", [
    ([0, 1, 31, 32, 33, 80, 128], 32, 96),  # empty, ragged, tile edges, full
    ([0, 47, 48, 49, 100, 128], 48, 80),  # a partial hot tile before the cold tiles
    ([500, 0, 129, 257], 32, 480),  # several chunks
])
@pytest.mark.parametrize("d,dv", [(576, 512), (24, 16)])
@pytest.mark.parametrize("chunk", [1, 4])
def test_latent_schedule_model_bit_identical_to_plain(chunk, d, dv, lens, hot, cold):
    """The logits of a chunk first (one tile, as the kernel runs, or four:
    all of a 128-row cache), then the per-tile fold, in the kernel's
    unpadded dot order, gives ``flash_decode_latent_plain``'s output bit
    for bit, with the masked rows NaN-filled."""
    cache = _poisoned_latent_cache(lens, hot, cold, d, seed=len(lens) + d)
    q = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (len(lens), 3, d)).astype(np.float32))
    q[0, 1] = -0.0
    got = _latent_schedule_model(q, cache, dv, 192 ** -0.5, chunk)
    want = fd.flash_decode_latent_plain(q, cache, dv, 192 ** -0.5)
    assert torch.isfinite(want).all() and torch.equal(got, want)


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


def test_mla_prefill_and_decode_with_lora_match_reference(jref):
    """MLA with adapters (lora_rank 4 on both sides): ``lora_v`` on the
    w_uv values, ``lora_o`` on wo, both with seeded non-zero B factors (the
    init's zeros would leave them untested); a layer's prefill and two
    decode steps with an inactive slot, against the reference's XLA path."""
    jcfg = jref.configs.get_smoke_config(NAME)
    jcfg = dataclasses.replace(jcfg, bitnet=dataclasses.replace(jcfg.bitnet, lora_rank=4))
    cfg = get_smoke_config(NAME)
    cfg = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, lora_rank=4))
    jp = jref.attn.init_mla(jref.jax.random.PRNGKey(2), jcfg)
    rng = np.random.default_rng(4)
    for key in ("lora_v", "lora_o"):
        b = rng.normal(0.0, 0.05, jp[key]["b"].shape).astype(np.float32)
        jp[key] = {"a": jp[key]["a"], "b": jref.jnp.asarray(b)}
    jp = jref.pack.pack_params({"attn": jp}, jcfg)["attn"]
    tp = interop.from_reference(numpy_tree(jref, jp))
    assert tp["lora_v"]["b"].abs().sum() > 0 and tp["lora_o"]["b"].abs().sum() > 0
    b, s, hot, cold = 3, 6, 4, 12
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    jc = jref.kvc.init_cache(b, hot, cold, (cfg.mla.kv_cache_dim,), jref.jnp.float32)
    jc = jc._replace(hot_v=jref.jnp.zeros((b, hot, 0)), cold_v=jref.jnp.zeros((b, cold, 0)))
    jy, jc = jref.attn.mla_prefill(jp, jref.jnp.asarray(x), jcfg, "packed", jc)
    cache = kvc.init_cache(b, hot, cold, (cfg.mla.kv_cache_dim,), v_shape=(0,))
    ty, _ = attn.mla_prefill(tp, torch.from_numpy(x), cfg, cache)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
    no_lora = attn.mla_prefill(tp, torch.from_numpy(x), dataclasses.replace(
        cfg, bitnet=dataclasses.replace(cfg.bitnet, lora_rank=0)),
        kvc.init_cache(b, hot, cold, (cfg.mla.kv_cache_dim,), v_shape=(0,)))[0]
    assert not np.allclose(no_lora.numpy(), np.asarray(jy), rtol=1e-3, atol=1e-3)
    active = np.asarray([True, False, True])
    for _ in range(2):
        xd = rng.standard_normal((b, cfg.d_model)).astype(np.float32)
        jy, jc = jref.attn.mla_decode(jp, jref.jnp.asarray(xd), jcfg, "packed", jc,
                                      active=jref.jnp.asarray(active))
        ty, _ = attn.mla_decode(tp, torch.from_numpy(xd), cfg, cache,
                                active=torch.from_numpy(active))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
        for got, want in zip(cache, jc):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_a4_latent_factors_bit_identical_on_reference_c_kv(jref, seed):
    """At act_bits=4 the reference's own latent ``c_kv`` (its rms_norm,
    carried as numpy) goes through the port's ``qops.linear(w_uk / w_uv)``:
    the A4 codes and scales, and both outputs, are bit-identical to the
    reference's. ``c_kv`` comes from integer accumulators times scales, so
    it holds exact ties (x * scale = ±k.5): the integer stages agree at
    the ties, and the A4 token gap of deepseek-v3-671b-smoke starts in
    rms_norm (next test)."""
    jcfg = jref.configs.get_smoke_config(NAME)
    jcfg = dataclasses.replace(jcfg, bitnet=dataclasses.replace(jcfg.bitnet, act_bits=4))
    cfg = get_smoke_config(NAME)
    cfg = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, act_bits=4))
    jp = jref.pack.pack_params({"attn": jref.attn.init_mla(jref.jax.random.PRNGKey(seed), jcfg)},
                               jcfg)["attn"]
    tp = interop.from_reference(numpy_tree(jref, jp))
    m, h = cfg.mla, cfg.n_heads
    x = np.random.default_rng(seed).standard_normal((3, 6, cfg.d_model)).astype(np.float32)
    hidden = jref.layers.rms_norm(jref.jnp.asarray(x), jp["ln"], jcfg.norm_eps)
    _, dkv = jref.attn._mla_down(jp, hidden, jcfg, "packed")
    jc, _ = jref.attn._mla_latent(jp, dkv, jcfg, jref.jnp.arange(6)[None])
    c_kv = np.asarray(jc)
    jq = jref.ternary.act_quant(jc, bits=4)
    xs = np.abs(c_kv * np.asarray(jq.scale))
    assert np.sum(xs - np.floor(xs) == 0.5) > 0  # exact ties are present
    tq = act_quant(torch.from_numpy(c_kv), bits=4)
    np.testing.assert_array_equal(tq.xq.numpy(), np.asarray(jq.xq))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    for name, width in (("w_uk", m.qk_nope_head_dim), ("w_uv", m.v_head_dim)):
        want = jref.qops.linear(jp[name], jc, jcfg, "packed", out_shape=(h, width))
        got = qops.linear(tp[name], torch.from_numpy(c_kv), cfg, out_shape=(h, width))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# measured at the widths below over 12 seeds of 512 rows: the output differs
# on about half the rows, by at most 4-5 ulp with unit weights and 5-6 with
# non-unit ones (the f32 mean differs by up to 5 ulp on 53-70 % of rows,
# rsqrt of the same input by up to 2 ulp on about a third)
RMS_NORM_ULPS = 8


@pytest.mark.parametrize("d", [2048, 7168])
def test_rms_norm_gap_to_reference_is_bounded(jref, d):
    """The recorded framework difference (ROADMAP §3): torch's and XLA's
    f32 ``mean(x * x)`` and ``rsqrt`` round differently, and neither is
    exactly rounded, so ``rms_norm`` differs from the reference by a few
    ulp on many rows. Bounded here at DeepSeek-V3's and falcon3-1b's
    widths, with unit and non-unit weights."""
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((512, d)) * rng.uniform(0.1, 10.0, (512, 1))).astype(np.float32)
    for w in (np.ones(d, np.float32), (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)):
        want = np.asarray(jref.layers.rms_norm(jref.jnp.asarray(x), jref.jnp.asarray(w), 1e-6))
        got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy()
        assert np.array_equal(np.sign(got), np.sign(want))
        ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
        assert ulps.max() <= RMS_NORM_ULPS, ulps.max()


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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float8_e4m3fn"])
@pytest.mark.parametrize("h", [1, 3, 5, 128])
@pytest.mark.parametrize("lens,hot,cold", [
    ([0, 1, 31, 32, 33, 64, 80, 127, 128], 32, 96),  # serving's tiers
    ([0, 1, 31, 32, 33, 64, 80, 127, 128], 48, 80),  # a partial hot tile first
    ([500, 0, 1, 33, 128, 129, 257], 32, 480),  # past one chunk of logits
])
@pytest.mark.parametrize("d,dv", [(24, 16), (576, 512)])
def test_cuda_latent_kernel_bit_identical_to_plain(cuda, d, dv, lens, hot, cold, h, dtype):
    """Ragged, empty and full slots over both tiers, head counts below, at
    and off the block's head group, a q row of -0.0, masked rows of NaN,
    tiers in f32, bf16 or fp8 (A4a, its own entry point): one launch,
    equal to the plain version bit for bit."""
    cache = _poisoned_latent_cache(lens, hot, cold, d, seed=h + d, dtype=getattr(torch, dtype),
                                   device=cuda)
    q = torch.from_numpy(np.random.default_rng(h).standard_normal(
        (len(lens), h, d)).astype(np.float32)).to(cuda)
    q[2, h // 2] = -0.0
    kern = fd.LATENT_FP8_KERNEL if dtype == "float8_e4m3fn" else fd.LATENT_KERNEL
    before = kern.launches
    got = fd.flash_decode_attention_latent(q, cache, dv, 192 ** -0.5)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = fd.flash_decode_attention_latent(q, cache, dv, 192 ** -0.5, impl="plain")
    assert torch.isfinite(got).all() and torch.equal(got, want)
    assert not got[torch.tensor(lens) == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 16, 31, 32, 33, 77, 128])
@pytest.mark.parametrize("h", [1, 3, 128])
@pytest.mark.parametrize("dk,dv,rd", [(24, 16, 8), (192, 128, 64)])
def test_cuda_mla_prefill_bit_identical_to_plain(cuda, dk, dv, rd, h, s, dtype):
    """The MLA kernel's 16-row blocks over one (head, slot) at both dim
    sets (the smoke config's and DeepSeek-V3's), a head count below, at and
    above the grid's width, one q block, part of one, and several, with
    empty, one-token, ragged and full slots in one batch: one launch of
    the MLA entry point, none of the GQA one, equal to plain bit for bit."""
    b = 4
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(cuda, dt) for a in _mla_qkv(s + h, b, s, h, dk, dv))
    valid = torch.tensor([0, 1, max(s - 5, 0), s], dtype=torch.int32, device=cuda)
    kw = dict(valid=valid, rope_theta=THETA, rope_dims=rd, emit_kv=False)
    gqa, mla = fp.KERNEL.launches, fp.MLA_KERNEL.launches
    got = fp.flash_prefill_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (fp.KERNEL.launches, fp.MLA_KERNEL.launches) == (gqa, mla + 1)
    want = fp.flash_prefill_attention(q, k, v, impl="plain", **kw)
    assert torch.equal(got, want)
