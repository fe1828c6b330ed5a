"""Port parity for the MoE layer (repro_torch.models.moe) and the expert
forms of the ternary matmul — act-quant prologue and known scale
(kernels.ternary_matmul.ternary_matmul_expert / _expert_fused,
core.bitlinear.expert_packed_matmul) — against the reference:
``ops.ternary_matmul_expert`` and ``ops.ternary_matmul_expert_fused``
(Pallas kernels in interpret mode, and their XLA paths),
``moe._route_tokens`` / ``apply_moe`` on the deepseek-v3-671b smoke
shapes, with and without ``fuse_act_quant``.

Integer stages and the combine are BIT-IDENTICAL: the expert matmul
(act-quant, int32 accumulate, one f32 epilogue in the same order), the
capacity, the routing decisions (top-k ties to the lower index) and the
bfloat16 combine given the same expert outputs — the port adds each
token's contributions in ascending expert order, which is the order of
the reference's scatter-add (checked with top-4 routing, where the order
shows). A whole layer goes through f32 softmax / SiLU in another
framework, so its output is held to BF16_TOL = 1e-2: one bfloat16 ulp of
the combined sum (2**-8 relative). The CUDA kernel runs only on a card:
the ``cuda``-marked tests hold it against the plain version there, bit
for bit, and skip here.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import configs, interop
from repro_torch.core import bitlinear, packing
from repro_torch.core.ternary import act_quant
from repro_torch.kernels import ternary_matmul as tm
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.pack import pack_params
from test_torch_threads import share_cpu_threads  # noqa: F401 (autouse: torch threads per worker)

CODECS = ["pack2", "pack243"]
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
NAME = "deepseek-v3-671b"


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import bitlinear as jbitlinear
    from repro.core import ternary as jternary
    from repro.kernels import ops as jops
    from repro.models import moe as jmoe
    from repro.models import pack as jpack

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs, bitlinear=jbitlinear,
                                 ops=jops, moe=jmoe, pack=jpack, ternary=jternary)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _expert_case(seed, e, c, k, n, codec):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((e, c, k)) * 2).astype(np.float32)
    w = rng.integers(-1, 2, (e, k, n)).astype(np.int8)
    packed = np.stack([packing.pack(torch.from_numpy(w[i]), codec).numpy() for i in range(e)])
    col = (rng.random((e, n)) + 0.01).astype(np.float32)
    return x, packed, col


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(3, 1, 40, 24), (4, 5, 130, 70), (2, 8, 64, 136)])
def test_expert_plain_bit_identical_to_pallas_and_xla(jref, codec, bits, shape):
    e, c, k, n = shape
    x, packed, col = _expert_case(sum(shape), e, c, k, n, codec)
    jargs = [jref.jnp.asarray(a) for a in (x, packed, col)]
    kw = dict(k=k, codec=codec, act_bits=bits)
    got = tm.ternary_matmul_expert(*(torch.from_numpy(a) for a in (x, packed, col)), **kw)
    assert got.shape == (e, c, n) and got.dtype == torch.float32
    for impl in ("pallas", "xla"):
        want = np.asarray(jref.ops.ternary_matmul_expert(*jargs, impl=impl, **kw))
        np.testing.assert_array_equal(got.numpy(), want)


def test_expert_plain_chunks_like_one_pass(monkeypatch):
    x, packed, col = (torch.from_numpy(a) for a in _expert_case(7, 5, 3, 48, 20, "pack2"))
    one = tm.ternary_matmul_expert(x, packed, col, k=48)
    monkeypatch.setattr(tm, "PLAIN_EXPERT_CHUNK", 2)
    assert torch.equal(tm.ternary_matmul_expert(x, packed, col, k=48), one)
    with pytest.raises(ValueError):
        tm.ternary_matmul_expert(x, packed, col, k=48, impl="pallas")


@pytest.mark.parametrize("codec", CODECS)
def test_expert_packed_matmul_leaves_bit_identical(jref, codec):
    """Expert-stacked leaves packed by the reference (scale (E,)) and their
    pack-time fusion (per-column scale (E, N)), carried across as bytes."""
    rng = np.random.default_rng(3)
    e, k = 4, 72
    ws = [rng.standard_normal((e, k, n)).astype(np.float32) for n in (24, 24)]
    jleaves = [jref.pack._pack_weight(jref.jnp.asarray(w), codec) for w in ws]
    jfused = jref.pack.fuse_packed(jleaves)
    x = rng.standard_normal((e, 3, k)).astype(np.float32)
    for jl in jleaves + [jfused]:
        leaf = interop.from_reference(jl)
        want = np.asarray(jref.bitlinear.expert_packed_matmul(jl, jref.jnp.asarray(x),
                                                              impl="pallas"))
        got = bitlinear.expert_packed_matmul(leaf, torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), want)
    assert tuple(jfused.scale.shape) == (e, 48)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("c", [1, 5, 16])
def test_expert_known_scale_bit_identical_to_pallas_and_xla(jref, codec, c):
    """Kernel 7's plain version: the caller's codes and row scales (an
    empty slot of zero codes included), the reference's carried-scale
    expert kernel (interpret) and its XLA path, and the prologue route on
    the raw x all give the same bits."""
    e, k, n = 4, 96, 72
    x, packed, col = _expert_case(c * 13 + 5, e, c, k, n, codec)
    x[1, -1] = 0.0  # a capacity slot no token took
    q = jref.ternary.act_quant(jref.jnp.asarray(x))
    xq, xs = np.array(q.xq), np.array(q.scale)
    got = tm.ternary_matmul_expert_fused(*(torch.from_numpy(a) for a in (xq, packed, xs, col)),
                                         k=k, codec=codec)
    assert got.shape == (e, c, n) and not got[1, -1].any()
    jargs = [jref.jnp.asarray(a) for a in (xq, packed, xs, col)]
    for impl in ("pallas", "xla"):
        want = np.asarray(jref.ops.ternary_matmul_expert_fused(*jargs, k=k, codec=codec,
                                                               impl=impl))
        np.testing.assert_array_equal(got.numpy(), want)
    prologue = tm.ternary_matmul_expert(*(torch.from_numpy(a) for a in (x, packed, col)),
                                        k=k, codec=codec)
    assert torch.equal(got, prologue)


@pytest.mark.parametrize("codec", CODECS)
def test_expert_packed_matmul_routes_bit_identical(jref, codec):
    """Both expert leaf kinds: a QuantizedActivation input,
    ``fuse_actq=False`` and the prologue route agree bit for bit, and equal
    the reference's carried-scale route (Pallas, interpret)."""
    rng = np.random.default_rng(19)
    e, k = 3, 64
    ws = [rng.standard_normal((e, k, 32)).astype(np.float32) for _ in range(2)]
    jleaves = [jref.pack._pack_weight(jref.jnp.asarray(w), codec) for w in ws]
    x = rng.standard_normal((e, 4, k)).astype(np.float32)
    tx = torch.from_numpy(x)
    for jl in jleaves[:1] + [jref.pack.fuse_packed(jleaves)]:
        leaf = interop.from_reference(jl)
        want = np.asarray(jref.bitlinear.expert_packed_matmul(
            jl, jref.jnp.asarray(x), impl="pallas", fuse_actq=False))
        fused = bitlinear.expert_packed_matmul(leaf, tx)
        for got in (bitlinear.expert_packed_matmul(leaf, tx, fuse_actq=False),
                    bitlinear.expert_packed_matmul(leaf, act_quant(tx))):
            assert torch.equal(got, fused)
            np.testing.assert_array_equal(got.numpy(), want)


def test_capacity_matches_reference(jref):
    for name in (NAME,):
        for cfg, jcfg in ((configs.get_config(name), jref.configs.get_config(name)),
                          (configs.get_smoke_config(name), jref.configs.get_smoke_config(name))):
            for n in (1, 2, 6, 7, 48, 192, 1000):
                assert moe._capacity(n, cfg) == jref.moe._capacity(n, jcfg)
    full = configs.get_config("deepseek-v3-671b-l5")
    assert moe._capacity(6, full) == 1 and moe._capacity(6 * 32, full) == 8


def test_top_k_breaks_ties_like_reference(jref):
    x = np.asarray([[0.5, 0.2, 0.5, 0.0, 0.2, 0.5], [0.0] * 6, [1.0, 3.0, 3.0, 1.0, 2.0, 3.0]],
                   np.float32)
    wv, wi = jref.jax.lax.top_k(jref.jnp.asarray(x), 4)
    gv, gi = moe.top_k(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def _routing(rng, n_e, cap, n_tok, k):
    gate_idx = np.stack([rng.choice(n_e, k, replace=False) for _ in range(n_tok)])
    gate_vals = rng.random((n_tok, k)).astype(np.float32)
    gate_vals /= gate_vals.sum(-1, keepdims=True)
    assign = np.zeros((n_tok, n_e), np.float32)
    assign[np.arange(n_tok)[:, None], gate_idx] = gate_vals
    sel_idx = np.argsort(-assign.T, axis=-1, kind="stable")[:, :cap]
    sel_w = np.take_along_axis(assign.T, sel_idx, axis=-1)
    return gate_idx, sel_w, sel_idx


@pytest.mark.parametrize("top_k,cap", [(2, 6), (4, 6), (8, 3)])
def test_combine_bit_identical_to_reference_scatter(jref, top_k, cap):
    """The bf16 combine against the reference's expression (moe.py: bf16
    product, then ``y.at[sel_idx].add`` in bf16) on the same expert
    outputs. A token sums up to top_k rounded terms, so the order shows:
    an f32 sum rounded once disagrees on the same data."""
    rng = np.random.default_rng(top_k)
    n_e, n_tok, d = 16, 20, 32
    jnp = jref.jnp
    order_shows = False
    for _ in range(20):
        ye = (rng.standard_normal((n_e, cap, d))
              * 10.0 ** rng.uniform(-2, 2, (n_e, 1, 1))).astype(np.float32)
        gate_idx, sel_w, sel_idx = _routing(rng, n_e, cap, n_tok, top_k)
        upd = jnp.asarray(ye).astype(jnp.bfloat16) * jnp.asarray(sel_w)[..., None].astype(
            jnp.bfloat16)
        want = np.asarray(jnp.zeros((n_tok, d), jnp.bfloat16).at[
            jnp.asarray(sel_idx).reshape(-1)].add(upd.reshape(-1, d)).astype(jnp.float32))
        got = moe.combine(torch.from_numpy(ye), torch.from_numpy(sel_w),
                          torch.from_numpy(sel_idx), torch.from_numpy(gate_idx), n_tok)
        np.testing.assert_array_equal(got.numpy(), want)
        f32_sum = np.zeros((n_tok, d), np.float32)
        np.add.at(f32_sum, sel_idx.reshape(-1), np.asarray(upd.astype(jnp.float32)).reshape(-1, d))
        once = torch.from_numpy(f32_sum).to(torch.bfloat16).float().numpy()
        order_shows |= not np.array_equal(once, want)
    assert order_shows or top_k == 2


def _moe_params(jref, seed, top_k=None, codec="pack2"):
    """One MoE block of the smoke config (optionally at another top_k):
    the reference's packed params and the port's carried copy."""
    jcfg = jref.configs.get_smoke_config(NAME)
    cfg = configs.get_smoke_config(NAME)
    over = {} if top_k is None else {"top_k": top_k}
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **over),
                               bitnet=dataclasses.replace(jcfg.bitnet, codec=codec))
    cfg = configs.shrink(configs.get_config(NAME),
                         moe=dataclasses.replace(cfg.moe, **over),
                         bitnet=dataclasses.replace(cfg.bitnet, codec=codec))
    jp = jref.moe.init_moe(jref.jax.random.PRNGKey(seed), jcfg)
    jpacked = jref.pack.pack_params({"moe": jp}, jcfg)["moe"]
    return jcfg, cfg, jpacked, interop.from_reference(jpacked)


@pytest.mark.parametrize("top_k", [2, 4])
def test_route_tokens_matches_reference(jref, top_k):
    jcfg, cfg, jp, tp = _moe_params(jref, seed=top_k, top_k=top_k)
    assert cfg.moe.top_k == top_k and set(tp) >= {"router", "w_gu", "w_down", "shared_gu"}
    h = np.random.default_rng(5).standard_normal((10, cfg.d_model)).astype(np.float32)
    cap = moe._capacity(10, cfg)
    jy, jprobs, jtop1 = jref.moe._route_tokens(jp, jref.jnp.asarray(h), jcfg, "packed", cap)
    ty, tprobs, ttop1 = moe._route_tokens(tp, torch.from_numpy(h), cfg, cap)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ttop1.numpy(), np.asarray(jtop1))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **BF16_TOL)


def test_router_logits_rows_do_not_depend_on_the_batch(jref):
    """Each row's router logits are one fixed-order sum, so a row gives the
    same bits alone and in any batch; the identity factor passes the LoRA
    product's first stage through exactly; 40 experts (two column groups)
    give each column the bits it has alone; and the logits agree with the
    reference's f32 product to 1e-5."""
    from repro_torch.kernels.lora import lora_delta_plain

    rng = np.random.default_rng(9)
    h = rng.standard_normal((40, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 40)) / 10).astype(np.float32)
    th, tw = torch.from_numpy(h), torch.from_numpy(w)
    full = moe.router_logits(th, tw)
    for rows in (slice(0, 1), slice(7, 8), slice(3, 29)):
        assert torch.equal(moe.router_logits(th[rows], tw), full[rows])
    for j in (0, 17, 31, 32, 39):
        assert torch.equal(moe.router_logits(th, tw[:, j:j + 1])[:, 0], full[:, j])
    # the first stage alone: t = x @ A in the kernel's order, read through a
    # second factor that picks one column
    for j in (3, 35):
        pick = torch.zeros((40, 1))
        pick[j] = 1.0
        t_j = lora_delta_plain(th, tw, pick, 1.0)[:, 0]
        assert torch.equal(full[:, j], t_j)
    want = np.asarray(jref.jnp.asarray(h) @ jref.jnp.asarray(w))
    np.testing.assert_allclose(full.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("b,t", [(2, 5), (6, 1)])
def test_apply_moe_matches_reference(jref, codec, b, t):
    """apply_moe on the smoke shapes: a prefill-like (2, 5) block and a
    decode step of 6 slots (capacity counted over every slot)."""
    jcfg, cfg, jp, tp = _moe_params(jref, seed=7, codec=codec)
    x = np.random.default_rng(8).standard_normal((b, t, cfg.d_model)).astype(np.float32)
    jy, jaux = jref.moe.apply_moe(jp, jref.jnp.asarray(x), jcfg, "packed")
    ty, taux = moe.apply_moe(tp, torch.from_numpy(x), cfg)
    assert ty.shape == (b, t, cfg.d_model) and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **BF16_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_init_packs_experts_with_reference_shapes(jref):
    """The port draws and packs routed experts one at a time; after
    pack_params its MoE block has the reference's packed leaves, fused
    w_gu with (E, N) per-column scales included."""
    cfg = configs.get_smoke_config(NAME)
    mine = pack_params(T.init_params(cfg, seed=0, device="cpu"), cfg)
    jcfg = jref.configs.get_smoke_config(NAME)
    from repro.models import transformer as jT

    jpacked = jref.pack.pack_params(jT.init_params(jref.jax.random.PRNGKey(0), jcfg), jcfg)

    def shapes(t, lead=0):
        """Leaf shapes with ``lead`` stacking axes dropped."""
        if hasattr(t, "packed"):
            return (type(t).__name__, tuple(t.packed.shape[lead:]),
                    tuple(t.scale.shape[lead:]), t.k, getattr(t, "splits", None))
        if isinstance(t, dict):
            return {k: shapes(v, lead) for k, v in t.items() if k not in ("w_uk", "w_uv")}
        return tuple(t.shape[lead:])

    for name in ("dense_blocks", "moe_blocks"):
        want = shapes(jpacked[name], lead=1)
        assert len(mine[name]) == np.asarray(jpacked[name]["attn"]["ln"]).shape[0]
        assert all(shapes(blk) == want for blk in mine[name])
    blk = mine["moe_blocks"][0]["moe"]
    assert blk["w_gu"].scale.shape == (cfg.moe.n_experts, 2 * cfg.moe.d_ff_expert)
    assert blk["w_down"].scale.shape == (cfg.moe.n_experts,)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 3, 130, 70), (256, 1, 7168, 4096), (256, 8, 2048, 7168),
                                   (8, 5, 6144, 32768), (8, 2, 16384, 6144)])
def test_cuda_expert_kernel_bit_identical_to_plain(cuda, dtype, shape):
    e, c, k, n = shape
    g = torch.Generator(device=cuda).manual_seed(e + c)
    x = (torch.randn((e, c, k), generator=g, device=cuda) * 2).to(getattr(torch, dtype))
    packed = torch.randint(0, 256, (e, (k + 3) // 4, n), generator=g, device=cuda,
                           dtype=torch.uint8)
    col = torch.rand((e, n), generator=g, device=cuda) + 0.01
    before = tm.EXPERT_KERNEL.launches
    got = tm.ternary_matmul_expert(x, packed, col, k=k)
    want = tm.ternary_matmul_expert(x, packed, col, k=k, impl="plain")
    torch.cuda.synchronize()
    assert tm.EXPERT_KERNEL.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("shape", [(4, 3, 130, 70), (256, 1, 7168, 4096), (256, 8, 2048, 7168)])
def test_cuda_expert_known_scale_kernel_bit_identical_to_plain(cuda, codec, shape):
    """Kernel 7 against its plain version and against kernel 1's expert
    form on the raw x; a slot of zero activations comes out exactly zero."""
    e, c, k, n = shape
    g = torch.Generator(device=cuda).manual_seed(e + c + 1)
    x = torch.randn((e, c, k), generator=g, device=cuda) * 2
    x[0, -1] = 0.0
    trits = torch.randint(-1, 2, (k, n), generator=g, device=cuda, dtype=torch.int8)
    packed = packing.pack(trits, codec)[None].repeat(e, 1, 1)
    col = torch.rand((e, n), generator=g, device=cuda) + 0.01
    q = act_quant(x)
    before = tm.KNOWN_EXPERT_KERNEL.launches
    got = tm.ternary_matmul_expert_fused(q.xq, packed, q.scale, col, k=k, codec=codec)
    torch.cuda.synchronize()
    assert tm.KNOWN_EXPERT_KERNEL.launches == before + 1
    assert torch.equal(got, tm.ternary_matmul_expert_fused(q.xq, packed, q.scale, col, k=k,
                                                           codec=codec, impl="plain"))
    assert torch.equal(got, tm.ternary_matmul_expert(x, packed, col, k=k, codec=codec))
    assert not got[0, -1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("d,n_e", [(6144, 8), (7168, 256)])
def test_cuda_router_logits_kernel_rows_do_not_depend_on_m(cuda, d, n_e):
    """mixtral-8x22b's router (6144 -> 8) and deepseek-v3's (7168 -> 256,
    eight column groups) through the LoRA kernel: bit-identical to the
    plain version, and each row's bits the same at M = 1 and M = 300."""
    from repro_torch.kernels import lora as klora

    g = torch.Generator(device=cuda).manual_seed(d)
    h = torch.randn((300, d), generator=g, device=cuda)
    w = torch.randn((d, n_e), generator=g, device=cuda) * d ** -0.5
    before = klora.KERNEL.launches
    got = moe.router_logits(h, w)
    torch.cuda.synchronize()
    assert klora.KERNEL.launches == before + -(-n_e // klora.MAX_RANK)
    assert torch.equal(got, moe.router_logits(h, w, impl="plain"))
    one = torch.cat([moe.router_logits(h[i:i + 1], w) for i in range(0, 300, 37)])
    assert torch.equal(one, got[0:300:37])
