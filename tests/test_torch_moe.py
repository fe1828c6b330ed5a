"""Port parity for the MoE layer (repro_torch.models.moe) and the expert
form of the act-quant ternary matmul (kernels.ternary_matmul.
ternary_matmul_expert, core.bitlinear.expert_packed_matmul) against the
reference: ``ops.ternary_matmul_expert`` (Pallas kernel in interpret mode,
and its XLA path), ``moe._route_tokens`` / ``apply_moe`` on the
deepseek-v3-671b smoke shapes.

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
from repro_torch.kernels import ternary_matmul as tm
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.pack import pack_params

CODECS = ["pack2", "pack243"]
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
NAME = "deepseek-v3-671b"


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import bitlinear as jbitlinear
    from repro.kernels import ops as jops
    from repro.models import moe as jmoe
    from repro.models import pack as jpack

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs, bitlinear=jbitlinear,
                                 ops=jops, moe=jmoe, pack=jpack)


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
        leaf = interop.from_reference(dict(
            packed=np.asarray(jl.packed), scale=np.asarray(jl.scale), k=jl.k, codec=jl.codec,
            **({"splits": jl.splits} if hasattr(jl, "splits") else {})))
        want = np.asarray(jref.bitlinear.expert_packed_matmul(jl, jref.jnp.asarray(x),
                                                              impl="pallas"))
        got = bitlinear.expert_packed_matmul(leaf, torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), want)
    assert tuple(jfused.scale.shape) == (e, 48)


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

    def np_tree(t):
        if isinstance(t, (jref.bitlinear.PackedLinear, jref.bitlinear.FusedPackedLinear)):
            return dict(packed=np.asarray(t.packed), scale=np.asarray(t.scale), k=t.k,
                        codec=t.codec, **({"splits": t.splits} if hasattr(t, "splits") else {}))
        if isinstance(t, dict):
            return {k: np_tree(v) for k, v in t.items()}
        return np.asarray(t)

    return jcfg, cfg, jpacked, interop.from_reference(np_tree(jpacked))


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
@pytest.mark.parametrize("shape", [(4, 3, 130, 70), (256, 1, 7168, 4096), (256, 8, 2048, 7168)])
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
