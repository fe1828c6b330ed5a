"""Port parity for the 2-D packed-ternary matmuls
(repro_torch.kernels.ternary_matmul, kernels.ref, core.bitlinear,
models.qops) against the reference's Pallas kernels (interpret mode) and
their XLA paths: the act-quant-prologue ``ternary_matmul_actq_pallas``,
the known-scale ``ternary_matmul_fused_pallas`` (the carried-scale path,
``fuse_act_quant=False``) and the int32 ``ternary_matmul_pallas``, plus
the oracles of ``repro.kernels.ref``.

Everything here is integer arithmetic plus one f32 epilogue in the same
order, so the contract is BIT-IDENTITY: the int32 accumulator, and the
float output of the plain versions against both reference paths, for
pack2 / pack243, A8 / A4, f32 / bf16 activations and ragged M, N, K; and
the carried-scale route equals the prologue route. The CUDA kernels
themselves run only on a card: the ``cuda``-marked tests hold them
against their plain versions there and skip here.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.core import bitlinear, packing
from repro_torch.core.ternary import act_quant
from repro_torch.kernels import ref
from repro_torch.kernels import ternary_matmul as tm
from repro_torch.models import qops
from test_torch_threads import share_cpu_threads  # noqa: F401 (autouse: torch threads per worker)

CODECS = ["pack2", "pack243"]
# deepseek-v3-671b's 2-D packed projections (K, N), as chip_smoke.py serves them
DEEPSEEK_SHAPES = [(7168, 2112), (1536, 24576), (16384, 7168), (7168, 36864), (18432, 7168),
                   (7168, 4096), (2048, 7168)]


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import bitlinear as jbitlinear
    from repro.core import packing as jpacking
    from repro.core import ternary as jternary
    from repro.kernels import ops as jops
    from repro.kernels import ref as jkref
    from repro.models import pack as jpack
    from repro.models import qops as jqops

    return types.SimpleNamespace(jnp=jnp, bitlinear=jbitlinear, packing=jpacking,
                                 ops=jops, ref=jkref, pack=jpack, ternary=jternary,
                                 configs=jconfigs, qops=jqops)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(seed, m, k, n, codec):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 2).astype(np.float32)
    w = rng.integers(-1, 2, (k, n)).astype(np.int8)
    packed = packing.pack(torch.from_numpy(w), codec).numpy()
    col = (rng.random(n) + 0.01).astype(np.float32)
    return x, packed, col


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("shape", [(1, 8, 4), (7, 130, 70), (33, 96, 256)])
def test_int32_accumulator_bit_identical(jref, codec, shape):
    m, k, n = shape
    rng = np.random.default_rng(m)
    xq = rng.integers(-128, 128, (m, k)).astype(np.int8)
    _, packed, _ = _case(k, m, k, n, codec)
    want = np.asarray(jref.ref.ternary_matmul_ref(jref.jnp.asarray(xq), jref.jnp.asarray(packed),
                                                  k, codec))
    got = tm.ternary_acc_plain(torch.from_numpy(xq), torch.from_numpy(packed), k, codec)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(1, 64, 48), (5, 130, 70)])
def test_plain_bit_identical_to_pallas_and_xla(jref, codec, bits, shape):
    m, k, n = shape
    x, packed, col = _case(sum(shape) + bits, m, k, n, codec)
    jx, jp, jc = (jref.jnp.asarray(a) for a in (x, packed, col))
    want_pallas = np.asarray(jref.ops.ternary_matmul_actq(
        jx, jp, jc, k=k, codec=codec, act_bits=bits, impl="pallas"))
    want_xla = np.asarray(jref.ops.ternary_matmul_actq(
        jx, jp, jc, k=k, codec=codec, act_bits=bits, impl="xla"))
    got = tm.ternary_matmul_actq(torch.from_numpy(x), torch.from_numpy(packed),
                                 torch.from_numpy(col), k=k, codec=codec, act_bits=bits)
    np.testing.assert_array_equal(got.numpy(), want_pallas)
    np.testing.assert_array_equal(got.numpy(), want_xla)


@pytest.mark.parametrize("codec", CODECS)
def test_bf16_activations_bit_identical(jref, codec):
    x, packed, col = _case(3, 6, 96, 40, codec)
    jx = jref.jnp.asarray(x).astype(jref.jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jref.ops.ternary_matmul_actq(
        jx, jref.jnp.asarray(packed), jref.jnp.asarray(col), k=96, codec=codec, impl="xla"))
    got = tm.ternary_matmul_actq(tx, torch.from_numpy(packed), torch.from_numpy(col),
                                 k=96, codec=codec)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("codec", CODECS)
def test_packed_matmul_leaves_bit_identical(jref, codec):
    """bitlinear.packed_matmul on a scalar-scale PackedLinear and on a fused
    per-column-scale leaf matches the reference's packed_matmul, with the
    leaves' bytes and scales carried across as they are."""
    rng = np.random.default_rng(11)
    ws = [rng.standard_normal((72, n)).astype(np.float32) for n in (32, 16, 16)]
    jleaves = [jref.pack._pack_weight(jref.jnp.asarray(w), codec) for w in ws]
    jfused = jref.pack.fuse_packed(jleaves)
    x = rng.standard_normal((4, 72)).astype(np.float32)
    for jl in jleaves + [jfused]:
        want = np.asarray(jref.bitlinear.packed_matmul(jl, jref.jnp.asarray(x), impl="xla"))
        got = bitlinear.packed_matmul(interop.from_reference(jl), torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), want)


def _codes(jref, x, bits):
    """The reference's act-quant codes and row scales of x, as numpy."""
    q = jref.ternary.act_quant(jref.jnp.asarray(x), bits=bits)
    return np.array(q.xq), np.array(q.scale)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(1, 64, 48), (5, 130, 70), (33, 96, 256)])
def test_known_scale_bit_identical_to_pallas_and_xla(jref, codec, bits, shape):
    """Kernel 4's plain version: the caller's codes and row scales, the
    reference's known-scale kernel (interpret) and its XLA path, and the
    prologue route on the raw x all give the same bits."""
    m, k, n = shape
    x, packed, col = _case(sum(shape) + 3 * bits, m, k, n, codec)
    xq, xs = _codes(jref, x, bits)
    jargs = [jref.jnp.asarray(a) for a in (xq, packed, xs, col)]
    got = tm.ternary_matmul_fused(*(torch.from_numpy(a) for a in (xq, packed, xs, col)),
                                  k=k, codec=codec)
    assert got.shape == (m, n) and got.dtype == torch.float32
    for impl in ("pallas", "xla"):
        want = np.asarray(jref.ops.ternary_matmul_fused(*jargs, k=k, codec=codec, impl=impl))
        np.testing.assert_array_equal(got.numpy(), want)
    prologue = tm.ternary_matmul_actq(torch.from_numpy(x), torch.from_numpy(packed),
                                      torch.from_numpy(col), k=k, codec=codec, act_bits=bits)
    np.testing.assert_array_equal(got.numpy(), prologue.numpy())


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("shape", [(1, 8, 4), (2, 3, 130, 70), (33, 96, 256)])
def test_int32_entry_point_bit_identical(jref, codec, shape):
    """Kernel 5's entry point, int8 (..., K) -> int32 (..., N), against the
    reference's Pallas kernel (interpret), its XLA path and its oracle."""
    *lead, k, n = shape
    rng = np.random.default_rng(k + n)
    xq = rng.integers(-128, 128, tuple(lead) + (k,)).astype(np.int8)
    _, packed, _ = _case(n, 1, k, n, codec)
    got = tm.ternary_matmul(torch.from_numpy(xq), torch.from_numpy(packed), k=k, codec=codec)
    assert got.dtype == torch.int32 and got.shape == tuple(lead) + (n,)
    jx, jp = jref.jnp.asarray(xq), jref.jnp.asarray(packed)
    for want in (jref.ops.ternary_matmul(jx, jp, k=k, codec=codec, impl="pallas"),
                 jref.ops.ternary_matmul(jx, jp, k=k, codec=codec, impl="xla"),
                 jref.ref.ternary_matmul_ref(jx, jp, k, codec)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("codec", CODECS)
def test_ref_oracles_bit_identical(jref, codec):
    """kernels/ref.py: the TriMLA oracles equal the reference's, and the
    packed oracle equals the plain accumulator."""
    rng = np.random.default_rng(21)
    xq = rng.integers(-128, 128, (4, 3, 77)).astype(np.int8)
    wq = rng.integers(-1, 2, (77, 40)).astype(np.int8)
    packed = packing.pack(torch.from_numpy(wq), codec)
    got = ref.ternary_matmul_ref(torch.from_numpy(xq), packed, 77, codec)
    want = jref.ref.ternary_matmul_ref(jref.jnp.asarray(xq), jref.jnp.asarray(packed.numpy()),
                                       77, codec)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ref.ternary_matmul_dense_ref(torch.from_numpy(xq), torch.from_numpy(wq)).numpy(),
        np.asarray(jref.ref.ternary_matmul_dense_ref(jref.jnp.asarray(xq),
                                                     jref.jnp.asarray(wq))))
    assert torch.equal(got.reshape(12, 40),
                       tm.ternary_acc_plain(torch.from_numpy(xq).reshape(12, 77), packed, 77,
                                            codec))
    # a weight of multiples of 0.5: its absmean is exact in any summation
    # order, so the two frameworks quantize it alike
    w = (rng.integers(-3, 4, (96, 24)) * 0.5).astype(np.float32)
    x = rng.standard_normal((5, 96)).astype(np.float32)
    for bits in (8, 4):
        np.testing.assert_array_equal(
            ref.bitlinear_ref(torch.from_numpy(x), torch.from_numpy(w), bits).numpy(),
            np.asarray(jref.ref.bitlinear_ref(jref.jnp.asarray(x), jref.jnp.asarray(w), bits)))


@pytest.mark.parametrize("codec", CODECS)
def test_packed_matmul_routes_bit_identical(jref, codec):
    """bitlinear.packed_matmul on both leaf kinds: a QuantizedActivation
    input, ``fuse_actq=False`` and the prologue route give the same bits,
    and equal the reference's known-scale route (Pallas, interpret)."""
    rng = np.random.default_rng(13)
    ws = [rng.standard_normal((72, n)).astype(np.float32) for n in (32, 16, 16)]
    jleaves = [jref.pack._pack_weight(jref.jnp.asarray(w), codec) for w in ws]
    x = rng.standard_normal((5, 72)).astype(np.float32)
    tx = torch.from_numpy(x)
    for jl in jleaves + [jref.pack.fuse_packed(jleaves)]:
        leaf = interop.from_reference(jl)
        want = np.asarray(jref.bitlinear.packed_matmul(jl, jref.jnp.asarray(x), impl="pallas",
                                                       fuse_actq=False))
        fused = bitlinear.packed_matmul(leaf, tx)
        for got in (bitlinear.packed_matmul(leaf, tx, fuse_actq=False),
                    bitlinear.packed_matmul(leaf, act_quant(tx)),
                    bitlinear.packed_matmul(leaf, act_quant(tx), fuse_actq=False)):
            assert torch.equal(got, fused)
            np.testing.assert_array_equal(got.numpy(), want)


def test_qops_fuse_act_quant_config_threading(jref):
    """``BitNetConfig.fuse_act_quant=False`` reaches qops.linear and
    fused_linear and changes no bit; the reference runs its known-scale
    kernel under ``impl="pallas"`` (interpret) for the same leaves."""
    jcfg = jref.configs.get_smoke_config("falcon3-1b")
    jcfg = dataclasses.replace(jcfg, bitnet=dataclasses.replace(
        jcfg.bitnet, impl="pallas", fuse_act_quant=False))
    cfg = get_smoke_config("falcon3-1b")
    cfg_np = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet,
                                                                 fuse_act_quant=False))
    rng = np.random.default_rng(4)
    ws = [rng.standard_normal((64, n)).astype(np.float32) for n in (48, 16)]
    jleaves = [jref.pack._pack_weight(jref.jnp.asarray(w), "pack2") for w in ws]
    jfused = jref.pack.fuse_packed(jleaves)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    jx, tx = jref.jnp.asarray(x), torch.from_numpy(x)
    want = np.asarray(jref.qops.linear(jleaves[0], jx, jcfg, "packed"))
    got = qops.linear(interop.from_reference(jleaves[0]), tx, cfg_np)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, qops.linear(interop.from_reference(jleaves[0]), tx, cfg))
    wants = jref.qops.fused_linear(jfused, jx, jcfg)
    gots = qops.fused_linear(interop.from_reference(jfused), tx, cfg_np)
    for g, w, f in zip(gots, wants, qops.fused_linear(interop.from_reference(jfused), tx, cfg)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, f)


def test_carried_scale_route_launches_no_prologue_kernel(monkeypatch):
    """Under ``fuse_actq=False`` the packed path never reaches the act-quant
    prologue wrapper; under the default it never reaches the known-scale
    one."""
    calls = []

    def spy(name):
        real = getattr(tm, name)

        def call(*args, **kw):
            calls.append(name)
            return real(*args, **kw)
        return call

    for name in ("ternary_matmul_actq", "ternary_matmul_fused"):
        monkeypatch.setattr(tm, name, spy(name))
    x, packed, _ = _case(2, 3, 40, 8, "pack2")
    leaf = bitlinear.PackedLinear(torch.from_numpy(packed), torch.tensor(0.5), 40, "pack2")
    bitlinear.packed_matmul(leaf, torch.from_numpy(x), fuse_actq=False)
    bitlinear.packed_matmul(leaf, act_quant(torch.from_numpy(x)))
    assert calls == ["ternary_matmul_fused"] * 2
    bitlinear.packed_matmul(leaf, torch.from_numpy(x))
    assert calls[-1] == "ternary_matmul_actq"


@pytest.mark.parametrize("k", [8192, 2 ** 17])
def test_plain_product_exact_at_its_range_limit(k):
    """The plain accumulate is exact: on the CPU an int8 GEMM with an int32
    accumulator, on the card a float product in ``exact_float(k)``
    (float32 while 128 K <= 2**24). At the extremes, codes -128 against
    all-+1 / all--1 / alternating trits, both give the float64 oracle's
    sums bit for bit, the largest magnitude 128 K = 2**24 at K = 2**17."""
    assert tm.exact_float(k) == torch.float32
    assert tm.exact_float(2 ** 17 + 1) == torch.float64
    n = 3
    trits = torch.stack([torch.ones(k, dtype=torch.int8), -torch.ones(k, dtype=torch.int8),
                         (torch.arange(k) % 2 * 2 - 1).to(torch.int8)], dim=1)
    xq = torch.stack([torch.full((k,), -128, dtype=torch.int8),
                      torch.full((k,), 127, dtype=torch.int8)])
    want = ref.ternary_matmul_dense_ref(xq, trits)
    assert want[0, 0] == -128 * k and want[0, 1] == 128 * k
    packed = packing.pack(trits, "pack2")
    assert torch.equal(tm.ternary_acc_plain(xq, packed, k, "pack2"), want)
    ft = tm.exact_float(k)
    assert torch.equal((xq.to(ft) @ trits.to(ft)).to(torch.int32), want)
    assert want.shape == (2, n)


def test_wrapper_dispatch_and_checks():
    x, packed, col = _case(0, 3, 20, 8, "pack2")
    args = (torch.from_numpy(x), torch.from_numpy(packed), torch.from_numpy(col))
    auto = tm.ternary_matmul_actq(*args, k=20)
    plain = tm.ternary_matmul_actq(*args, k=20, impl="plain")
    assert torch.equal(auto, plain) and auto.shape == (3, 8) and auto.dtype == torch.float32
    lead = tm.ternary_matmul_actq(args[0].reshape(3, 1, 20), *args[1:], k=20)
    assert torch.equal(lead.reshape(3, 8), auto)
    with pytest.raises(ValueError):
        tm.ternary_matmul_actq(*args, k=20, impl="pallas")
    with pytest.raises(ValueError):
        tm.ternary_matmul_actq(*args, k=20, act_bits=6)
    q = act_quant(args[0])
    for fn in (lambda impl: tm.ternary_matmul_fused(q.xq, args[1], q.scale, args[2], k=20,
                                                    impl=impl),
               lambda impl: tm.ternary_matmul(q.xq, args[1], k=20, impl=impl)):
        assert torch.equal(fn("auto"), fn("plain"))
        with pytest.raises(ValueError):
            fn("pallas")


@pytest.mark.cuda
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 8, 4), (7, 130, 70), (6, 2048, 4096), (192, 8192, 2048)])
def test_cuda_kernel_bit_identical_to_plain(cuda, codec, dtype, shape):
    m, k, n = shape
    x, packed, col = _case(m + n, m, k, n, codec)
    tx = torch.from_numpy(x).to(cuda, getattr(torch, dtype))
    tp, tc = torch.from_numpy(packed).to(cuda), torch.from_numpy(col).to(cuda)
    before = tm.KERNEL.launches
    got = tm.ternary_matmul_actq(tx, tp, tc, k=k, codec=codec)
    torch.cuda.synchronize()
    assert tm.KERNEL.launches == before + 1
    assert torch.equal(got, tm.ternary_matmul_actq_plain(tx, tp, tc, k, codec))


@pytest.mark.cuda
@pytest.mark.parametrize("codec, shape", [
    (codec, shape) for codec in CODECS
    for shape in [(1, 8, 4), (7, 130, 70), (6, 2048, 4096), (192, 8192, 2048)]]
    + [("pack2", (6, 18432, 7168)), ("pack2", (192, 18432, 7168))]
    + [("pack243", (6, k, n)) for k, n in DEEPSEEK_SHAPES]
    + [("pack243", (192, 16384, 7168)), ("pack243", (192, 18432, 7168))]
    + [("pack2", (6, 25600, 5120)), ("pack2", (192, 25600, 5120))])
def test_cuda_known_scale_and_int32_kernels_bit_identical(cuda, codec, shape):
    """Kernel 4 against its plain version and against kernel 1 on the raw
    x; kernel 5 against its plain version and the TriMLA oracle. K = 18432
    is deepseek-v3-671b's dense down projection; deepseek-v3-671b's
    projections in pack243 (wo K = 16384 and down K = 18432 past the first
    kernel's pack243 cap of 2944 groups) and qwen3-32b's down projection in
    pack2 (K = 25600, past its 5888-group cap) hold that K-chunked staging
    takes any K."""
    m, k, n = shape
    x, packed, col = _case(m + n + 1, m, k, n, codec)
    tx, tp, tc = (torch.from_numpy(a).to(cuda) for a in (x, packed, col))
    q = act_quant(tx)
    before = (tm.KNOWN_KERNEL.launches, tm.INT32_KERNEL.launches)
    got = tm.ternary_matmul_fused(q.xq, tp, q.scale, tc, k=k, codec=codec)
    acc = tm.ternary_matmul(q.xq, tp, k=k, codec=codec)
    torch.cuda.synchronize()
    assert (tm.KNOWN_KERNEL.launches, tm.INT32_KERNEL.launches) == (before[0] + 1,
                                                                    before[1] + 1)
    assert torch.equal(got, tm.ternary_matmul_fused_plain(q.xq, tp, q.scale, tc, k, codec))
    assert torch.equal(got, tm.ternary_matmul_actq(tx, tp, tc, k=k, codec=codec))
    assert torch.equal(acc, tm.ternary_acc_plain(q.xq, tp, k, codec))
    assert torch.equal(acc, ref.ternary_matmul_ref(q.xq, tp, k, codec))
