"""Port parity for the act-quant-prologue ternary matmul
(repro_torch.kernels.ternary_matmul, core.bitlinear) against the
reference's Pallas kernel ``ternary_matmul_actq_pallas`` (interpret mode)
and its XLA path.

Everything here is integer arithmetic plus one f32 epilogue in the same
order, so the contract is BIT-IDENTITY: the int32 accumulator, and the
float output of the plain version against both reference paths, for
pack2 / pack243, A8 / A4, f32 / bf16 activations and ragged M, N, K.
The CUDA kernel itself runs only on a card: the ``cuda``-marked tests
hold it against the plain version there and skip here.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.core import bitlinear, packing
from repro_torch.kernels import ternary_matmul as tm

CODECS = ["pack2", "pack243"]


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import bitlinear as jbitlinear
    from repro.core import packing as jpacking
    from repro.kernels import ops as jops
    from repro.kernels import ref as jkref
    from repro.models import pack as jpack

    return types.SimpleNamespace(jnp=jnp, bitlinear=jbitlinear, packing=jpacking,
                                 ops=jops, ref=jkref, pack=jpack)


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

    def carry(leaf):
        if hasattr(leaf, "splits"):
            return bitlinear.FusedPackedLinear(
                torch.from_numpy(np.asarray(leaf.packed).copy()),
                torch.from_numpy(np.asarray(leaf.scale).copy()), leaf.k, leaf.codec, leaf.splits)
        return bitlinear.PackedLinear(torch.from_numpy(np.asarray(leaf.packed).copy()),
                                      torch.from_numpy(np.asarray(leaf.scale).copy()),
                                      leaf.k, leaf.codec)

    for jl in jleaves + [jfused]:
        want = np.asarray(jref.bitlinear.packed_matmul(jl, jref.jnp.asarray(x), impl="xla"))
        got = bitlinear.packed_matmul(carry(jl), torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), want)


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
