"""Port parity for the fresh causal flash prefill and the attention layer
around it (repro_torch.kernels.flash_prefill, models.attention,
core.kv_cache.fill_fresh) against the reference's ``_flash_prefill``
Pallas kernel (interpret mode, ``cache=None``) and its XLA path.

The emitted v is a copy and must match bit for bit; the attention output
and the rotated k are f32 arithmetic in another order (and cos / sin
differ by an ulp between the frameworks), held to TOL = 2e-5. The CUDA
kernel runs only on a card: the ``cuda``-marked test holds it against the
plain version there, bit for bit, and skips here.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.core import kv_cache as kvc
from repro_torch.kernels import flash_prefill as fp
from repro_torch.models import attention as tattn

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


def test_only_the_fresh_form_is_ported():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 4, 2, 1, 16))
    with pytest.raises(NotImplementedError):
        fp.flash_prefill_attention(q, k, v, cache=kvc.init_cache(1, 2, 2, (1, 16)))
    with pytest.raises(NotImplementedError):
        fp.flash_prefill_attention(q, k, v, emit_kv=False)


@pytest.mark.cuda
@pytest.mark.parametrize("s,dtype", [(32, "float32"), (77, "float32"), (128, "float32"),
                                     (32, "bfloat16")])
def test_cuda_kernel_bit_identical_to_plain(cuda, s, dtype):
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
