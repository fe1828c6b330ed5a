"""RMSNorm in a sum order fixed per row (``repro_torch/kernels/rms_norm.py``,
``csrc/rms_norm.cu``), behind ``models/layers.py::rms_norm``.

On the card PyTorch's reduction lays out its threads, and so each row's
sum order, by the number of rows, and the serving paths normalise a token
at several row counts (a decode step, a chunk wave, a grouped prefill).
The fixed order makes a row's norm a function of that row alone. Against
the reference's XLA ``rms_norm`` the bound is the recorded framework
difference (``tests/test_torch_mla.py::RMS_NORM_ULPS``, 8 ulp); everything
else here is exact. The ``cuda`` tests hold the kernel against the plain
version bit for bit and skip here.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import rms_norm as krms
from repro_torch.models import layers
from test_torch_threads import share_cpu_threads  # noqa: F401 (autouse: torch threads per worker)

RMS_NORM_ULPS = 8
WIDTHS = [2048, 7168, 1536, 512]  # falcon3-1b's d_model; DeepSeek-V3's d_model, q and kv ranks
ROWS = [1, 6, 192, 576]


@pytest.fixture(scope="module")
def jlayers():
    pytest.importorskip("jax")
    from repro.models import layers as jl

    return jl


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _x(seed, m, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)) * rng.uniform(0.1, 10.0, (m, 1))).astype(np.float32)


def _order_model(x, w, eps):
    """The kernel's order per element in numpy f32 scalars."""
    f = np.float32
    m, d = x.shape
    out = np.zeros_like(x)
    for i in range(m):
        lanes = [f(0.0)] * 32
        for lane in range(32):
            for k in range(lane, d, 32):
                lanes[lane] = f(lanes[lane] + f(x[i, k] * x[i, k]))
        for off in (16, 8, 4, 2, 1):
            lanes = [f(lanes[j] + lanes[j ^ off]) for j in range(32)]
        inv = f(f(1.0) / f(np.sqrt(f(f(lanes[0] / f(d)) + f(eps)))))
        out[i] = [f(f(x[i, k] * inv) * w[k]) for k in range(d)]
    return out


@pytest.mark.parametrize("d", [64, 70, 31])
def test_plain_is_the_documented_order(d):
    """The plain version equals the per-element model of the kernel's
    order bit for bit, D a multiple of 32 or not."""
    x = _x(d, 3, d)
    w = (1 + 0.1 * np.random.default_rng(1).standard_normal(d)).astype(np.float32)
    got = krms.rms_norm_plain(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_array_equal(got.numpy(), _order_model(x, w, 1e-6))


@pytest.mark.parametrize("d", WIDTHS)
def test_plain_rows_do_not_depend_on_m(d):
    """Every row of an M = 576 call equals the same row in calls of M = 192,
    6 and 1, bit for bit."""
    x = torch.from_numpy(_x(d, max(ROWS), d))
    w = torch.ones(d)
    full = layers.rms_norm(x, w)
    for m in ROWS[:-1]:
        for start in (0, max(ROWS) - m):
            assert torch.equal(layers.rms_norm(x[start:start + m], w), full[start:start + m])


@pytest.mark.parametrize("d", [2048, 7168])
def test_gap_to_reference_is_bounded(jlayers, d):
    """Within the recorded framework difference of the reference's
    ``rms_norm`` (8 ulp), unit and non-unit weights, signs equal."""
    x = _x(d + 1, 256, d)
    rng = np.random.default_rng(d)
    for w in (np.ones(d, np.float32), (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)):
        import jax.numpy as jnp

        want = np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
        got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy()
        assert np.array_equal(np.sign(got), np.sign(want))
        ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
        assert ulps.max() <= RMS_NORM_ULPS, ulps.max()


def test_layer_norms_route_through_the_kernel_module(monkeypatch):
    """Every norm of a serving step goes through ``kernels/rms_norm.py``
    with the config's ``impl``: falcon3-1b-smoke's prefill makes 2 per layer
    and the final one."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.models.pack import pack_params

    seen = []
    real = layers.rms_norm_k

    def spy(x, w, eps, impl="auto"):
        seen.append(impl)
        return real(x, w, eps, impl=impl)

    monkeypatch.setattr(layers, "rms_norm_k", spy)
    cfg = get_smoke_config("falcon3-1b")
    params = pack_params(T.init_params(cfg, seed=0, device="cpu"), cfg)
    T.prefill(params, cfg, torch.zeros((2, 3), dtype=torch.int32), hot_cap=4, max_len=8)
    assert seen == ["auto"] * (2 * cfg.n_layers + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("d", WIDTHS)
def test_cuda_rms_norm_kernel_bit_identical_to_plain(cuda, d, m, dtype, wdtype):
    """The kernel's output equals the plain version's bit for bit (on the
    card), one launch each."""
    x = torch.from_numpy(_x(d + m, m, d)).to(cuda, getattr(torch, dtype))
    w = (1 + 0.1 * torch.randn(d, generator=torch.Generator().manual_seed(d))).to(
        cuda, getattr(torch, wdtype))
    before = krms.KERNEL.launches
    got = krms.rms_norm(x, w, 1e-6)
    want = krms.rms_norm(x, w, 1e-6, impl="plain")
    torch.cuda.synchronize()
    assert krms.KERNEL.launches == before + 1
    assert got.dtype == x.dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDTHS)
def test_cuda_rms_norm_rows_do_not_depend_on_m(cuda, d):
    """Row i of an M = 576 launch equals row i launched alone, and the
    CPU's plain version, bit for bit."""
    x = torch.from_numpy(_x(d, 576, d))
    w = torch.ones(d)
    xc, wc = x.to(cuda), w.to(cuda)
    full = krms.rms_norm(xc, wc)
    rows = torch.cat([krms.rms_norm(xc[i:i + 1], wc) for i in range(576)])
    torch.cuda.synchronize()
    assert torch.equal(full, rows) and torch.equal(full.cpu(), krms.rms_norm(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(6, 1, 64, 128), (6, 1, 8, 128), (6, 32, 56, 128),
                                   (3, 77, 8, 128)])
def test_cuda_qk_norm_rows_bit_identical_to_plain(cuda, shape, dtype):
    """The qk-norm's rows (qwen3: M = b * s * heads rows of D 128, a q or k
    head each, from a (b, s, heads, 128) projection): the kernel equals the
    plain version bit for bit, one launch, with seeded weights."""
    m, d = int(np.prod(shape[:-1])), shape[-1]
    x = torch.from_numpy(_x(m, m, d).reshape(shape)).to(cuda, getattr(torch, dtype))
    w = (1 + 0.3 * torch.randn(d, generator=torch.Generator().manual_seed(m))).to(cuda)
    before = krms.KERNEL.launches
    got = krms.rms_norm(x, w, 1e-6)
    want = krms.rms_norm(x, w, 1e-6, impl="plain")
    torch.cuda.synchronize()
    assert krms.KERNEL.launches == before + 1
    assert got.shape == x.shape and got.dtype == x.dtype and torch.equal(got, want)
