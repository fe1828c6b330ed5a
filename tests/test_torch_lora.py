"""The quantized LoRA delta in a sum order fixed per output row
(``repro_torch/kernels/lora.py``, ``csrc/lora.cu``), routed through
``core/lora.py::apply``, against the reference's ``repro.core.lora.apply``.

On the card a GEMM library picks its algorithm, and so each row's sum
order, by the number of rows; the LoRA products then gave the same token
another delta in a grouped prefill (M = group x prompt), a chunk wave
(M = slots x C) and a decode step (M = slots), and at falcon3-1b's width
chunked and grouped admission gave other greedy tokens. The fixed order
makes a row's delta a function of that row alone, on the CPU (the plain
version, tested here) and on the card (the kernel, held against the plain
version bit for bit by the ``cuda`` tests, which skip here).

Against the reference, whose XLA product sums in another order, the delta
agrees to TOL = 2e-5 (f32, K up to 128 at the smoke widths); everything
else here is exact.
"""

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import lora
from repro_torch.kernels import lora as klora
from repro_torch.models import transformer as T
from repro_torch.models.pack import pack_params
from test_torch_threads import share_cpu_threads  # noqa: F401 (autouse: torch threads per worker)

TOL = dict(rtol=2e-5, atol=2e-5)
# falcon3-1b's adapters (K, N) at rank 16: lora_v, lora_o, lora_down
FALCON_SHAPES = [(2048, 1024), (2048, 2048), (8192, 2048)]
ROWS = [1, 6, 192, 576]


@pytest.fixture(scope="module")
def jlora():
    pytest.importorskip("jax")
    from repro.core import lora as jl

    return jl


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _leaf(seed, k, n, r, b_scale=0.02):
    """LoRA factors with B filled (it is zero at init) and an input."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((k, r)) * r ** -0.5).astype(np.float32)
    b = (rng.standard_normal((r, n)) * b_scale).astype(np.float32)
    return a, b


def _smoke_shapes():
    cfg = get_smoke_config("falcon3-1b")
    hd = cfg.resolved_head_dim
    return cfg.bitnet.lora_rank, [(cfg.d_model, cfg.n_kv_heads * hd),
                                  (cfg.n_heads * hd, cfg.d_model), (cfg.d_ff, cfg.d_model)]


def _order_model(xq, aq, bq, scale):
    """The kernel's order written out per element in numpy f32 scalars:
    lane L sums x[k] a[k, r] for k = L, L + 32, ... from +0.0, the xor
    butterfly over the lanes, then out[n] = sum_r t[r] b[r, n] from +0.0,
    times the scale."""
    f = np.float32
    m, k = xq.shape
    r, n = bq.shape
    out = np.zeros((m, n), np.float32)
    for i in range(m):
        t = np.zeros(r, np.float32)
        for j in range(r):
            lanes = [f(0.0)] * 32
            for lane in range(32):
                for kk in range(lane, k, 32):
                    lanes[lane] = f(lanes[lane] + f(xq[i, kk] * aq[kk, j]))
            for off in (16, 8, 4, 2, 1):
                lanes = [f(lanes[x] + lanes[x ^ off]) for x in range(32)]
            t[j] = lanes[0]
        for c in range(n):
            o = f(0.0)
            for j in range(r):
                o = f(o + f(t[j] * bq[j, c]))
            out[i, c] = f(o * f(scale))
    return out


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("m", [1, 6, 40])
def test_apply_matches_reference(jlora, which, m):
    """``lora.apply`` (fake-quant of A, B and x, then the fixed-order
    products) against the reference's ``lora.apply`` at falcon3-1b-smoke's
    three adapter shapes: TOL."""
    import jax.numpy as jnp

    r, shapes = _smoke_shapes()
    k, n = shapes[which]
    a, b = _leaf(10 * which + m, k, n, r)
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    want = np.asarray(jlora.apply({"a": jnp.asarray(a), "b": jnp.asarray(b)}, jnp.asarray(x),
                                  alpha=2.0 * r, weight_bits=6, act_bits=8))
    got = lora.apply({"a": interop.to_tensor(a), "b": interop.to_tensor(b)},
                     interop.to_tensor(x), alpha=2.0 * r, weight_bits=6, act_bits=8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("k,n", [(64, 32), (70, 24), (31, 8)])
def test_plain_delta_is_the_documented_order(k, n):
    """The plain version equals the per-element model of the kernel's order
    bit for bit, K a multiple of 32 or not (the padded lanes add +0.0)."""
    rng = np.random.default_rng(k + n)
    xq = rng.standard_normal((3, k)).astype(np.float32)
    aq = rng.standard_normal((k, 4)).astype(np.float32)
    bq = rng.standard_normal((4, n)).astype(np.float32)
    got = klora.lora_delta_plain(torch.from_numpy(xq), torch.from_numpy(aq),
                                 torch.from_numpy(bq), 2.0)
    np.testing.assert_array_equal(got.numpy(), _order_model(xq, aq, bq, 2.0))


@pytest.mark.parametrize("k,n", FALCON_SHAPES)
def test_plain_rows_do_not_depend_on_m(k, n):
    """At falcon3-1b's adapter shapes, every row of an M = 576 call equals
    the same row in calls of M = 192, 6 and 1, bit for bit."""
    a, b = _leaf(k + n, k, n, 16)
    x = np.random.default_rng(n).standard_normal((max(ROWS), k)).astype(np.float32)
    xt, at, bt = torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b)
    full = klora.lora_delta_plain(xt, at, bt, 2.0)
    for m in ROWS[:-1]:
        for start in (0, max(ROWS) - m):
            part = klora.lora_delta_plain(xt[start:start + m], at, bt, 2.0)
            assert torch.equal(part, full[start:start + m]), (m, start)


def test_plain_delta_close_to_float64():
    """The fixed order is a sum order and nothing else: within f32 rounding
    of the float64 product at falcon3-1b's widest adapter."""
    k, n = 8192, 2048
    a, b = _leaf(3, k, n, 16)
    x = np.random.default_rng(4).standard_normal((6, k)).astype(np.float32)
    got = klora.lora_delta_plain(torch.from_numpy(x), torch.from_numpy(a),
                                 torch.from_numpy(b), 2.0)
    want = (x.astype(np.float64) @ a.astype(np.float64)) @ b.astype(np.float64) * 2.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_apply_routes_the_products_through_the_kernel_module(monkeypatch):
    """``lora.apply`` hands its two products to ``lora_delta`` with the
    fake-quantized factors, the alpha / r scale and the caller's ``impl``,
    and the projections pass ``cfg.bitnet.impl`` down to it."""
    seen = []
    real = lora.lora_delta

    def spy(xq, aq, bq, scale, impl="auto"):
        seen.append((tuple(xq.shape), tuple(aq.shape), tuple(bq.shape), scale, impl))
        return real(xq, aq, bq, scale, impl=impl)

    monkeypatch.setattr(lora, "lora_delta", spy)
    a, b = _leaf(0, 64, 32, 4)
    x = torch.randn(5, 64, generator=torch.Generator().manual_seed(0))
    lora.apply({"a": torch.from_numpy(a), "b": torch.from_numpy(b)}, x, alpha=8.0, impl="plain")
    assert seen == [((5, 64), (64, 4), (4, 32), 2.0, "plain")]
    seen.clear()
    cfg = get_smoke_config("falcon3-1b")
    params = pack_params(T.init_params(cfg, seed=0, device="cpu"), cfg)
    T.prefill(params, cfg, torch.zeros((2, 3), dtype=torch.int32), hot_cap=4, max_len=8)
    n_adapters = cfg.n_layers * len(cfg.bitnet.lora_targets)
    assert len(seen) == n_adapters and {s[-1] for s in seen} == {"auto"}


def test_lm_head_rows_padding_keeps_the_logits():
    """``T.prefill(logit_rows=)`` (the engine runs every lm_head at its slot
    count) pads the lm_head's input with zero rows and returns the
    prompts' logits: the unpadded prefill's to TOL on the CPU, whose GEMM
    order may also depend on M."""
    cfg = get_smoke_config("falcon3-1b")
    params = pack_params(T.init_params(cfg, seed=1, device="cpu"), cfg)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 7)),
                           dtype=torch.int32)
    plain, _ = T.prefill(params, cfg, toks, hot_cap=4, max_len=16)
    padded, _ = T.prefill(params, cfg, toks, hot_cap=4, max_len=16, logit_rows=8)
    assert padded.shape == plain.shape == (3, cfg.vocab_size)
    torch.testing.assert_close(padded, plain, **TOL)


# ---------------------------------------------------------------------------
# the CUDA kernel against its plain version (card only)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,n", FALCON_SHAPES)
def test_cuda_lora_kernel_bit_identical_to_plain(cuda, k, n, m, dtype):
    """falcon3-1b's three adapter shapes at rank 16, M = 1, 6, 192 and 576,
    f32 and bf16: the kernel's output equals the plain version's bit for
    bit, with one launch."""
    dt = getattr(torch, dtype)
    a, b = _leaf(k + n + m, k, n, 16)
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    xt, at, bt = (torch.from_numpy(t).to(cuda, dt) for t in (x, a, b))
    before = klora.KERNEL.launches
    got = klora.lora_delta(xt, at, bt, 2.0)
    want = klora.lora_delta(xt, at, bt, 2.0, impl="plain")
    torch.cuda.synchronize()
    assert klora.KERNEL.launches == before + 1
    assert got.dtype == dt and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", FALCON_SHAPES)
def test_cuda_lora_kernel_rows_do_not_depend_on_m(cuda, k, n):
    """Row i of an M = 576 launch equals the same row launched alone
    (M = 1), bit for bit, for every row i."""
    a, b = _leaf(k, k, n, 16)
    x = torch.from_numpy(np.random.default_rng(k).standard_normal((576, k)).astype(np.float32))
    xt, at, bt = (t.to(cuda) for t in (x, torch.from_numpy(a), torch.from_numpy(b)))
    full = klora.lora_delta(xt, at, bt, 2.0)
    rows = torch.cat([klora.lora_delta(xt[i:i + 1], at, bt, 2.0) for i in range(576)])
    torch.cuda.synchronize()
    assert torch.equal(full, rows)


@pytest.mark.cuda
def test_cuda_lora_kernel_refuses_what_it_does_not_take(cuda):
    """A CPU operand, mixed dtypes or a rank past 32 raise; nothing falls
    back to the plain version on the card."""
    x = torch.zeros((2, 64), device=cuda)
    with pytest.raises(ValueError):
        klora.lora_delta(x, torch.zeros((64, 4)), torch.zeros((4, 8), device=cuda), 1.0)
    with pytest.raises(TypeError):
        klora.lora_delta(x, torch.zeros((64, 4), device=cuda, dtype=torch.bfloat16),
                         torch.zeros((4, 8), device=cuda), 1.0)
    with pytest.raises(ValueError):
        klora.lora_delta(x, torch.zeros((64, 33), device=cuda),
                         torch.zeros((33, 8), device=cuda), 1.0)


def test_kernel_source_is_built_with_the_others():
    """``csrc/lora.cu`` is one of the sources ``build_all`` compiles."""
    from repro_torch.kernels import build

    assert "lora" in build.KERNEL_SOURCES and (build.CSRC_DIR / "lora.cu").exists()
    assert klora.KERNEL.source == "lora" and klora.KERNEL.symbol == "lora_delta"


def test_falcon_shapes_are_the_configs_adapters():
    """FALCON_SHAPES are falcon3-1b's lora_v, lora_o and lora_down at rank 16."""
    cfg = get_config("falcon3-1b")
    hd = cfg.resolved_head_dim
    assert cfg.bitnet.lora_rank == 16 and cfg.bitnet.lora_targets == ("v", "o", "down")
    assert FALCON_SHAPES == [(cfg.d_model, cfg.n_kv_heads * hd), (cfg.n_heads * hd, cfg.d_model),
                             (cfg.d_ff, cfg.d_model)]
