"""Port parity for the packed-trit codecs and ternary quantization
(repro_torch.core.packing / ternary, repro_torch.models.pack against
repro.core / repro.models.pack), and the port's import boundary.

Integer stages must be bit-identical: codec bytes (including the pack243
zero code 121), act-quant codes and scales. The float absmean of
``pack_params`` is summed in another order than the reference's, so its
scale is held to two f32 ulps (the largest difference measured on these
weights; each framework's f32 mean is itself up to two ulps off the exact
mean) and trits may differ only where |w| / scale sits on the rounding
boundary.

Inputs are made with numpy from a seed; JAX-side imports go through
``pytest.importorskip`` inside a fixture, so the file also collects on a
machine without JAX.
"""

import ast
import pathlib
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import packing, ternary
from repro_torch.models import pack as tpack
from test_torch_threads import share_cpu_threads  # noqa: F401 (autouse: torch threads per worker)

REPO = pathlib.Path(__file__).resolve().parent.parent
CODECS = ["pack2", "pack243"]


@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import packing as jpacking
    from repro.core import ternary as jternary
    from repro.models import pack as jpack

    return types.SimpleNamespace(jnp=jnp, packing=jpacking, ternary=jternary, pack=jpack)


def _trits(rng, shape):
    return rng.integers(-1, 2, shape).astype(np.int8)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("k", [1, 4, 5, 7, 20, 129])
def test_codec_bytes_identical(jref, codec, k):
    w = _trits(np.random.default_rng(k), (k, 6))
    jfn = jref.packing.pack2 if codec == "pack2" else jref.packing.pack243
    ref = np.asarray(jfn(jref.jnp.asarray(w)))
    got = packing.pack(torch.from_numpy(w), codec).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(packing.unpack(torch.from_numpy(ref.copy()), codec, k).numpy(), w)


def test_pack243_zero_code_is_121(jref):
    w = np.zeros((10, 3), np.int8)
    got = packing.pack243(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, np.full((2, 3), 121, np.uint8))
    np.testing.assert_array_equal(got, np.asarray(jref.packing.pack243(jref.jnp.asarray(w))))
    assert packing.ZERO_CODE_243 == 121


@pytest.mark.parametrize("codec", CODECS)
def test_unpack_every_byte_value(jref, codec):
    """Every byte value decodes like the reference (incl. pack243 bytes
    243..255, which no encoder writes)."""
    b = np.arange(256, dtype=np.uint8)[:, None]
    jfn = jref.packing.unpack2 if codec == "pack2" else jref.packing.unpack243
    np.testing.assert_array_equal(packing.unpack(torch.from_numpy(b), codec).numpy(),
                                  np.asarray(jfn(jref.jnp.asarray(b))))


def test_decode_table_and_padded_k(jref):
    np.testing.assert_array_equal(packing.decode_table_243(), jref.packing.decode_table_243())
    for k in range(1, 30):
        for g in (4, 5):
            assert packing.padded_k(k, g) == jref.packing.padded_k(k, g)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_act_quant_bit_identical(jref, bits, dtype):
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((9, 257)) * 3).astype(np.float32)
    x[0] = 0.0  # all-zero row: scale qmax / EPS, codes 0
    qmax = 127.0 if bits == 8 else 7.0
    x[1] = (np.arange(257) % 7 - 3) + 0.5  # exact halves at scale 1: ties
    x[1, 0] = qmax
    jx = jref.jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = jref.ternary.act_quant(jx, bits=bits)
    got = ternary.act_quant(tx, bits=bits)
    np.testing.assert_array_equal(got.xq.numpy(), np.asarray(ref.xq))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))


def test_act_quant_rejects_other_widths():
    with pytest.raises(ValueError):
        ternary.act_quant(torch.zeros(2, 4), bits=6)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("shape", [(64, 48), (257, 130)])
def test_pack_weight_within_two_ulps(jref, codec, shape):
    """``pack_weight`` from the same float weight: scale within two f32
    ulps of the reference's; trits differ only at the rounding boundary."""
    w = np.random.default_rng(shape[0]).standard_normal(shape).astype(np.float32)
    ref = jref.pack._pack_weight(jref.jnp.asarray(w), codec)
    got = tpack.pack_weight(torch.from_numpy(w), codec)
    s_ref, s_got = float(ref.scale), float(got.scale)
    assert abs(s_ref - s_got) <= 2 * np.spacing(np.float32(s_ref))
    t_ref = np.asarray((jref.packing.unpack2 if codec == "pack2"
                        else jref.packing.unpack243)(ref.packed, k=shape[0]))
    t_got = packing.unpack(got.packed, codec, shape[0]).numpy()
    diff = t_ref != t_got
    assert np.all(np.abs(np.abs(w[diff]) / s_ref - 0.5) < 1e-6)


def test_pack_params_structure_matches_reference():
    """The fusion pass builds wqkv / wgu with the reference's splits and
    per-column scales; packing a packed tree is a no-op."""
    from repro_torch.models import transformer as T

    cfg = get_smoke_config("falcon3-1b")
    packed = tpack.pack_params(T.init_params(cfg, seed=0, device="cpu"), cfg)
    blk = packed["blocks"][0]
    h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    assert set(blk["attn"]) == {"ln", "wqkv", "wo", "lora_v", "lora_o"}
    assert set(blk["mlp"]) == {"ln", "wgu", "down", "lora_down"}
    assert blk["attn"]["wqkv"].splits == (h * hd, g * hd, g * hd)
    assert blk["mlp"]["wgu"].splits == (cfg.d_ff, cfg.d_ff)
    assert blk["attn"]["wqkv"].scale.shape == (h * hd + 2 * g * hd,)
    again = tpack.pack_params(packed, cfg)
    assert again["blocks"][0]["attn"]["wqkv"] is blk["attn"]["wqkv"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_no_jax_and_no_reference_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    bad = [(str(p.relative_to(REPO)), name) for p in files for name in _imports(p)
           if name.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")]
    assert not bad, bad
