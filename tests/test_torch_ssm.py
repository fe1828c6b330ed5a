"""The SSM and hybrid families on the port: mamba2-130m (a stack of Mamba2
blocks, attention-free) and zamba2-7b (groups of Mamba2 blocks, each
followed by one shared attention + MLP block with a per-group v adapter),
at their smoke sizes against the reference's JAX package, from weights
the reference packed and ``repro_torch.interop`` carried across.

The reference leaves the Mamba2 block to XLA, so the port's block is plain
PyTorch around the packed projections: f32 arithmetic in another order,
held to TOL = 1e-5 (the conv, the SSD scan, the returned states) and
LAYER_TOL = 1e-4 (a block's output, through its int8 act-quant and the
packed projections). ``attention_full`` (the hybrid's prefill attention)
is held to LAYER_TOL too. The engine must give the JAX engine's greedy
tokens and per-request ledgers exactly: ``Engine.generate`` and a
mixed-length ``serve`` (a prompt of 2 tokens, shorter than d_conv - 1,
among them); zamba2 at head dim 112 (kernel 2's new width, its plain
version on the CPU) gives the reference's tokens with its prefill
evaluated op by op. The reference's LoRA factors B start at zero; every
adapter here (``lora_out``, the shared block's, ``shared_lora_v``) gets
seeded non-zero B factors before packing, so the adapters are tested.

The engine gates: ``paged=True`` raises, speculation warns and decodes
plainly, ``prefill_chunk > 0`` admits grouped. ``cuda``-marked tests hold
kernel 2 at d 112 and kernel 1 at the families' projection shapes against
their plain versions on a card, bit for bit, and skip here; on the CPU a
model of kernel 2's padded lane layout at d 112 is held to the plain
version bit for bit.
"""

import dataclasses
import types
import warnings

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import dr_edram
from repro_torch.core import kv_cache as kvc
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ternary_matmul as tm
from repro_torch.models import attention as attn
from repro_torch.models import pack as pack_lib
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.layers import apply_rope
from repro_torch.serving import speculative as spec_lib
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request
from test_torch_flash_decode import _decode_inputs, _decode_schedule_model, _poisoned_cache
from test_torch_threads import share_cpu_threads  # noqa: F401 (autouse: torch threads per worker)

TOL = dict(rtol=1e-5, atol=1e-5)
LAYER_TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = ["mamba2-130m", "zamba2-7b"]
KW = dict(hot_cap=4, max_len=48)
NEW = 16
MIXED = (9, 2, 5, 9, 2)  # the mixed serve's prompt lengths, 6 new tokens each
D112 = dict(head_dim=112, n_heads=2, n_kv_heads=2)
D112_NEW = 8  # new tokens of the head-dim-112 run


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import bitlinear as jbitlinear
    from repro.models import attention as jattn
    from repro.models import pack as jpack
    from repro.models import ssm as jssm
    from repro.models import transformer as jT
    from repro.serving import engine as jengine
    from repro.serving.scheduler import Request as JRequest

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs, bitlinear=jbitlinear,
                                 attn=jattn, pack=jpack, ssm=jssm, T=jT, engine=jengine,
                                 Request=JRequest, models={}, runs={})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _numpy_tree(jref, tree):
    if isinstance(tree, (jref.bitlinear.PackedLinear, jref.bitlinear.FusedPackedLinear)):
        out = dict(packed=np.asarray(tree.packed), scale=np.asarray(tree.scale),
                   k=tree.k, codec=tree.codec)
        if isinstance(tree, jref.bitlinear.FusedPackedLinear):
            out["splits"] = tree.splits
        if tree.crc is not None:
            out.update(wsum=np.asarray(tree.wsum), crc=int(tree.crc))
        return out
    if isinstance(tree, dict):
        return {k: _numpy_tree(jref, v) for k, v in tree.items()}
    return np.asarray(tree)


def _with_lora_b(jref, params, seed):
    """Every LoRA adapter's B factor drawn from N(0, 0.05^2) (the init's
    zeros would leave the adapters untested)."""
    rng = np.random.default_rng(seed)

    def walk(t, name=""):
        if isinstance(t, dict):
            if "lora_" in name:
                b = rng.normal(0.0, 0.05, t["b"].shape).astype(np.float32)
                return {"a": t["a"], "b": jref.jnp.asarray(b)}
            return {k: walk(v, k) for k, v in t.items()}
        return t

    return walk(params)


def _models(jref, name, **over):
    """(jcfg, jpacked, cfg, tparams) of ``name``'s smoke config (fields
    replaced by ``over`` in both packages), built once per module: the
    reference's PRNGKey(0) init with seeded LoRA B factors, packed with
    integrity stamps, carried across."""
    key = (name, tuple(sorted(over.items())))
    if key not in jref.models:
        jcfg = dataclasses.replace(jref.configs.get_smoke_config(name), **over)
        params = _with_lora_b(jref, jref.T.init_params(jref.jax.random.PRNGKey(0), jcfg), 1)
        jpacked = jref.pack.pack_params(params, jcfg, integrity=True)
        jref.models[key] = types.SimpleNamespace(
            jcfg=jcfg, jpacked=jpacked, cfg=dataclasses.replace(get_smoke_config(name), **over),
            tparams=interop.params_from_reference(_numpy_tree(jref, jpacked)))
    return jref.models[key]


def _prompts(cfg):
    return np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)


def _mixed(cfg):
    rng = np.random.default_rng(3)
    return [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=6) for i, n in enumerate(MIXED)]


def _reference_run(jref, name, **over):
    """The JAX engine's generate of 3 x (8 + 16) and its serve of the MIXED
    requests over 3 slots: run once per module and config."""
    key = (name, tuple(sorted(over.items())))
    if key not in jref.runs:
        m = _models(jref, name, **over)
        eng = jref.engine.Engine(m.jcfg, m.jpacked, slots=3, **KW)
        res = eng.generate(jref.jnp.asarray(_prompts(m.cfg)), max_new_tokens=NEW)
        fin = eng.serve([jref.Request(rid=r.rid, tokens=r.tokens, max_new_tokens=6)
                         for r in _mixed(m.cfg)])
        jref.runs[key] = types.SimpleNamespace(
            tokens=np.asarray(res.tokens), traffic=res.traffic,
            token_bytes=eng._kv_token_bytes(), serve={f.rid: f for f in fin})
    return jref.runs[key]


def _block(jref, m, stack="blocks"):
    """The first Mamba2 block of the reference's stack and of the port's."""
    if stack == "mamba_groups":
        return (jref.jax.tree_util.tree_map(lambda a: a[0, 0], m.jpacked[stack]),
                m.tparams[stack][0][0])
    return jref.jax.tree_util.tree_map(lambda a: a[0], m.jpacked[stack]), m.tparams[stack][0]


# ---------------------------------------------------------------------------
# configs, layouts, leaves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_configs_match_reference(jref, name):
    """Every field the port keeps equals the reference's, the SSM config
    and the smoke shrink's SSM / hybrid rules included."""

    def same(mine, theirs):
        for f in dataclasses.fields(mine):
            a, b = getattr(mine, f.name), getattr(theirs, f.name)
            if dataclasses.is_dataclass(a):
                same(a, b)
            else:
                assert a == b, f.name

    for mine, theirs in ((get_config(name), jref.configs.get_config(name)),
                         (get_smoke_config(name), jref.configs.get_smoke_config(name))):
        same(mine, theirs)


def test_hybrid_layout_and_packed_leaves_match_reference(jref):
    """zamba2's port tree: 2 groups of 2 blocks, a tail of 1, one shared
    block, one v adapter per group; the packed leaves the SDC plane walks
    are the reference's paths and stacked sizes (the stamps checked on the
    way in), the Mamba2 projections unfused, the rest float."""
    m = _models(jref, "zamba2-7b")
    tp = m.tparams
    assert [len(g) for g in tp["mamba_groups"]] == [2, 2] and len(tp["mamba_tail"]) == 1
    assert len(tp["shared_lora_v"]) == 2 and "wqkv" in tp["shared"]["attn"]
    blk = tp["mamba_groups"][1][0]
    assert {k for k, v in blk.items() if hasattr(v, "packed")} == {"in_proj", "out_proj"}
    assert all(isinstance(blk[k], torch.Tensor)
               for k in ("ln", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias", "gate_ln"))
    np.testing.assert_array_equal(tp["shared_lora_v"][1]["b"].numpy(),
                                  np.asarray(m.jpacked["shared_lora_v"]["b"][1]))
    for name in NAMES:
        mm = _models(jref, name)
        mine = [(p, s.size) for p, s in pack_lib.iter_packed_leaves(mm.tparams)]
        theirs = [(p, int(np.asarray(leaf.packed).nbytes))
                  for p, leaf in jref.pack.iter_packed_leaves(mm.jpacked)]
        assert mine == theirs and pack_lib.verify_packed(mm.tparams) == []
    own = T.init_params(m.cfg, seed=0, device="cpu", pack=True)
    assert ([p for p, _ in pack_lib.iter_packed_leaves(own)]
            == [p for p, _ in pack_lib.iter_packed_leaves(tp)])


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------


def test_causal_conv_full_matches_reference(jref):
    rng = np.random.default_rng(0)
    xc = rng.standard_normal((3, 11, 20)).astype(np.float32)
    w = rng.standard_normal((20, 4)).astype(np.float32)
    b = rng.standard_normal((20,)).astype(np.float32)
    want = jref.ssm._causal_conv_full(*(jref.jnp.asarray(a) for a in (xc, w, b)))
    got = ssm._causal_conv_full(*(torch.from_numpy(a) for a in (xc, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # causal: the first row sees only itself (left padding of k - 1)
    np.testing.assert_allclose(got[:, 0].numpy(), xc[:, 0] * w[:, 3] + b, **TOL)


@pytest.mark.parametrize("length", [8, 20, 13, 64])
def test_ssd_chunked_matches_reference(jref, length):
    """The chunked SSD scan at the smoke chunk of 8: one chunk, 5 chunks of
    4 (the chunk halves until it divides), chunks of 1 (a prime length)
    and 8 chunks; from zero and from a carried-in state."""
    cfg = get_smoke_config("zamba2-7b")
    jcfg = jref.configs.get_smoke_config("zamba2-7b")
    b, g, r, p, n = 2, 2, 8, 8, 16
    rng = np.random.default_rng(length)
    xh = rng.standard_normal((b, length, g, r, p)).astype(np.float32)
    dt_a = -rng.uniform(0.01, 1.5, (b, length, g, r)).astype(np.float32)
    bm, cm = (rng.standard_normal((b, length, g, n)).astype(np.float32) for _ in range(2))
    s0 = rng.standard_normal((b, g, r, p, n)).astype(np.float32)
    for init in (None, s0):
        jy, jst = jref.ssm._ssd_chunked(
            *(jref.jnp.asarray(a) for a in (xh, dt_a, bm, cm)), jcfg,
            None if init is None else jref.jnp.asarray(init))
        ty, tst = ssm._ssd_chunked(*(torch.from_numpy(a) for a in (xh, dt_a, bm, cm)), cfg,
                                   None if init is None else torch.from_numpy(init))
        assert torch.isfinite(ty).all() and tst.dtype == torch.float32
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
        np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **LAYER_TOL)


@pytest.mark.parametrize("name,stack", [("mamba2-130m", "blocks"),
                                        ("zamba2-7b", "mamba_groups")])
def test_mamba_block_full_then_decode_matches_reference(jref, name, stack):
    """``apply_mamba_full`` with its returned states (the SSM state f32, the
    conv state the last d_conv - 1 raw conv inputs), then 5 decode steps
    through ``transformer._mamba_decode`` with slot 1 inactive, whose state
    must stay as it was (the reference's ``_mask_state``)."""
    m = _models(jref, name)
    jb, tb = _block(jref, m, stack)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 8, m.cfg.d_model)).astype(np.float32)
    full = jref.jax.jit(lambda b, h: jref.ssm.apply_mamba_full(b, h, m.jcfg, "packed",
                                                               return_state=True))
    step = jref.jax.jit(lambda b, h, st: jref.ssm.apply_mamba_decode(b, h, m.jcfg, "packed", st))
    jy, jst = full(jb, jref.jnp.asarray(x))
    ty, tst = ssm.apply_mamba_full(tb, torch.from_numpy(x), m.cfg, return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
    np.testing.assert_allclose(tst.ssm.numpy(), np.asarray(jst["ssm"]), **LAYER_TOL)
    np.testing.assert_allclose(tst.conv.numpy(), np.asarray(jst["conv"]), **TOL)
    assert tst.conv.shape[1] == m.cfg.ssm.d_conv - 1 and tst.ssm.dtype == torch.float32
    state = ssm.SSMState(*(t[None].clone() for t in tst))  # a stack of one block
    jstate = jst
    active = np.array([True, False, True])
    for _ in range(5):
        xd = rng.standard_normal((3, m.cfg.d_model)).astype(np.float32)
        jyd, jnew = step(jb, jref.jnp.asarray(xd), jstate)
        jstate = jref.jax.tree_util.tree_map(
            lambda n, o: jref.jnp.where(jref.jnp.asarray(active).reshape(
                (-1,) + (1,) * (n.ndim - 1)), n, o), jnew, jstate)
        before = [t[0, 1].clone() for t in state]
        tyd = T._mamba_decode([tb], m.cfg, torch.from_numpy(xd), state,
                              torch.from_numpy(active))
        np.testing.assert_allclose(tyd.numpy(), np.asarray(jyd), **LAYER_TOL)
        np.testing.assert_allclose(state.ssm[0].numpy(), np.asarray(jstate["ssm"]), **LAYER_TOL)
        np.testing.assert_allclose(state.conv[0].numpy(), np.asarray(jstate["conv"]), **TOL)
        assert all(torch.equal(t[0, 1], bb) for t, bb in zip(state, before))


def test_short_prompt_conv_state_is_the_references(jref):
    """A prompt shorter than d_conv - 1 returns fewer conv rows (the
    reference's slice from a negative start); the decode step refuses that
    state, as the reference's does."""
    m = _models(jref, "mamba2-130m")
    jb, tb = _block(jref, m)
    x = np.random.default_rng(6).standard_normal((2, 2, m.cfg.d_model)).astype(np.float32)
    _, jst = jref.ssm.apply_mamba_full(jb, jref.jnp.asarray(x), m.jcfg, "packed",
                                       return_state=True)
    _, tst = ssm.apply_mamba_full(tb, torch.from_numpy(x), m.cfg, return_state=True)
    assert tst.conv.shape == np.asarray(jst["conv"]).shape == (2, 1, 160)
    np.testing.assert_allclose(tst.conv.numpy(), np.asarray(jst["conv"]), **TOL)
    with pytest.raises(RuntimeError):
        ssm.apply_mamba_decode(tb, torch.zeros((2, m.cfg.d_model)), m.cfg, tst)


@pytest.mark.parametrize("over", [{}, D112])
def test_attention_full_matches_reference(jref, over):
    """The hybrid's prefill attention (projections, RoPE, blockwise
    attention, wo with the adapters) and its rotated k / v for the cache,
    at the smoke heads and at head dim 112."""
    m = _models(jref, "zamba2-7b", **over)
    x = np.random.default_rng(7).standard_normal((3, 8, m.cfg.d_model)).astype(np.float32)
    jp = {**m.jpacked["shared"]["attn"],
          "lora_v": jref.jax.tree_util.tree_map(lambda a: a[1], m.jpacked["shared_lora_v"])}
    jy, (jk, jv) = jref.jax.jit(lambda p, h: jref.attn.attention_full(
        p, h, m.jcfg, "packed", jref.jnp.arange(8), return_kv=True))(jp, jref.jnp.asarray(x))
    tp = T._shared_block(m.tparams, 1)["attn"]
    ty, (tk, tv) = attn.attention_full(tp, torch.from_numpy(x), m.cfg, torch.arange(8),
                                       return_kv=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **LAYER_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **LAYER_TOL)
    assert tk.shape == (3, 8, m.cfg.n_kv_heads, m.cfg.resolved_head_dim)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _check_ledgers(got_fin, eng, token_bytes):
    assert eng._kv_token_bytes() == token_bytes
    for f in got_fin:
        if token_bytes:  # the hybrid: its shared block's cache, at the closed form
            closed = dr_edram.closed_form_reduction(f.seq_len, KW["hot_cap"])
            assert abs(f.external_reduction - closed) <= 1e-12
        else:  # attention-free: a token ledger at 0 bytes a token
            assert not any(f.traffic.values()) and f.external_reduction == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_generate_matches_reference_engine(jref, name):
    """Greedy tokens and per-request ledgers of the JAX engine,
    ``weight_loads`` 0, the same again run over run."""
    m, want = _models(jref, name), _reference_run(jref, name)
    eng = Engine(m.cfg, m.tparams, slots=3, device="cpu", **KW)
    got = eng.generate(_prompts(m.cfg), max_new_tokens=NEW)
    np.testing.assert_array_equal(got.tokens.numpy(), want.tokens)
    assert got.traffic == want.traffic and eng.weight_loads == 0
    _check_ledgers(got.finished, eng, want.token_bytes)
    assert all(f.seq_len == 8 + NEW for f in got.finished)
    again = eng.generate(_prompts(m.cfg), max_new_tokens=NEW)
    assert torch.equal(again.tokens, got.tokens) and again.traffic == got.traffic


def test_zamba2_head_dim_112_matches_reference(jref):
    """zamba2 at head dim 112 (2 heads of 112 over d_model 64): the
    shared block's prefill through ``attention_full`` and its decode
    through kernel 2's plain version at d 112, against the reference's
    greedy loop: its prefill evaluated op by op (``jax.disable_jit``), then
    its jitted ``decode_step``. At this seed the reference's compiled
    prefill scan rounds otherwise than its own op-by-op evaluation, and an
    int8 act-quant code flips (prefill logits 0.08 apart), so the JAX
    engine's tokens are not those of the reference evaluated op by op; the
    port evaluates op by op. The ledger is held to the closed form at 2
    bytes a value over the 2 invocations' caches."""
    m = _models(jref, "zamba2-7b", **D112)
    jnp = jref.jnp
    prompts = _prompts(m.cfg)
    with jref.jax.disable_jit():
        logits, cache = jref.T.prefill(m.jpacked, m.jcfg, {"tokens": jnp.asarray(prompts)},
                                       hot_cap=KW["hot_cap"], max_len=KW["max_len"])
    step = jref.jax.jit(lambda p, tok, c: jref.T.decode_step(p, m.jcfg, tok, c))
    want = []
    for _ in range(D112_NEW):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
        logits, cache = step(m.jpacked, tok, cache)
    eng = Engine(m.cfg, m.tparams, slots=3, device="cpu", **KW)
    got = eng.generate(prompts, max_new_tokens=D112_NEW)
    np.testing.assert_array_equal(got.tokens.numpy(), np.stack(want, axis=1))
    assert eng._last_ctx.state.cache["attn"].hot_k.shape[-1] == 112
    _check_ledgers(got.finished, eng, 2 * 2 * 112 * 2 * 2)
    assert eng.weight_loads == 0


@pytest.mark.parametrize("name", NAMES)
def test_mixed_serve_matches_reference_engine(jref, name):
    """A serve of prompts 9 / 2 / 5 / 9 / 2 over 3 slots (grouped
    admission into freed slots; the 2-token prompt's one conv row
    broadcast over the slot's, as the reference's scatter does): every
    request's tokens and ledger equal the JAX engine's."""
    m, want = _models(jref, name), _reference_run(jref, name)
    eng = Engine(m.cfg, m.tparams, slots=3, device="cpu", **KW)
    fin = {f.rid: f for f in eng.serve(_mixed(m.cfg))}
    assert sorted(fin) == sorted(want.serve)
    for rid, f in fin.items():
        np.testing.assert_array_equal(f.tokens, np.asarray(want.serve[rid].tokens))
        assert f.traffic == want.serve[rid].traffic and f.seq_len == want.serve[rid].seq_len
    _check_ledgers(fin.values(), eng, want.token_bytes)


@pytest.mark.parametrize("name", NAMES)
def test_engine_gates(jref, name):
    """As in the reference: a paged engine raises, a speculative one warns
    and decodes without its draft (the same tokens), and ``prefill_chunk >
    0`` admits grouped (no chunk wave)."""
    m, want = _models(jref, name), _reference_run(jref, name)
    with pytest.raises(ValueError, match="paged serving needs chunked prefill"):
        Engine(m.cfg, m.tparams, prefill_chunk=4, paged=True, device="cpu", **KW)
    dcfg = spec_lib.make_draft_config(m.cfg)
    dparams = T.init_params(dcfg, seed=7, device="cpu")
    with pytest.warns(RuntimeWarning, match="falls back to non-speculative"):
        eng = Engine(m.cfg, m.tparams, slots=3, prefill_chunk=4, draft_cfg=dcfg,
                     draft_params=dparams, spec_k=4, device="cpu", **KW)
    assert not eng.spec and eng.draft_params is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = eng.generate(_prompts(m.cfg), max_new_tokens=NEW)
    np.testing.assert_array_equal(got.tokens.numpy(), want.tokens)
    assert eng.chunk_shapes == set() and got.traffic == want.traffic
    assert eng.last_stats.drafted_tokens == 0


# ---------------------------------------------------------------------------
# kernel 2 at head dim 112
# ---------------------------------------------------------------------------


def _padded(t, width=128):
    return torch.cat([t, t.new_zeros(t.shape[:-1] + (width - t.shape[-1],))], -1)


def test_d112_padded_lane_layout_model_bit_identical_to_plain():
    """Kernel 2's d 112 form, modelled: q and the pending k rotate in
    apply_rope's expression (rope_padded: partner i +- 56 through shared
    memory), then the d 128 schedule (lanes 32 wide, two 64-dim value
    slices) over rows zero-padded to 128, the pending token appended at its
    position: o and k_rot equal the plain version's at d 112 bit for bit
    (its tree_sum pads to 128 with zeros, as the lanes do)."""
    theta = 10_000.0
    lens, g, d = [0, 1, 31, 32, 33, 40, 41, 127], 3, 112
    cache = _poisoned_cache(lens, 40, 88, g, d, seed=11)
    q, kn, vn, act = _decode_inputs(len(lens), 1, g, d, seed=12)
    scale = d ** -0.5
    want, k_want = fd.flash_decode_fused_plain(q, cache, kn, vn, act, scale, theta)
    pos = cache.lengths.long()[:, None]
    q_rot = apply_rope(q[:, None], pos, theta)[:, 0]
    k_rot = apply_rope(kn[:, None], pos, theta)[:, 0]
    assert torch.equal(k_rot.view(torch.int32), k_want.view(torch.int32))
    wide = kvc.TieredKVCache(*(_padded(t).clone() for t in cache[:4]), cache.lengths.clone())
    kvc.append_decode(wide, _padded(k_rot), _padded(vn), active=act)
    got = _decode_schedule_model(_padded(q_rot), wide, scale)
    assert not got[..., d:].any()
    assert torch.equal(got[..., :d].contiguous().view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel2_d112_bit_identical_to_plain(cuda, dtype):
    """Kernel 2 fused at zamba2's heads (MHA, rep 1, d 112), b 6, lengths
    1 / 31 / 32 / 33 / 80 / 127 over hot 32 / cold 96, NaN past each
    length, slot 2 inactive: o and k_rot torch.equal to the plain version,
    one launch; the post-append and fp8 forms refuse d 112."""
    lens, g, d = [1, 31, 32, 33, 80, 127], 32, 112
    dt = getattr(torch, dtype)
    cache = _poisoned_cache(lens, 32, 96, g, d, seed=5, dtype=dt, device=cuda)
    q, kn, vn, _ = _decode_inputs(len(lens), 1, g, d, seed=6, dtype=dt, device=cuda)
    act = torch.tensor([True, True, False, True, True, True], device=cuda)
    kw = dict(k_new=kn, v_new=vn, active=act, rope_theta=10_000.0)
    before = fd.KERNEL.launches
    o, k_rot = fd.flash_decode_attention(q, cache, **kw)
    torch.cuda.synchronize()
    assert fd.KERNEL.launches == before + 1
    o_p, k_p = fd.flash_decode_attention(q, cache, impl="plain", **kw)
    assert torch.equal(o, o_p) and torch.equal(k_rot, k_p) and torch.isfinite(o).all()
    with pytest.raises(ValueError, match="unsupported"):
        fd.flash_decode_attention(q, cache)
    fp8 = kvc.TieredKVCache(*(kvc.to_tier(t, kvc.FP8) for t in cache[:4]), cache.lengths)
    with pytest.raises(ValueError, match="unsupported"):
        fd.flash_decode_attention(q, fp8, **kw)


# (K, N) of the families' packed projections: mamba2-130m's in_proj and
# out_proj, zamba2-7b's in_proj and out_proj
SSM_SHAPES = [(768, 3352), (1536, 768), (3584, 14704), (7168, 3584)]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 6, 576])
@pytest.mark.parametrize("k,n", SSM_SHAPES)
def test_cuda_kernel1_at_ssm_shapes_bit_identical_to_plain(cuda, k, n, m):
    """Kernel 1 (act-quant prologue) at the Mamba2 projections: N 3352 no
    multiple of 16, 14704 no multiple of 64, K up to 7168; one decode row,
    a decode step's 6 slots, a 6 x 96 admission; torch.equal to the plain
    version, one launch."""
    from repro_torch.core import packing

    gen = torch.Generator(device=cuda).manual_seed(k + n + m)
    trits = torch.randint(-1, 2, (k, n), generator=gen, device=cuda, dtype=torch.int8)
    packed = packing.pack(trits, "pack2")
    x = torch.randn((m, k), generator=gen, device=cuda) * 3
    col = torch.rand((n,), generator=gen, device=cuda) + 0.01
    before = tm.KERNEL.launches
    got = tm.ternary_matmul_actq(x, packed, col, k=k)
    torch.cuda.synchronize()
    assert tm.KERNEL.launches == before + 1
    assert torch.equal(got, tm.ternary_matmul_actq_plain(x, packed, col, k))
