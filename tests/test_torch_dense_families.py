"""The dense families on the port: qwen3-8b and qwen3-32b (an RMSNorm over
each q and k head before RoPE), gemma-7b (GeGLU, MHA, tied embeddings
scaled by sqrt(d_model)) and deepseek-coder-33b (the llama shape, GQA rep
7 at full width), each at its smoke size against the reference's JAX
package, from weights carried across by ``repro_torch.interop``.

The reference packs its own init, with the qk-norm weights seeded away
from one (the init's ones would hide a swapped ``q_norm`` / ``k_norm``),
and the port receives those leaves as they are. The pieces first (the
projection with its qk-norm, the GeGLU MLP, the scaled embedding bit for
bit, the tied lm_head), then ``tests/test_conformance.py``'s contract per
config: the port's ``Engine.generate`` gives the JAX engine's greedy
tokens and per-request ledgers (one JAX run per config, which every port
variant is held to), prefill and first-step logits within LOGIT_TOL, run
over run the same; chunked admission (``prefill_chunk`` 4), a speculative
serve with ``make_draft_config`` and a paged speculative serve (page size
8, ``check_serving_invariants`` every iteration) give the same tokens.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.core import dr_edram
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import pack as pack_lib
from repro_torch.models import transformer as T
from repro_torch.serving import sdc
from repro_torch.serving import speculative as spec_lib
from repro_torch.serving.chaos import check_serving_invariants
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request
from test_torch_threads import share_cpu_threads  # noqa: F401 (autouse: torch threads per worker)

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = ["qwen3-8b", "qwen3-32b", "gemma-7b", "deepseek-coder-33b"]
KW = dict(hot_cap=4, max_len=48)
NEW = 16


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import bitlinear as jbitlinear
    from repro.models import attention as jattn
    from repro.models import layers as jlayers
    from repro.models import pack as jpack
    from repro.models import transformer as jT
    from repro.serving import engine as jengine
    from repro.serving import speculative as jspec

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs, bitlinear=jbitlinear,
                                 attn=jattn, layers=jlayers, pack=jpack, T=jT, engine=jengine,
                                 spec=jspec, runs={}, models={})


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


def _with_qk_norms(jref, params, seed):
    """The reference's init with every ``q_norm`` / ``k_norm`` drawn from
    1 + N(0, 0.3^2), q and k from separate draws."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: (jref.jnp.asarray((1 + 0.3 * rng.standard_normal(v.shape))
                                         .astype(np.float32))
                        if k in ("q_norm", "k_norm") else walk(v)) for k, v in t.items()}
        return t

    return walk(params)


def _models(jref, name, **over):
    """(jcfg, jpacked, cfg, tparams) of ``name``'s smoke config (fields
    replaced by ``over`` in both packages), built once per module: the
    reference's PRNGKey(0) init, qk-norms seeded, packed with integrity
    stamps, carried across; and its ``make_draft_config`` draft
    (PRNGKey(7)) packed and carried."""
    key = (name, tuple(sorted(over.items())))
    if key not in jref.models:
        jcfg = dataclasses.replace(jref.configs.get_smoke_config(name), **over)
        params = _with_qk_norms(jref, jref.T.init_params(jref.jax.random.PRNGKey(0), jcfg), 3)
        jpacked = jref.pack.pack_params(params, jcfg, integrity=True)
        jdcfg = jref.spec.make_draft_config(jcfg)
        jdparams = jref.pack.pack_params(
            jref.T.init_params(jref.jax.random.PRNGKey(7), jdcfg), jdcfg)
        cfg = dataclasses.replace(get_smoke_config(name), **over)
        jref.models[key] = types.SimpleNamespace(
            jcfg=jcfg, jpacked=jpacked, cfg=cfg,
            tparams=interop.params_from_reference(_numpy_tree(jref, jpacked)),
            dcfg=spec_lib.make_draft_config(cfg),
            dparams=interop.params_from_reference(_numpy_tree(jref, jdparams)))
    return jref.models[key]


def _prompts(cfg):
    return np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)


def _reference_run(jref, name):
    """The JAX engine's one generate of 3 x (8 + 16) for ``name``, and its
    prefill / first decode step logits: run once per module."""
    if name not in jref.runs:
        m = _models(jref, name)
        prompts = jref.jnp.asarray(_prompts(m.cfg))
        res = jref.engine.Engine(m.jcfg, m.jpacked, slots=3, **KW).generate(
            prompts, max_new_tokens=NEW)
        jl, jcache = jref.T.prefill(m.jpacked, m.jcfg, {"tokens": prompts}, hot_cap=4,
                                    max_len=24)
        first = np.asarray(jl).argmax(-1).astype(np.int32)
        jl1, _ = jref.T.decode_step(m.jpacked, m.jcfg, jref.jnp.asarray(first), jcache)
        jref.runs[name] = types.SimpleNamespace(
            tokens=np.asarray(res.tokens), traffic=res.traffic, logits=np.asarray(jl),
            first=first, step_logits=np.asarray(jl1))
    return jref.runs[name]


def _layer0(jref, m):
    """Layer 0 of the reference's packed stack (as the reference's own
    leaves) and of the port's tree."""
    jblk = jref.jax.tree_util.tree_map(lambda a: a[0], m.jpacked["blocks"])
    return jblk, m.tparams["blocks"][0]


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["qwen3-8b", "qwen3-32b"])
def test_project_qkv_with_qk_norm_matches_reference(jref, name):
    """q and k normed per head with their own seeded weights (not ones, so a
    swap shows), before either attention kernel sees them; v untouched."""
    m = _models(jref, name)
    jblk, blk = _layer0(jref, m)
    assert not torch.equal(blk["attn"]["q_norm"], blk["attn"]["k_norm"])
    assert not torch.equal(blk["attn"]["q_norm"], torch.ones_like(blk["attn"]["q_norm"]))
    x = np.random.default_rng(4).standard_normal((3, 5, m.cfg.d_model)).astype(np.float32)
    want = jref.attn._project_qkv(jblk["attn"], jref.jnp.asarray(x), m.jcfg, "packed")
    got = attn._project_qkv(blk["attn"], torch.from_numpy(x), m.cfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    swapped = dict(blk["attn"], q_norm=blk["attn"]["k_norm"], k_norm=blk["attn"]["q_norm"])
    q_sw = attn._project_qkv(swapped, torch.from_numpy(x), m.cfg)[0]
    assert not np.allclose(q_sw.numpy(), np.asarray(want[0]), rtol=1e-3, atol=1e-3)
    plain = dataclasses.replace(m.cfg, qk_norm=False)
    q_raw, k_raw, v_raw = attn._project_qkv(blk["attn"], torch.from_numpy(x), plain)
    assert torch.equal(got[0], layers.rms_norm(q_raw, blk["attn"]["q_norm"], m.cfg.norm_eps))
    assert torch.equal(got[1], layers.rms_norm(k_raw, blk["attn"]["k_norm"], m.cfg.norm_eps))
    assert torch.equal(got[2], v_raw)


def test_gelu_tanh_is_the_reference_formula(jref):
    """GeGLU's gelu against ``jax.nn.gelu(approximate=True)``: the same
    expression in the same order and constants; XLA's CPU tanh is an
    approximation of its own, so values differ by an ulp or two (and
    tanh = -1 exactly far left gives -0.0 there)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(100_000) * rng.uniform(0.01, 10, 100_000)).astype(np.float32)
    want = np.asarray(jref.jax.nn.gelu(jref.jnp.asarray(x), approximate=True))
    got = layers.gelu_tanh(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    xb = jref.jnp.asarray(x).astype(jref.jnp.bfloat16)
    want_b = np.asarray(jref.jax.nn.gelu(xb, approximate=True).astype(jref.jnp.float32))
    got_b = layers.gelu_tanh(torch.from_numpy(x).bfloat16()).float().numpy()
    np.testing.assert_array_equal(got_b, want_b)


def test_apply_mlp_geglu_matches_reference(jref):
    m = _models(jref, "gemma-7b")
    jblk, blk = _layer0(jref, m)
    x = np.random.default_rng(5).standard_normal((3, 5, m.cfg.d_model)).astype(np.float32)
    want = np.asarray(jref.layers.apply_mlp(jblk["mlp"], jref.jnp.asarray(x), m.jcfg, "packed"))
    got = layers.apply_mlp(blk["mlp"], torch.from_numpy(x), m.cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    swiglu = layers.apply_mlp(blk["mlp"], torch.from_numpy(x),
                              dataclasses.replace(m.cfg, activation="swiglu")).numpy()
    assert not np.allclose(swiglu, want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scaled_embedding_is_bit_equal(jref, dtype):
    """sqrt(d_model) rounded to the activation dtype first, then one
    product: the reference's bits."""
    m = _models(jref, "gemma-7b")
    tokens = np.random.default_rng(6).integers(0, m.cfg.vocab_size, (3, 7)).astype(np.int32)
    jdt, tdt = getattr(jref.jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jref.T._embed_tokens(m.jpacked, m.jcfg, jref.jnp.asarray(tokens), jdt)
                      .astype(jref.jnp.float32))
    got = T._embed_tokens(m.tparams, m.cfg, torch.from_numpy(tokens), tdt).float().numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    unscaled = T._embed_tokens(m.tparams, dataclasses.replace(m.cfg, scale_embed=False),
                               torch.from_numpy(tokens), tdt).float().numpy()
    assert not np.array_equal(unscaled, want)


def test_tied_lm_head_matches_reference(jref):
    """gemma-7b's lm_head is the unscaled embedding's transpose."""
    m = _models(jref, "gemma-7b")
    assert "lm_head" not in m.tparams
    x = np.random.default_rng(7).standard_normal((3, m.cfg.d_model)).astype(np.float32)
    want = np.asarray(jref.T._lm_logits(m.jpacked, m.jcfg, jref.jnp.asarray(x)))
    got = T._lm_logits(m.tparams, m.cfg, torch.from_numpy(x), rows=6)
    assert got.shape == (3, m.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


def test_norm_leaves_pass_packing_and_stamps_unpacked(jref):
    """``q_norm`` / ``k_norm`` cross as float leaves, equal to the
    reference's; packing a carried tree keeps them; the packed leaves the
    SDC scrub and stamps walk are the reference's paths and sizes, none of
    them a norm; the port's own packed init has them as ones."""
    m = _models(jref, "qwen3-8b")
    for i, blk in enumerate(m.tparams["blocks"]):
        for key in ("q_norm", "k_norm"):
            leaf = blk["attn"][key]
            assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.float32
            np.testing.assert_array_equal(
                leaf.numpy(), np.asarray(m.jpacked["blocks"]["attn"][key][i]))
    repacked = pack_lib.pack_params(m.tparams, m.cfg)
    assert torch.equal(repacked["blocks"][1]["attn"]["q_norm"],
                       m.tparams["blocks"][1]["attn"]["q_norm"])
    mine = [(p, s.size) for p, s in pack_lib.iter_packed_leaves(m.tparams)]
    theirs = [(p, int(np.asarray(leaf.packed).nbytes))
              for p, leaf in jref.pack.iter_packed_leaves(m.jpacked)]
    assert mine == theirs and not any("norm" in p for p, _ in mine)
    assert pack_lib.verify_packed(m.tparams) == []
    own = T.init_params(m.cfg, seed=0, device="cpu", pack=True)
    assert torch.equal(own["blocks"][0]["attn"]["k_norm"], torch.ones(m.cfg.resolved_head_dim))


@pytest.mark.parametrize("name", ["qwen3-32b", "gemma-7b"])
def test_integrity_scrub_sees_no_fault(jref, name):
    """The SDC scrub (crc32 of every packed leaf, the ABFT probe with K =
    h * hd for ``wo``) on a model whose norms pass unpacked and whose
    ``h * hd`` is not ``d_model`` at full width: nothing detected, the
    reference's tokens."""
    m, want = _models(jref, name), _reference_run(jref, name)
    eng = Engine(m.cfg, m.tparams, slots=3, device="cpu",
                 integrity=sdc.IntegrityConfig(scrub_every=2), **KW)
    got = eng.generate(_prompts(m.cfg), max_new_tokens=NEW)
    np.testing.assert_array_equal(got.tokens.numpy(), want.tokens)
    st = eng.last_stats
    assert st.sdc_detected == st.weight_reloads == 0 and eng.weight_loads == 0
    assert sorted(eng._golden) == [p for p, _ in pack_lib.iter_packed_leaves(m.tparams)]


def test_heads_wider_than_d_model_match_reference(jref):
    """qwen3-32b's h * hd (8192) is not its d_model (5120); the smoke config
    has h * hd = d_model, so here its heads are 32 wide (h * hd = 128
    against d_model 64): the reference engine's tokens, ledgers and bytes
    per token, wo a (128, 64) projection."""
    m = _models(jref, "qwen3-32b", head_dim=32)
    assert m.cfg.n_heads * m.cfg.resolved_head_dim == 2 * m.cfg.d_model
    assert m.tparams["blocks"][0]["attn"]["wo"].k == 128
    prompts = _prompts(m.cfg)
    jeng = jref.engine.Engine(m.jcfg, m.jpacked, slots=3, **KW)
    want = jeng.generate(jref.jnp.asarray(prompts), max_new_tokens=NEW)
    eng = Engine(m.cfg, m.tparams, slots=3, device="cpu", **KW)
    got = eng.generate(prompts, max_new_tokens=NEW)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.traffic == want.traffic
    assert eng._kv_token_bytes() == jeng._kv_token_bytes() == 2 * 2 * 2 * 32 * 2


def test_non_gated_gelu_is_refused():
    """The non-gated ``"gelu"`` MLP is ported (hubert-xlarge,
    ``tests/test_torch_frontends.py``); it is refused on a gated tree (a
    fused ``wgu`` and no ``up`` leaf), and an activation outside the three
    is refused at init."""
    cfg = dataclasses.replace(get_smoke_config("gemma-7b"), activation="gelu")
    own = T.init_params(cfg, seed=0, device="cpu", pack=True)
    assert set(own["blocks"][0]["mlp"]) == {"ln", "up", "down"}
    params = T.init_params(get_smoke_config("gemma-7b"), seed=0, device="cpu", pack=True)
    with pytest.raises(KeyError, match="up"):
        layers.apply_mlp(params["blocks"][0]["mlp"], torch.zeros((1, 2, cfg.d_model)), cfg)
    with pytest.raises(NotImplementedError, match="relu"):
        T.init_params(dataclasses.replace(cfg, activation="relu"), seed=0, device="cpu")


# ---------------------------------------------------------------------------
# the engine, per config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_generate_matches_reference_engine(jref, name):
    """Greedy tokens and per-request ledgers of the JAX engine, each ledger
    at the closed form, ``weight_loads`` 0; the same again run over run."""
    m, want = _models(jref, name), _reference_run(jref, name)
    prompts = _prompts(m.cfg)
    eng = Engine(m.cfg, m.tparams, slots=3, device="cpu", **KW)
    got = eng.generate(prompts, max_new_tokens=NEW)
    np.testing.assert_array_equal(got.tokens.numpy(), want.tokens)
    assert got.traffic == want.traffic and eng.weight_loads == 0
    closed = dr_edram.closed_form_reduction(8 + NEW, 4)
    for f in got.finished:
        assert f.seq_len == 8 + NEW and abs(f.external_reduction - closed) <= 1e-12
    again = eng.generate(prompts, max_new_tokens=NEW)
    assert torch.equal(again.tokens, got.tokens) and again.traffic == got.traffic


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_first_step_logits_match_reference(jref, name):
    m, want = _models(jref, name), _reference_run(jref, name)
    toks = torch.from_numpy(_prompts(m.cfg))
    tl, tcache = T.prefill(m.tparams, m.cfg, toks, hot_cap=4, max_len=24)
    np.testing.assert_allclose(tl.numpy(), want.logits, **LOGIT_TOL)
    assert np.array_equal(tl.numpy().argmax(-1), want.first)
    tl1, _ = T.decode_step(m.tparams, m.cfg, torch.from_numpy(want.first), tcache)
    np.testing.assert_allclose(tl1.numpy(), want.step_logits, **LOGIT_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_chunked_admission_gives_the_grouped_tokens(jref, name):
    m, want = _models(jref, name), _reference_run(jref, name)
    eng = Engine(m.cfg, m.tparams, slots=3, prefill_chunk=4, device="cpu", **KW)
    got = eng.generate(_prompts(m.cfg), max_new_tokens=NEW)
    assert eng.chunk_shapes == {(3, 4)}
    np.testing.assert_array_equal(got.tokens.numpy(), want.tokens)
    assert got.traffic == want.traffic


@pytest.mark.parametrize("name", NAMES)
def test_speculative_gives_the_non_speculative_tokens(jref, name):
    """A ``make_draft_config`` draft at K 4 over chunked admission: the
    JAX engine's non-speculative tokens, something drafted, nothing
    accepted past it."""
    m, want = _models(jref, name), _reference_run(jref, name)
    eng = Engine(m.cfg, m.tparams, slots=3, prefill_chunk=4, draft_cfg=m.dcfg,
                 draft_params=m.dparams, spec_k=4, device="cpu", **KW)
    got = eng.generate(_prompts(m.cfg), max_new_tokens=NEW)
    np.testing.assert_array_equal(got.tokens.numpy(), want.tokens)
    st = eng.last_stats
    assert eng.spec and st.drafted_tokens > 0 and st.accepted_tokens <= st.drafted_tokens


@pytest.mark.parametrize("name", NAMES)
def test_paged_speculative_keeps_the_invariants_and_tokens(jref, name):
    """Paged (page size 8) speculative serving, the invariant checker after
    every iteration: the contiguous tokens, request by request."""
    m, want = _models(jref, name), _reference_run(jref, name)
    eng = Engine(m.cfg, m.tparams, prefill_chunk=4, paged=True, page_size=8,
                 draft_cfg=m.dcfg, draft_params=m.dparams, spec_k=4, device="cpu", **KW)
    checked = []

    def hook(ctx):
        check_serving_invariants(ctx)
        checked.append(ctx.iteration)

    reqs = [Request(rid=i, tokens=p, max_new_tokens=NEW) for i, p in enumerate(_prompts(m.cfg))]
    fin = {f.rid: f for f in eng.serve(reqs, slots=3, on_iteration=hook)}
    for rid, row in enumerate(want.tokens):
        np.testing.assert_array_equal(fin[rid].tokens, row)
    assert len(checked) == eng.last_stats.iterations > 0
    assert eng.last_stats.drafted_tokens > 0
