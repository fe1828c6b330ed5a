"""The VLM and audio families on the port against the reference's JAX
package, at smoke size, from weights carried across by
``repro_torch.interop``.

llava-next-34b-smoke (family ``vlm``): the vision projector (``proj1``,
gelu, ``proj2``) as fake-quantized float products; the prefill that puts
``n_patches`` projected patch rows ahead of the text (logits and cache
rows); the JAX engine's greedy tokens and DR ledgers through
``generate(patches=)``; a mixed serve (two prompt lengths, so two groups)
request by request; a request without patches raising the reference's
``KeyError``. hubert-xlarge-smoke (family ``audio``, encoder-only): the
packed ``forward`` over projected frames against the reference's
``forward(mode="packed")``; the non-gated GELU MLP alone; the engine's
refusal (``ValueError`` naming the family). And ``attention_full`` frame
by frame: causal for a decoder, bidirectional for an encoder.

The reference keeps its frontend unpacked and ternarizes it at each use;
the port stores ``weight_quant_ste(w)`` once (``{"fq"}``), and the tests
carry the reference's own values across, never re-quantizing its floats.
The reference runs as its own tests run it on the CPU (its prefill takes
the collect-KV forward there); its JAX engine runs once per module.
Values that go through a different sum order are held to LAYER_TOL.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.core import dr_edram
from repro_torch.core import kv_cache as kvc
from repro_torch.core.bitlinear import FusedPackedLinear, PackedLinear
from repro_torch.core.ternary import weight_quant_ste
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import pack as pack_lib
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request, SlotScheduler
from test_torch_threads import share_cpu_threads  # noqa: F401 (autouse: torch threads per worker)

LAYER_TOL = dict(rtol=1e-4, atol=1e-4)
VLM, AUDIO = "llava-next-34b", "hubert-xlarge"
KW = dict(hot_cap=4, max_len=48)
NEW = 16
MIXED = (8, 5, 8, 5, 8)  # the mixed serve's prompt lengths, 6 new tokens each


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import bitlinear as jbitlinear
    from repro.core import ternary as jternary
    from repro.models import attention as jattn
    from repro.models import layers as jlayers
    from repro.models import pack as jpack
    from repro.models import transformer as jT
    from repro.serving import engine as jengine
    from repro.serving import scheduler as jsched

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs, bitlinear=jbitlinear,
                                 ternary=jternary, attn=jattn, layers=jlayers, pack=jpack,
                                 T=jT, engine=jengine, sched=jsched, models={}, runs={})


def _numpy_tree(jref, tree, name=None):
    """The reference's packed tree as numpy for ``interop``: packed leaves
    as field dicts; every float leaf of ``frontend`` as the reference's
    own ``weight_quant_ste`` value ``{"fq"}``."""
    if isinstance(tree, (jref.bitlinear.PackedLinear, jref.bitlinear.FusedPackedLinear)):
        out = dict(packed=np.asarray(tree.packed), scale=np.asarray(tree.scale),
                   k=tree.k, codec=tree.codec)
        if isinstance(tree, jref.bitlinear.FusedPackedLinear):
            out["splits"] = tree.splits
        return out
    if isinstance(tree, dict):
        if name == "frontend" and set(tree) == {"w"}:
            return {"fq": np.asarray(jref.ternary.weight_quant_ste(tree["w"]))}
        inner = name if name == "frontend" else None
        return {k: _numpy_tree(jref, v, inner or k) for k, v in tree.items()}
    return np.asarray(tree)


def _models(jref, name):
    """(jcfg, jpacked, cfg, tparams) of ``name``'s smoke config, built once
    per module: the reference's PRNGKey(0) init, packed by the reference,
    carried across."""
    if name not in jref.models:
        jcfg = jref.configs.get_smoke_config(name)
        jpacked = jref.pack.pack_params(jref.T.init_params(jref.jax.random.PRNGKey(0), jcfg),
                                        jcfg)
        jref.models[name] = types.SimpleNamespace(
            jcfg=jcfg, jpacked=jpacked, cfg=get_smoke_config(name),
            tparams=interop.params_from_reference(_numpy_tree(jref, jpacked)))
    return jref.models[name]


def _prompts(cfg, n=3, s=8, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (n, s)).astype(np.int32)


def _features(cfg, n, rows, seed=3):
    return np.random.default_rng(seed).standard_normal((n, rows, cfg.frontend_dim)).astype(
        np.float32)


def _mixed(cfg, make):
    """The mixed serve's requests, each with its own patches."""
    rng = np.random.default_rng(4)
    return [make(i, rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32), 6,
                 rng.standard_normal((cfg.n_patches, cfg.frontend_dim)).astype(np.float32))
            for i, n in enumerate(MIXED)]


def _reference_run(jref):
    """The JAX engine's generate of 3 x (8 + 16) with patches, its mixed
    serve over 3 slots, and the reference's prefill and first decode step
    logits: run once per module."""
    if "vlm" not in jref.runs:
        m = _models(jref, VLM)
        jnp = jref.jnp
        prompts, patches = _prompts(m.cfg), _features(m.cfg, 3, m.cfg.n_patches)
        jeng = jref.engine.Engine(m.jcfg, m.jpacked, slots=3, **KW)
        res = jeng.generate(jnp.asarray(prompts), max_new_tokens=NEW,
                            patches=jnp.asarray(patches))
        serve = jeng.serve(_mixed(m.cfg, lambda i, t, n, p: jref.sched.Request(
            i, t, n, patches=p)), slots=3)
        batch = {"tokens": jnp.asarray(prompts), "patches": jnp.asarray(patches)}
        jl, jcache = jref.T.prefill(m.jpacked, m.jcfg, batch, hot_cap=4, max_len=24)
        # numpy copies first: the decode step writes into the cache's buffers
        cache = jref.jax.tree_util.tree_map(lambda a: np.array(a, copy=True), jcache["attn"])
        first = np.asarray(jl).argmax(-1).astype(np.int32)
        jl1, _ = jref.T.decode_step(m.jpacked, m.jcfg, jnp.asarray(first), jcache)
        jref.runs["vlm"] = types.SimpleNamespace(
            prompts=prompts, patches=patches, tokens=np.asarray(res.tokens),
            traffic=res.traffic, serve={f.rid: f for f in serve}, logits=np.asarray(jl),
            cache=cache, first=first, step_logits=np.asarray(jl1),
            token_bytes=jeng._kv_token_bytes())
    return jref.runs["vlm"]


def _layer0(jref, m):
    jblk = jref.jax.tree_util.tree_map(lambda a: a[0], m.jpacked["blocks"])
    return jblk, m.tparams["blocks"][0]


# ---------------------------------------------------------------------------
# configs, packing and the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [VLM, AUDIO])
def test_configs_match_reference(jref, name):
    """Every field the port keeps equals the reference's, at full and
    smoke size (``shrink``'s frontend rules: frontend_dim 32, 8 patches)."""
    from repro_torch.configs import get_config

    for mine, theirs in ((get_config(name), jref.configs.get_config(name)),
                         (get_smoke_config(name), jref.configs.get_smoke_config(name))):
        for f in dataclasses.fields(mine):
            if f.name not in ("bitnet", "mla", "moe", "ssm"):
                assert getattr(mine, f.name) == getattr(theirs, f.name), f.name


@pytest.mark.parametrize("name", [VLM, AUDIO])
def test_packing_keeps_the_frontend_fake_quantized(jref, name):
    """The port's own pack: every frontend leaf ``{"fq"}`` equal to
    ``weight_quant_ste`` of its float, the non-gated ``up`` left unfused;
    the packed leaves the SDC stamps walk are the reference's paths and
    sizes, none of them the frontend's; packing a carried tree is a no-op
    on its ``{"fq"}`` leaves."""
    m = _models(jref, name)
    cfg = m.cfg
    float_params = T.init_params(cfg, seed=0, device="cpu")
    packed = pack_lib.pack_params(float_params, cfg)
    pairs = ([(packed["frontend"], float_params["frontend"])] if cfg.frontend == "audio" else
             [(packed["frontend"][k], float_params["frontend"][k]) for k in ("proj1", "proj2")])
    for leaf, raw in pairs:
        assert set(leaf) == {"fq"} and torch.equal(leaf["fq"], weight_quant_ste(raw["w"]))
    mlp = packed["blocks"][0]["mlp"]
    if cfg.activation == "gelu":
        assert set(mlp) == {"ln", "up", "down"} and type(mlp["up"]) is PackedLinear
    else:
        assert isinstance(mlp["wgu"], FusedPackedLinear)
    mine = [(p, s.size) for p, s in pack_lib.iter_packed_leaves(m.tparams)]
    theirs = [(p, int(np.asarray(leaf.packed).nbytes))
              for p, leaf in jref.pack.iter_packed_leaves(m.jpacked)]
    assert mine == theirs and not any(p.startswith("frontend") for p, _ in mine)
    again = pack_lib.pack_params(m.tparams, cfg)
    for a, b in zip(pack_lib.iter_packed_leaves(again), pack_lib.iter_packed_leaves(m.tparams)):
        assert a[0] == b[0]
    own = T.init_params(cfg, seed=0, device="cpu", pack=True)
    assert torch.equal(T._frontend_embed(own, cfg, torch.ones(1, 2, cfg.frontend_dim)),
                       T._frontend_embed(packed, cfg, torch.ones(1, 2, cfg.frontend_dim)))


@pytest.mark.parametrize("name", [VLM, AUDIO])
def test_frontend_embed_matches_reference(jref, name):
    m = _models(jref, name)
    feats = _features(m.cfg, 3, 7)
    want = jref.T._frontend_embed(m.jpacked, m.jcfg, jref.jnp.asarray(feats), "packed")
    got = T._frontend_embed(m.tparams, m.cfg, torch.from_numpy(feats))
    assert got.shape == (3, 7, m.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_non_gated_mlp_matches_reference(jref):
    """hubert's MLP: ``up``, gelu (tanh form), ``down``; no gate."""
    m = _models(jref, AUDIO)
    jblk, blk = _layer0(jref, m)
    x = np.random.default_rng(5).standard_normal((3, 5, m.cfg.d_model)).astype(np.float32)
    want = np.asarray(jref.layers.apply_mlp(jblk["mlp"], jref.jnp.asarray(x), m.jcfg, "packed"))
    got = layers.apply_mlp(blk["mlp"], torch.from_numpy(x), m.cfg).numpy()
    np.testing.assert_allclose(got, want, **LAYER_TOL)


@pytest.mark.parametrize("is_encoder", [False, True])
def test_attention_full_causal_and_encoder_frame_by_frame(jref, is_encoder):
    """``attention_full`` against the reference's, and frame by frame: a
    change to the last frame moves every earlier frame's output under the
    encoder's bidirectional attention and none under the causal one."""
    m = _models(jref, AUDIO)
    jblk, blk = _layer0(jref, m)
    jcfg = dataclasses.replace(m.jcfg, is_encoder=is_encoder)
    cfg = dataclasses.replace(m.cfg, is_encoder=is_encoder)
    x = np.random.default_rng(6).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32)
    want = np.asarray(jref.attn.attention_full(jblk["attn"], jref.jnp.asarray(x), jcfg,
                                               "packed", jref.jnp.asarray(pos)))
    got = attn.attention_full(blk["attn"], torch.from_numpy(x), cfg, torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)
    x2 = x.copy()
    x2[:, -1] += 1.0
    got2 = attn.attention_full(blk["attn"], torch.from_numpy(x2), cfg, torch.from_numpy(pos))
    moved = [not torch.equal(got[:, i], got2[:, i]) for i in range(8)]
    assert moved == [is_encoder] * 8


# ---------------------------------------------------------------------------
# hubert-xlarge: the packed forward and the refusal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [AUDIO, VLM, "falcon3-1b"])
def test_forward_matches_reference(jref, name):
    """``forward`` in packed mode against the reference's
    ``forward(mode="packed")``: (b, s, vocab) f32 logits within LAYER_TOL
    and the same argmax on every position; hubert over frames, llava over
    patches ahead of tokens, falcon3-1b over tokens."""
    if name == "falcon3-1b":
        jcfg = jref.configs.get_smoke_config(name)
        jpacked = jref.pack.pack_params(jref.T.init_params(jref.jax.random.PRNGKey(1), jcfg),
                                        jcfg)
        m = types.SimpleNamespace(jcfg=jcfg, jpacked=jpacked, cfg=get_smoke_config(name),
                                  tparams=interop.params_from_reference(
                                      _numpy_tree(jref, jpacked)))
    else:
        m = _models(jref, name)
    cfg, batch = m.cfg, {}
    if cfg.family == "audio":
        batch["frames"] = _features(cfg, 2, 12)
    else:
        batch["tokens"] = _prompts(cfg, 2, 6)
    if cfg.family == "vlm":
        batch["patches"] = _features(cfg, 2, cfg.n_patches)
    want, _ = jref.T.forward(m.jpacked, m.jcfg, {k: jref.jnp.asarray(v) for k, v in batch.items()},
                             mode="packed", remat=False)
    got = T.forward(m.tparams, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert want.shape[-1] == cfg.vocab_size
    np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


def test_forward_refuses_what_is_not_ported():
    for name in ("deepseek-v3-671b", "mixtral-8x22b", "mamba2-130m", "zamba2-7b"):
        cfg = get_smoke_config(name)
        with pytest.raises(NotImplementedError, match=cfg.family):
            T.forward({"final_ln": torch.ones(cfg.d_model)}, cfg,
                      {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


def test_engine_refuses_the_encoder(jref):
    """Both engines refuse hubert-xlarge with a ``ValueError`` naming its
    family at ``generate``; the port's ``prefill`` and
    ``init_decode_cache`` refuse it as the reference's do."""
    m = _models(jref, AUDIO)
    prompts = _prompts(m.cfg)
    jeng = jref.engine.Engine(m.jcfg, m.jpacked, **KW)
    with pytest.raises(ValueError, match="audio"):
        jeng.generate(jref.jnp.asarray(prompts), max_new_tokens=4)
    eng = Engine(m.cfg, m.tparams, device="cpu", **KW)
    with pytest.raises(ValueError, match="audio"):
        eng.generate(prompts, max_new_tokens=4)
    with pytest.raises(ValueError, match="audio"):
        T.init_decode_cache(m.cfg, 2, 16, 4, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        T.prefill(m.tparams, m.cfg, torch.from_numpy(prompts))


# ---------------------------------------------------------------------------
# llava-next-34b: prefill, decode and the engine
# ---------------------------------------------------------------------------


def test_vlm_prefill_logits_and_cache_match_reference(jref):
    """The patches' n_patches rows, then the text's, fill the tiered cache
    (hot 4, cold 20; lengths n_patches + 8); last-token logits, every cache
    row and the first decode step's logits within LAYER_TOL."""
    m, want = _models(jref, VLM), _reference_run(jref)
    tl, tcache = T.prefill(m.tparams, m.cfg, torch.from_numpy(want.prompts), hot_cap=4,
                           max_len=24, patches=torch.from_numpy(want.patches))
    np.testing.assert_allclose(tl.numpy(), want.logits, **LAYER_TOL)
    assert np.array_equal(tl.numpy().argmax(-1), want.first)
    s = m.cfg.n_patches + want.prompts.shape[1]
    c = tcache["attn"]
    np.testing.assert_array_equal(c.lengths.numpy(), want.cache.lengths)
    assert c.lengths.numpy().tolist() == [[s] * 3] * m.cfg.n_layers
    for field in ("hot_k", "hot_v", "cold_k", "cold_v"):
        np.testing.assert_allclose(getattr(c, field).numpy(), getattr(want.cache, field),
                                   **LAYER_TOL)
    tl1, _ = T.decode_step(m.tparams, m.cfg, torch.from_numpy(want.first), tcache)
    np.testing.assert_allclose(tl1.numpy(), want.step_logits, **LAYER_TOL)


def test_vlm_generate_matches_reference_engine(jref):
    """``generate(patches=)``: the JAX engine's greedy tokens and ledgers,
    every row at the closed form at S = n_patches + 8 + 16, run over run;
    ``weight_loads`` 0."""
    m, want = _models(jref, VLM), _reference_run(jref)
    eng = Engine(m.cfg, m.tparams, slots=3, device="cpu", **KW)
    got = eng.generate(want.prompts, max_new_tokens=NEW, patches=want.patches)
    np.testing.assert_array_equal(got.tokens.numpy(), want.tokens)
    assert got.traffic == want.traffic and eng.weight_loads == 0
    assert eng._kv_token_bytes() == want.token_bytes
    seq = m.cfg.n_patches + 8 + NEW
    closed = dr_edram.closed_form_reduction(seq, KW["hot_cap"])
    for f in got.finished:
        assert f.prompt_len == 8 and f.seq_len == seq
        assert abs(f.external_reduction - closed) <= 1e-12
    again = eng.generate(want.prompts, max_new_tokens=NEW, patches=want.patches)
    assert torch.equal(again.tokens, got.tokens) and again.traffic == got.traffic


def test_vlm_mixed_serve_matches_reference_engine(jref):
    """Prompts 8 / 5 / 8 / 5 / 8, each with its own patches, over 3 slots:
    grouped by (prompt length, patch shape), admitted into freed slots;
    every request's tokens, seq_len and ledger equal the JAX engine's."""
    m, want = _models(jref, VLM), _reference_run(jref)
    eng = Engine(m.cfg, m.tparams, slots=3, device="cpu", **KW)
    fin = {f.rid: f for f in eng.serve(_mixed(m.cfg, lambda i, t, n, p: Request(
        i, t, n, patches=p)))}
    assert sorted(fin) == sorted(want.serve)
    for rid, f in fin.items():
        np.testing.assert_array_equal(f.tokens, np.asarray(want.serve[rid].tokens))
        assert f.traffic == want.serve[rid].traffic and f.seq_len == want.serve[rid].seq_len


def test_vlm_request_without_patches_raises_as_reference(jref):
    """A vision model's request without patches, alone or mixed with
    requests that carry theirs: both engines raise ``KeyError('patches')``
    when its group is admitted."""
    m = _models(jref, VLM)
    prompts, patches = _prompts(m.cfg), _features(m.cfg, 3, m.cfg.n_patches)
    jeng = jref.engine.Engine(m.jcfg, m.jpacked, slots=3, **KW)
    eng = Engine(m.cfg, m.tparams, slots=3, device="cpu", **KW)
    runs = [(lambda e=e: e.generate(p, max_new_tokens=4)) for e, p in
            ((jeng, jref.jnp.asarray(prompts)), (eng, prompts))]
    runs += [(lambda e=e, R=R: e.serve([R(0, prompts[0], 4, patches=patches[0]),
                                        R(1, prompts[1][:5], 4)], slots=2))
             for e, R in ((jeng, jref.sched.Request), (eng, Request))]
    for run in runs:
        with pytest.raises(KeyError, match="patches"):
            run()


def test_vlm_validation_counts_the_patches(jref):
    """8 patches + 8 text + 40 new > max_len 48: both engines refuse the
    request; without its patches it would fit."""
    m = _models(jref, VLM)
    prompts, patches = _prompts(m.cfg), _features(m.cfg, 3, m.cfg.n_patches)
    jeng = jref.engine.Engine(m.jcfg, m.jpacked, slots=3, **KW)
    eng = Engine(m.cfg, m.tparams, slots=3, device="cpu", **KW)
    for e, R in ((jeng, jref.sched.Request), (eng, Request)):
        with pytest.raises(ValueError, match="prompt 16 \\+ max_new 40 exceeds max_len 48"):
            e.serve([R(0, prompts[0], 40, patches=patches[0])])
    eng._validate_request(Request(0, prompts[0], 40), 3)


def test_scheduler_groups_by_prompt_length_and_patch_shape(jref):
    """``next_group`` pairs the head request only with requests of its
    prompt length AND patch shape (or none): the reference's groups."""
    rng = np.random.default_rng(8)
    specs = [(8, 4), (8, None), (8, 4), (5, 4), (8, 6), (8, None), (8, 4)]

    def groups(sched_cls, req_cls):
        sched = sched_cls(8)
        for i, (n, p) in enumerate(specs):
            sched.submit(req_cls(i, rng.integers(0, 9, n).astype(np.int32), 2,
                                 patches=None if p is None else np.zeros((p, 3), np.float32)))
        out = []
        while sched.queue:
            _, group = sched.next_group()
            out.append([r.rid for r in group])
        return out

    mine = groups(SlotScheduler, Request)
    assert mine == groups(jref.sched.SlotScheduler, jref.sched.Request)
    assert mine == [[0, 2, 6], [1, 5], [3], [4]]


def test_vlm_engine_gates():
    """A frontend rules out chunked admission, as in the reference:
    ``paged=True`` raises, ``prefill_chunk > 0`` admits grouped."""
    cfg = get_smoke_config(VLM)
    params = T.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="paged serving needs chunked prefill"):
        Engine(cfg, params, prefill_chunk=4, paged=True, device="cpu", **KW)
    eng = Engine(cfg, params, slots=2, prefill_chunk=4, device="cpu", **KW)
    assert not eng._chunked_capable()
    got = eng.generate(_prompts(cfg, 2), max_new_tokens=4,
                       patches=_features(cfg, 2, cfg.n_patches))
    assert eng.chunk_shapes == set() and got.tokens.shape == (2, 4)
    assert kvc.external_reduction(got.traffic) > 0
