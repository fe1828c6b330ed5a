"""The slices end to end: the port's ``Engine`` on falcon3-1b-smoke (dense,
GQA) and deepseek-v3-671b-smoke (MoE, MLA latent cache) against the
reference's JAX ``Engine``, from weights carried across by
``repro_torch.interop``.

The reference packs its own init (with random LoRA B factors, which are
zero at init), and the port receives those packed leaves as they are;
MLA's float-kept ``w_uk`` / ``w_uv`` cross as the reference's own
fake-quantized values.
Contract: the SAME greedy tokens and the SAME per-request DR-traffic
ledger (integers), which reconciles with the closed form per sequence;
prefill and first decode-step logits agree to LOGIT_TOL = 1e-4 (f32
arithmetic in another order; measured differences are about 1e-6).
Also: the configs, the init shapes, the ledger and DR-model functions and
the scheduler's grouping match the reference, and the entry points refuse
to run on the CPU unless asked to.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import dr_edram, kv_cache
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request, SlotScheduler

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = ["falcon3-1b", "deepseek-v3-671b"]


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import bitlinear as jbitlinear
    from repro.core import dr_edram as jdr
    from repro.core import ternary as jternary
    from repro.core import kv_cache as jkvc
    from repro.models import pack as jpack
    from repro.models import transformer as jT
    from repro.serving import engine as jengine
    from repro.serving import scheduler as jsched

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs, bitlinear=jbitlinear,
                                 dr=jdr, kvc=jkvc, pack=jpack, T=jT, engine=jengine,
                                 sched=jsched, ternary=jternary)


def _numpy_tree(jref, tree):
    """Reference tree -> numpy, packed leaves as plain field dicts; MLA's
    w_uk / w_uv (stacked per layer) as the reference's fake-quantized
    values ``{"fq"}``, computed layer by layer."""
    if isinstance(tree, (jref.bitlinear.PackedLinear, jref.bitlinear.FusedPackedLinear)):
        out = dict(packed=np.asarray(tree.packed), scale=np.asarray(tree.scale),
                   k=tree.k, codec=tree.codec)
        if isinstance(tree, jref.bitlinear.FusedPackedLinear):
            out["splits"] = tree.splits
        return out
    if isinstance(tree, dict):
        return {k: ({"fq": np.stack([np.asarray(jref.ternary.weight_quant_ste(w))
                                     for w in v["w"]])}
                    if k in ("w_uk", "w_uv") else _numpy_tree(jref, v))
                for k, v in tree.items()}
    return np.asarray(tree)


def _with_lora_b(jref, params, seed):
    rng = np.random.default_rng(seed)

    def walk(t, name=""):
        if isinstance(t, dict):
            if name.startswith("lora_"):
                b = rng.normal(0.0, 0.05, t["b"].shape).astype(np.float32)
                return {"a": t["a"], "b": jref.jnp.asarray(b)}
            return {k: walk(v, k) for k, v in t.items()}
        return t

    return walk(params)


def _models(jref, codec, seed=0, name="falcon3-1b"):
    jcfg = jref.configs.get_smoke_config(name)
    jcfg = dataclasses.replace(jcfg, bitnet=dataclasses.replace(jcfg.bitnet, codec=codec))
    cfg = get_smoke_config(name)
    cfg = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, codec=codec))
    params = _with_lora_b(jref, jref.T.init_params(jref.jax.random.PRNGKey(seed), jcfg), seed)
    jpacked = jref.pack.pack_params(params, jcfg)
    return jcfg, jpacked, cfg, interop.params_from_reference(_numpy_tree(jref, jpacked))


@pytest.mark.parametrize("name", NAMES)
def test_configs_match_reference(jref, name):
    """Every field the port keeps equals the reference's, nested MLA / MoE /
    BitNet fields included; the depth-cut config differs in name and depth
    only."""

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
    l5 = get_config("deepseek-v3-671b-l5")
    same(dataclasses.replace(l5, name="deepseek-v3-671b", n_layers=61),
         jref.configs.get_config("deepseek-v3-671b"))
    assert l5.n_layers == 5 and l5.moe.n_dense_layers == 3


def test_init_params_shapes_match_reference(jref):
    cfg = get_smoke_config("falcon3-1b")
    jparams = jref.T.init_params(jref.jax.random.PRNGKey(0), jref.configs.get_smoke_config(
        "falcon3-1b"))
    carried = interop.params_from_reference(_numpy_tree(jref, jparams))
    mine = T.init_params(cfg, seed=0, device="cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return (tuple(t.shape), t.dtype)

    assert shapes(mine) == shapes(carried)
    lora_b = mine["blocks"][0]["attn"]["lora_v"]["b"]
    assert not lora_b.any()  # B = 0 at init, as in the reference


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("codec", ["pack2", "pack243"])
def test_generate_matches_reference_engine(jref, codec, name):
    jcfg, jpacked, cfg, tparams = _models(jref, codec, seed=1, name=name)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)
    kw = dict(hot_cap=4, max_len=48, slots=3)
    want = jref.engine.Engine(jcfg, jpacked, **kw).generate(jref.jnp.asarray(prompts),
                                                            max_new_tokens=16)
    got = Engine(cfg, tparams, device="cpu", **kw).generate(prompts, max_new_tokens=16)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.traffic == want.traffic
    closed = dr_edram.closed_form_reduction(8 + 16, 4)
    for f in got.finished:
        assert f.seq_len == 24 and abs(f.external_reduction - closed) <= 1e-12


@pytest.mark.parametrize("name", NAMES)
def test_serve_mixed_lengths_matches_reference(jref, name):
    """Grouped admission over fewer slots than requests: mid-decode
    admissions of same-length groups, per-request tokens and ledgers."""
    jcfg, jpacked, cfg, tparams = _models(jref, "pack2", seed=3, name=name)
    rng = np.random.default_rng(4)
    specs = [(5, 6), (8, 4), (5, 7), (3, 5), (8, 9)]
    prompts = [rng.integers(0, cfg.vocab_size, (p,)).astype(np.int32) for p, _ in specs]
    kw = dict(hot_cap=4, max_len=32, slots=2, sync_every=3)
    want = jref.engine.Engine(jcfg, jpacked, **kw).serve(
        [jref.sched.Request(rid=i, tokens=p, max_new_tokens=n)
         for i, (p, (_, n)) in enumerate(zip(prompts, specs))])
    got = Engine(cfg, tparams, device="cpu", **kw).serve(
        [Request(rid=i, tokens=p, max_new_tokens=n) for i, (p, (_, n)) in enumerate(zip(prompts, specs))])
    assert [f.rid for f in got] == [f.rid for f in want]  # same completion order
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert (g.seq_len, g.steps, g.traffic) == (w.seq_len, w.steps, w.traffic)
        closed = dr_edram.closed_form_reduction(g.seq_len, 4)
        assert abs(g.external_reduction - closed) <= 1e-12


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_first_step_logits_match_reference(jref, name):
    jcfg, jpacked, cfg, tparams = _models(jref, "pack2", seed=5, name=name)
    prompts = np.random.default_rng(6).integers(0, cfg.vocab_size, (3, 11)).astype(np.int32)
    jl, jcache = jref.T.prefill(jpacked, jcfg, {"tokens": jref.jnp.asarray(prompts)},
                                hot_cap=4, max_len=24)
    tl, tcache = T.prefill(tparams, cfg, torch.from_numpy(prompts), hot_cap=4, max_len=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    first = np.asarray(jl).argmax(-1).astype(np.int32)
    assert np.array_equal(tl.numpy().argmax(-1), first)
    jl1, _ = jref.T.decode_step(jpacked, jcfg, jref.jnp.asarray(first), jcache)
    tl1, tcache = T.decode_step(tparams, cfg, torch.from_numpy(first), tcache)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), **LOGIT_TOL)
    assert sum(len(c.lengths) for c in tcache.values()) == cfg.n_layers
    assert all(c.lengths.tolist() == [[12] * 3] * len(c.lengths) for c in tcache.values())


@pytest.mark.parametrize("name", NAMES)
def test_kv_token_bytes_match_reference_engine(jref, name):
    """The ledger's bytes per token: GQA k and v of every layer, or MLA's
    latent row (kv_lora_rank + rope dims) per layer, at 2 bytes a value."""
    jcfg, jpacked, cfg, tparams = _models(jref, "pack2", seed=0, name=name)
    want = jref.engine.Engine(jcfg, jpacked, hot_cap=4, max_len=16)._kv_token_bytes()
    assert Engine(cfg, tparams, hot_cap=4, max_len=16, device="cpu")._kv_token_bytes() == want
    if name == "deepseek-v3-671b":
        assert want == (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * 2 * cfg.n_layers


def test_ledger_and_dr_model_match_reference(jref):
    lengths = np.arange(0, 40, dtype=np.int32)
    for hot in (0, 4, 32):
        want = jref.kvc.step_traffic_tokens(jref.jnp.asarray(lengths), hot)
        got = kv_cache.step_traffic_tokens(torch.from_numpy(lengths), hot)
        for k in kv_cache.TRAFFIC_KEYS:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        for p in (0, 1, 5, 33, 128):
            assert kv_cache.prompt_traffic_tokens(p, hot) == jref.kvc.prompt_traffic_tokens(p, hot)
            for pre in (0, 3, 40):
                assert (kv_cache.prompt_traffic_tokens_resumed(p, pre, hot)
                        == jref.kvc.prompt_traffic_tokens_resumed(p, pre, hot))
    for s, b in ((128, 32), (64, 8), (10, 20), (1, 1)):
        assert dr_edram.closed_form_reduction(s, b) == jref.dr.closed_form_reduction(s, b)
        assert dataclasses.asdict(dr_edram.simulate(s, b)) == dataclasses.asdict(
            jref.dr.simulate(s, b))
    assert dr_edram.closed_form_reduction(128, 32) == 0.436046511627907
    ledger = {"ondie_read": 3, "ext_read": 5, "ondie_write": 1, "ext_write": 2}
    assert kv_cache.external_reduction(ledger) == jref.kvc.external_reduction(ledger)


def test_scheduler_groups_like_reference(jref):
    lens = [4, 6, 4, 4, 2, 6]
    mine, theirs = SlotScheduler(3), jref.sched.SlotScheduler(3)
    reqs = [(Request(i, np.zeros(n, np.int32), 1), jref.sched.Request(i, np.zeros(n, np.int32), 1))
            for i, n in enumerate(lens)]
    for a, b in reqs:
        mine.submit(a)
        theirs.submit(b)
    for _ in range(4):
        s1, g1 = mine.next_group()
        s2, g2 = theirs.next_group()
        assert s1 == s2 and [r.rid for r in g1] == [r.rid for r in g2]
        if s1:
            mine.retire(s1[0])
            theirs.retire(s2[0])


def test_temperature_sampling_is_seeded():
    cfg = get_smoke_config("falcon3-1b")
    params = T.init_params(cfg, seed=0, device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)

    def run(seed):
        eng = Engine(cfg, params, hot_cap=4, max_len=24, slots=2, sample="temperature",
                     temperature=2.0, seed=seed, device="cpu")
        return eng.generate(prompts, max_new_tokens=10).tokens

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert ((a >= 0) & (a < cfg.vocab_size)).all()


def test_interop_carries_bfloat16_bits(jref):
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    jb = np.asarray(jref.jnp.asarray(x).astype(jref.jnp.bfloat16))
    got = interop.to_tensor(jb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), jb.view(np.int16))


def test_entry_points_need_a_device_or_the_cpu_by_name(monkeypatch):
    cfg = get_smoke_config("falcon3-1b")
    params = T.init_params(cfg, seed=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_params(cfg, seed=0)
    with pytest.raises(NotImplementedError):
        Engine(cfg, params, pack=False, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("codec", ["pack2", "pack243"])
def test_cuda_engine_matches_plain_run(codec, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import flash_decode, flash_prefill, ternary_matmul

    cfg = get_smoke_config(name)
    cfg = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, codec=codec))
    params = T.init_params(cfg, seed=0, device="cuda")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 8)).astype(np.int32)
    kernels = ((ternary_matmul.KERNEL, flash_decode.KERNEL, flash_prefill.KERNEL)
               if cfg.attn_type == "full" else
               (ternary_matmul.KERNEL, ternary_matmul.EXPERT_KERNEL, flash_prefill.MLA_KERNEL,
                flash_decode.LATENT_KERNEL))
    before = [k.launches for k in kernels]
    got = Engine(cfg, params, hot_cap=4, max_len=48, slots=3).generate(prompts, max_new_tokens=16)
    assert all(k.launches > n for k, n in zip(kernels, before))
    plain_cfg = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, impl="plain"))
    want = Engine(plain_cfg, params, hot_cap=4, max_len=48, slots=3).generate(
        prompts, max_new_tokens=16)
    assert torch.equal(got.tokens, want.tokens) and got.traffic == want.traffic
