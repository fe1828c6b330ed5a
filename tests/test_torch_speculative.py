"""The port's speculative decoding against the reference's
(``tests/test_speculative.py``'s geometry: falcon3-1b-smoke, hot 4,
max_len 64, prefill_chunk 4, page size 8; the draft from
``make_draft_config``).

* The accept rule against ``repro.serving.speculative.
  longest_accepted_prefix`` on seeded chunks, stop clip and
  ``force_reject`` included, exactly; the ledger of a round against
  ``spec_traffic_tokens``.
* ``kv_cache.truncate`` fuzzed on contiguous and paged caches against a
  from-scratch rebuild (fixed seeds and a hypothesis property).
* ``spec_verify_chunk``: logits and emitted k / v against the
  reference's on carried packed leaves (LOGIT_TOL, as the engine tests),
  the cache left unchanged; row j equal to the decode step's logits bit
  for bit, at smoke size and at falcon3-1b's full width (2 layers).
* The engine: speculative greedy tokens equal the port's non-speculative
  tokens and the JAX speculative engine's, with the same drafted /
  accepted counters and per-request ledgers, for K in {1, 2, 4, 8}
  contiguous and {2, 8} paged (the invariant checker, check 7 included,
  after every iteration); the stop token, full accept with its ledger
  identity, forced reject, cancels mid-speculation and mid-draft-prefill,
  preemption mid-speculation.
* Over the sliding-window ring (mixtral-8x22b-smoke, window 8, as the
  reference's test builds it): the engine against its sequential serve
  and the JAX speculative engine at K in {1, 2, 4, 8}, counters and
  ledgers included, the ring's lengths equal to the draft's, the slot's
  and the host mirror's every iteration; forced reject.
* The gates: vocabulary mismatch, temperature, the MLA fallback warning.
"""

import dataclasses
import random
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch import interop
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import kv_cache
from repro_torch.models import transformer as T
from repro_torch.serving import speculative as spec_lib
from repro_torch.serving.chaos import check_serving_invariants
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request
from test_torch_threads import share_cpu_threads  # noqa: F401 (autouse: torch threads per worker)

HOT, ML, PS = 4, 64, 8
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import bitlinear as jbitlinear
    from repro.core import kv_cache as jkvc
    from repro.models import pack as jpack
    from repro.models import transformer as jT
    from repro.serving import chaos as jchaos
    from repro.serving import engine as jengine
    from repro.serving import scheduler as jsched
    from repro.serving import speculative as jspec

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs, bitlinear=jbitlinear,
                                 kvc=jkvc, pack=jpack, T=jT, chaos=jchaos, engine=jengine,
                                 sched=jsched, spec=jspec)


def _numpy_tree(jref, tree):
    if isinstance(tree, (jref.bitlinear.PackedLinear, jref.bitlinear.FusedPackedLinear)):
        out = dict(packed=np.asarray(tree.packed), scale=np.asarray(tree.scale),
                   k=tree.k, codec=tree.codec)
        if isinstance(tree, jref.bitlinear.FusedPackedLinear):
            out["splits"] = tree.splits
        return out
    if isinstance(tree, dict):
        return {k: _numpy_tree(jref, v) for k, v in tree.items()}
    return np.asarray(tree)


def _with_lora_b(jref, params, seed):
    """LoRA B factors (zero at init) filled with seeded values, so the
    adapters take part."""
    rng = np.random.default_rng(seed)

    def walk(t, name=""):
        if isinstance(t, dict):
            if name.startswith("lora_"):
                b = rng.normal(0.0, 0.05, t["b"].shape).astype(np.float32)
                return {"a": t["a"], "b": jref.jnp.asarray(b)}
            return {k: walk(v, k) for k, v in t.items()}
        return t

    return walk(params)


def _carried(jref, name, lora_seed=None):
    """``name``'s smoke config (the reference's PRNGKey(0) init, LoRA B
    seeded from ``lora_seed`` where given) and its ``make_draft_config``
    draft (PRNGKey(7)), packed by the reference and carried across:
    (jcfg, jparams, jdcfg, jdparams) and the port's."""
    jcfg = jref.configs.get_smoke_config(name)
    jparams = jref.T.init_params(jref.jax.random.PRNGKey(0), jcfg)
    if lora_seed is not None:
        jparams = _with_lora_b(jref, jparams, lora_seed)
    jparams = jref.pack.pack_params(jparams, jcfg)
    jdcfg = jref.spec.make_draft_config(jcfg)
    jdparams = jref.pack.pack_params(jref.T.init_params(jref.jax.random.PRNGKey(7), jdcfg),
                                     jdcfg)
    cfg = get_smoke_config(name)
    dcfg = spec_lib.make_draft_config(cfg)
    port = (cfg, interop.params_from_reference(_numpy_tree(jref, jparams)), dcfg,
            interop.params_from_reference(_numpy_tree(jref, jdparams)))
    return (jcfg, jparams, jdcfg, jdparams), port


@pytest.fixture(scope="module")
def models(jref):
    """falcon3-1b-smoke, LoRA B seeded (``_carried``)."""
    return _carried(jref, "falcon3-1b", lora_seed=0)


@pytest.fixture(scope="module")
def ring_models(jref):
    """mixtral-8x22b-smoke: sliding window 8 over a ring cold tier, MoE
    (``_carried``), as the reference's tests/test_speculative.py builds
    it."""
    return _carried(jref, "mixtral-8x22b")


def _prompts(seed, n_rows, length, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (n_rows, length)).astype(np.int32)


def _kw(paged=False, **kw):
    kw = dict(hot_cap=HOT, max_len=ML, prefill_chunk=4, **kw)
    if paged:
        kw.update(paged=True, page_size=PS)
    return kw


def _port_engine(port, k=0, draft=None, **kw):
    cfg, params, dcfg, dparams = port
    dcfg, dparams = draft or (dcfg, dparams)
    spec = dict(draft_cfg=dcfg, draft_params=dparams, spec_k=k) if k else {}
    return Engine(cfg, params, device="cpu", **spec, **_kw(**kw))


# reference engines by construction: an engine keeps its jitted steps
# (keyed by shape, out_cap = max_len and the stop token), so the tests
# that build one alike share its compiles; every session starts afresh
_REF_ENGINES = {}


def _ref_engine(jref, ref, k=0, draft=None, **kw):
    jcfg, jparams, jdcfg, jdparams = ref
    jdcfg, jdparams = draft or (jdcfg, jdparams)
    key = (id(jparams), id(jdparams), k, tuple(sorted(_kw(**kw).items())))
    if key not in _REF_ENGINES:
        spec = dict(draft_cfg=jdcfg, draft_params=jdparams, spec_k=k) if k else {}
        _REF_ENGINES[key] = jref.engine.Engine(jcfg, jparams, **spec, **_kw(**kw))
    return _REF_ENGINES[key]


def _serve_both(jref, models, reqs, k, port_hook=None, ref_hook=None, serve_kw=None, **kw):
    """Serve ``reqs`` ((rid, prompt, new)) through the port's speculative
    engine and the reference's; return both engines and their records by
    rid."""
    ref, port = models
    serve_kw = serve_kw or {}
    eng = _port_engine(port, k, **kw)
    fin = {f.rid: f for f in eng.serve([Request(r, t, n) for r, t, n in reqs],
                                       on_iteration=port_hook, **serve_kw)}
    jeng = _ref_engine(jref, ref, k, **kw)
    jfin = {f.rid: f for f in jeng.serve([jref.sched.Request(r, t, n) for r, t, n in reqs],
                                         on_iteration=ref_hook, **serve_kw)}
    return eng, fin, jeng, jfin


def _same_records(fin, jfin):
    """Tokens, outcomes, speculation counters and ledgers equal, request by
    request."""
    assert sorted(fin) == sorted(jfin)
    for rid, f in fin.items():
        j = jfin[rid]
        np.testing.assert_array_equal(f.tokens, np.asarray(j.tokens))
        assert (f.outcome, f.seq_len, f.drafted_tokens, f.accepted_tokens, f.traffic) == (
            j.outcome, j.seq_len, j.drafted_tokens, j.accepted_tokens, j.traffic), rid


_BASE_TOKENS = {}


def _base_tokens(models, reqs, **kw):
    """The port's non-speculative serve of ``reqs`` (served once per
    module for each set of requests and engine arguments)."""
    key = (id(models), tuple((r, t.tobytes(), n) for r, t, n in reqs),
           tuple(sorted(kw.items())))
    if key not in _BASE_TOKENS:
        eng = _port_engine(models[1], **kw)
        _BASE_TOKENS[key] = {f.rid: f.tokens
                             for f in eng.serve([Request(r, t, n) for r, t, n in reqs])}
    return _BASE_TOKENS[key]


# ---------------------------------------------------------------------------
# the accept rule and the round's ledger
# ---------------------------------------------------------------------------


def _lap(chunk, greedy, valid, **kw):
    return spec_lib.longest_accepted_prefix(torch.tensor(chunk, dtype=torch.int32),
                                            torch.tensor(greedy, dtype=torch.int32),
                                            torch.tensor(valid, dtype=torch.int32),
                                            **kw).tolist()


def test_accept_rule_reference_cases():
    """The reference test's hand cases: the prefix rule, ``chunk_valid``,
    ``force_reject`` and the stop clip."""
    chunk = [[5, 7, 9, 4]]
    assert _lap(chunk, [[7, 9, 1, 0]], [4]) == [3]
    assert _lap(chunk, [[6, 9, 1, 0]], [4]) == [1]
    assert _lap(chunk, [[7, 9, 4, 2]], [4]) == [4]
    assert _lap(chunk, [[7, 0, 4, 2]], [4]) == [2]
    greedy = [[7, 9, 4, 2]]
    assert [_lap(chunk, greedy, [v]) for v in (2, 1, 0)] == [[2], [1], [0]]
    assert _lap(chunk, greedy, [4], force_reject=True) == [1]
    assert [_lap(chunk, greedy, [4], stop_token=t) for t in (9, 7, 2)] == [[2], [1], [4]]
    assert _lap(chunk, greedy, [2], stop_token=4) == [2]


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("force_reject", [False, True])
def test_accept_rule_matches_reference(jref, k, force_reject):
    """Seeded chunks whose target continuations match the proposals for a
    random run, over every ``chunk_valid`` and stop tokens that do and do
    not occur: the port's counts equal the reference's exactly."""
    rng = np.random.default_rng(100 * k + force_reject)
    slots = 64
    chunk = rng.integers(0, 6, (slots, k)).astype(np.int32)
    greedy = rng.integers(0, 6, (slots, k)).astype(np.int32)
    run = rng.integers(0, k + 1, slots)
    for s in range(slots):  # the target agrees with the first run[s] proposals
        greedy[s, : max(min(run[s], k - 1), 0)] = chunk[s, 1: 1 + max(min(run[s], k - 1), 0)]
    valid = rng.integers(0, k + 1, slots).astype(np.int32)
    for stop in (None, 0, 3, 99):
        got = spec_lib.longest_accepted_prefix(torch.from_numpy(chunk), torch.from_numpy(greedy),
                                               torch.from_numpy(valid), stop, force_reject)
        want = jref.spec.longest_accepted_prefix(jref.jnp.asarray(chunk),
                                                 jref.jnp.asarray(greedy),
                                                 jref.jnp.asarray(valid), stop, force_reject)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_spec_traffic_tokens_matches_reference(jref):
    rng = np.random.default_rng(3)
    lengths = rng.integers(0, 80, 200).astype(np.int32)
    valid = rng.integers(0, 9, 200).astype(np.int32)
    committed = np.minimum(valid, rng.integers(0, 9, 200)).astype(np.int32)
    for hot in (0, 4, 32):
        got = kv_cache.spec_traffic_tokens(torch.from_numpy(lengths), torch.from_numpy(valid),
                                           torch.from_numpy(committed), hot)
        want = jref.kvc.spec_traffic_tokens(jref.jnp.asarray(lengths), jref.jnp.asarray(valid),
                                            jref.jnp.asarray(committed), hot)
        for key in kv_cache.TRAFFIC_KEYS:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


# ---------------------------------------------------------------------------
# kv_cache.truncate: seeded fuzz and a hypothesis property
# ---------------------------------------------------------------------------


def _cache_rows(cache, s, n):
    t = kv_cache.as_tiered(cache) if isinstance(cache, kv_cache.PagedKVCache) else cache
    k = torch.cat([t.hot_k[s], t.cold_k[s]])
    v = torch.cat([t.hot_v[s], t.cold_v[s]])
    return k[:n], v[:n]


def _run_truncate_fuzz(seed, paged):
    """A random append / truncate sequence against a Python mirror after
    every op, then against a cache rebuilt from scratch from the surviving
    rows: truncate forgets the suffix and nothing else."""
    rng = random.Random(seed)
    b, hot, cold, ps, kv_shape = 2, 3, 12, 4, (2,)
    cap = hot + cold

    def fresh():
        if paged:
            return kv_cache.init_paged_cache(b, hot, cold, kv_shape, page_size=ps)
        return kv_cache.init_cache(b, hot, cold, kv_shape)

    cache = fresh()
    hist = [[] for _ in range(b)]
    stamp = 1.0
    for _ in range(rng.randrange(5, 14)):
        if rng.random() < 0.55:
            t = rng.randrange(1, 5)
            valid = torch.zeros((b,), dtype=torch.int32)
            k_new = torch.zeros((b, t) + kv_shape)
            v_new = torch.zeros((b, t) + kv_shape)
            for s in range(b):
                valid[s] = rng.randrange(0, min(t, cap - len(hist[s])) + 1)
                for i in range(int(valid[s])):
                    k_new[s, i], v_new[s, i] = stamp, -stamp
                    hist[s].append(stamp)
                    stamp += 1.0
            kv_cache.append(cache, k_new, v_new, valid=valid)
        else:
            new_len = torch.tensor([rng.randrange(0, len(h) + 1) for h in hist],
                                   dtype=torch.int32)
            kv_cache.truncate(cache, new_len)
            hist = [h[: int(n)] for h, n in zip(hist, new_len)]
        assert cache.lengths.tolist() == [len(h) for h in hist]
        for s in range(b):
            k, v = _cache_rows(cache, s, len(hist[s]))
            want = torch.tensor(hist[s]).reshape(-1, 1).expand(-1, 2)
            assert torch.equal(k, want) and torch.equal(v, -want)
    rebuilt = fresh()
    t_max = max(len(h) for h in hist)
    if t_max:
        k_new = torch.zeros((b, t_max) + kv_shape)
        for s in range(b):
            k_new[s, : len(hist[s])] = torch.tensor(hist[s])[:, None]
        kv_cache.append(rebuilt, k_new, -k_new,
                        valid=torch.tensor([len(h) for h in hist], dtype=torch.int32))
    for s in range(b):
        for a, b_ in zip(_cache_rows(cache, s, len(hist[s])),
                         _cache_rows(rebuilt, s, len(hist[s]))):
            assert torch.equal(a, b_)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_truncate_fuzz_seeded(seed, paged):
    _run_truncate_fuzz(seed, paged)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**30), paged=st.booleans())
def test_truncate_fuzz_property(seed, paged):
    _run_truncate_fuzz(seed, paged)


def test_truncate_stacked_keeps_shorter_slots():
    """On a stacked (L, b) cache a (b,) target broadcasts over the layers,
    and a slot already shorter than its target keeps its length."""
    stack = kv_cache.init_cache(3, 2, 6, (1,), lead=(4,))
    stack.lengths.copy_(torch.tensor([5, 2, 7]).expand(4, 3))
    kv_cache.truncate(stack, torch.tensor([3, 4, 0], dtype=torch.int32))
    assert stack.lengths.tolist() == [[3, 2, 0]] * 4


# ---------------------------------------------------------------------------
# the verify chunk: against the reference, and row j = the decode step's row
# ---------------------------------------------------------------------------


def _fill(cfg, params, cache, prompts, c=4, device="cpu"):
    """Stream ``prompts`` (slots, P) into ``cache`` as chunk waves of ``c``."""
    for c0 in range(0, prompts.shape[1], c):
        part = torch.as_tensor(prompts[:, c0:c0 + c], device=device)
        n = torch.full((prompts.shape[0],), part.shape[1], dtype=torch.int32, device=device)
        T.prefill_chunk_step(params, cfg, part, cache, n)


@pytest.mark.parametrize("paged", [False, True])
def test_verify_chunk_matches_reference(jref, models, paged):
    """After a 12-token prompt (lengths past hot 4, into the second page),
    a 4-token chunk with ``chunk_valid`` 4 / 2 / 0: the port's logits and
    emitted k / v equal the reference's to LOGIT_TOL on the valid rows,
    and the port's cache (rows, lengths, tables) is left as it was."""
    (jcfg, jparams, _, _), (cfg, params, _, _) = models
    prompts, chunk = _prompts(11, 3, 12), _prompts(12, 3, 4)
    valid = np.array([4, 2, 0], np.int32)
    kw = dict(paged=True, page_size=PS) if paged else {}
    cache = T.init_decode_cache(cfg, 3, ML, HOT, device="cpu", **kw)
    _fill(cfg, params, cache, prompts)
    before = {k: [t.clone() for t in c] for k, c in cache.items()}
    with torch.inference_mode():
        logits, kvs = T.spec_verify_chunk(params, cfg, torch.as_tensor(chunk), cache,
                                          torch.as_tensor(valid))
    for name, c in cache.items():
        assert all(torch.equal(a, b) for a, b in zip(c, before[name]))
    jnp = jref.jnp
    jcache = jref.T.init_decode_cache(jcfg, 3, ML, HOT, dtype=jnp.float32, **kw)
    step = jref.jax.jit(lambda p, t, c, n: jref.T.prefill_chunk_step(p, jcfg, t, c, n))
    for c0 in range(0, 12, 4):
        _, jcache = step(jparams, jnp.asarray(prompts[:, c0:c0 + 4]), jcache,
                         jnp.full((3,), 4, jnp.int32))
    jlogits, jkvs = jref.T.spec_verify_chunk(jparams, jcfg, jnp.asarray(chunk), jcache,
                                             jnp.asarray(valid))
    ok = torch.arange(4)[None] < torch.as_tensor(valid)[:, None]  # (slots, K)
    torch.testing.assert_close(logits[ok], torch.from_numpy(np.array(jlogits))[ok],
                               **LOGIT_TOL)
    for name, layers in kvs.items():
        jk, jv = (np.array(a) for a in jkvs[name])
        for i, (k, v) in enumerate(layers):
            torch.testing.assert_close(k[ok], torch.from_numpy(jk[i])[ok], **LOGIT_TOL)
            torch.testing.assert_close(v[ok], torch.from_numpy(jv[i])[ok], **LOGIT_TOL)


def _verify_rows_equal_decode(cfg, params, prompts, chunk, device, fill_chunk=8, **cache_kw):
    """Verify ``chunk`` (slots, K) after ``prompts`` (streamed in chunks of
    ``fill_chunk``); then decode the same tokens one at a time from a copy
    of the cache. Returns both logits (slots, K, V)."""
    slots, k = chunk.shape
    with torch.inference_mode():
        cache = T.init_decode_cache(cfg, slots, cache_kw.pop("max_len"), device=device,
                                    **cache_kw)
        _fill(cfg, params, cache, prompts, c=fill_chunk, device=device)
        toks = torch.as_tensor(chunk, device=device)
        valid = torch.full((slots,), k, dtype=torch.int32, device=device)
        logits, _ = T.spec_verify_chunk(params, cfg, toks, cache, valid)
        dec = []
        for j in range(k):
            lg, _ = T.decode_step(params, cfg, toks[:, j], cache)
            dec.append(lg)
    return logits, torch.stack(dec, dim=1)


@pytest.mark.parametrize("paged", [False, True])
def test_verify_rows_equal_decode_rows_smoke(models, paged):
    """Row j of a K = 4 verify equals the decode step's logits for the same
    token, bit for bit (falcon3-1b-smoke, hot 4, lengths 13 -> 17)."""
    cfg, params, _, _ = models[1]
    kw = dict(paged=True, page_size=PS) if paged else {}
    got, want = _verify_rows_equal_decode(cfg, params, _prompts(21, 3, 13)[:, :12],
                                          _prompts(22, 3, 4), "cpu", max_len=ML, hot_cap=HOT,
                                          **kw)
    assert torch.equal(got, want)


FW_LAYERS = 2


@pytest.fixture(scope="module")
def full_width_params():
    """falcon3-1b at full width (d_model 2048, 8 / 4 heads of 256, d_ff 8192,
    LoRA r16 on v/o/down with seeded B), 2 layers, vocab cut to 32768."""
    cfg = dataclasses.replace(get_config("falcon3-1b"), n_layers=FW_LAYERS, vocab_size=32768)
    params = T.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for blk in params["blocks"]:
        for leaf in (blk["attn"]["lora_v"], blk["attn"]["lora_o"], blk["mlp"]["lora_down"]):
            leaf["b"].normal_(0.0, 0.02, generator=gen)
    from repro_torch.models.pack import pack_params

    return cfg, pack_params(params, cfg)


def _full_width_case(cfg, params, device):
    """A 30-token prompt (one chunk: each pass of the plain version over the
    full-width weights costs seconds) then a K = 4 chunk: verify rows at
    lengths 30-33, across hot_cap 32."""
    prompts = _prompts(60, 2, 30, cfg.vocab_size)
    chunk = _prompts(31, 2, 4, cfg.vocab_size)
    got, want = _verify_rows_equal_decode(cfg, params, prompts, chunk, device, fill_chunk=30,
                                          max_len=64, hot_cap=32)
    assert torch.equal(got, want), (got - want).abs().max()


def test_verify_rows_equal_decode_rows_full_width(full_width_params):
    """At falcon3-1b's full width (2 layers), the plain versions: verify row
    j of a K = 4 chunk equals the decode step's logits bit for bit at
    lengths 30-33, both sides of hot_cap 32."""
    cfg, params = full_width_params
    _full_width_case(cfg, params, "cpu")


@pytest.mark.cuda
def test_verify_rows_equal_decode_rows_full_width_on_card(full_width_params):
    """The same on the card, through the kernels (the chunk form with its
    emit and no append, the fused decode, the ternary, LoRA and rms_norm
    kernels), and the lm_head at the slot count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.models.pack import tree_to

    cfg, params = full_width_params
    _full_width_case(cfg, tree_to(params, "cuda"), "cuda")


# ---------------------------------------------------------------------------
# the engine against its own sequential serve and the reference's engine
# ---------------------------------------------------------------------------


def _reqs(seed, n_rows, length, new):
    return [(i, p, new) for i, p in enumerate(_prompts(seed, n_rows, length))]


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_contiguous_matches_sequential_and_reference(jref, models, k):
    """Speculative greedy tokens equal the port's sequential tokens and the
    JAX speculative engine's, with its drafted / accepted counters and
    ledgers; K = 1 drafts nothing."""
    reqs = _reqs(1, 3, 9, 12)
    eng, fin, jeng, jfin = _serve_both(jref, models, reqs, k, serve_kw=dict(slots=3))
    assert eng.spec and jeng.spec
    _same_records(fin, jfin)
    base = _base_tokens(models, reqs)
    for rid, f in fin.items():
        np.testing.assert_array_equal(f.tokens, base[rid])
    st_, jst = eng.last_stats, jeng.last_stats
    assert (st_.drafted_tokens, st_.accepted_tokens) == (jst.drafted_tokens, jst.accepted_tokens)
    assert st_.accepted_tokens <= st_.drafted_tokens
    assert st_.drafted_tokens == (0 if k == 1 else sum(f.drafted_tokens for f in fin.values()))


@pytest.mark.parametrize("k", [2, 8])
def test_paged_matches_sequential_and_reference(jref, models, k):
    """Paged speculation with the invariant checker (check 7: no page
    stranded by a rollback) after every iteration: tokens equal the paged
    sequential serve's and the JAX engine's, counters and ledgers too."""
    reqs = _reqs(20, 3, 9, 20)
    checked = []

    def hook(ctx):
        check_serving_invariants(ctx)
        checked.append(ctx.iteration)

    eng, fin, jeng, jfin = _serve_both(jref, models, reqs, k, port_hook=hook,
                                       ref_hook=jref.chaos.check_serving_invariants,
                                       serve_kw=dict(slots=3), paged=True)
    _same_records(fin, jfin)
    base = _base_tokens(models, reqs, paged=True)
    for rid, f in fin.items():
        np.testing.assert_array_equal(f.tokens, base[rid])
    assert len(checked) == eng.last_stats.iterations > 0
    assert eng.last_stats.grown_pages == jeng.last_stats.grown_pages


def _ring_reqs(jref):
    """The reference test's SWA case: 3 prompts of 9 tokens from
    PRNGKey(1), 12 new each, so every sequence wraps the ring of 8."""
    prompts = jref.jax.random.randint(jref.jax.random.PRNGKey(1), (3, 9), 0, 256)
    return [(i, np.asarray(p, np.int32), 12) for i, p in enumerate(prompts)]


def _ring_lengths_hook(seen):
    """After every iteration: each decoding slot's ring length equals its
    draft cache's length, its seq_len and the host mirror (a ring commits
    only the accepted rows; the draft alone is truncated)."""
    def hook(ctx):
        st_ = ctx.state
        ring = st_.cache["attn_moe"].lengths[0]
        draft = st_.draft_cache["attn"].lengths[0]
        for s in ctx.sched.active_slots():
            if s in ctx.prefilling or s in ctx.draft_prefilling:
                continue
            assert int(ring[s]) == int(draft[s]) == int(st_.seq_len[s]) == ctx.seq_mirror[s]
            seen.append(int(ring[s]))
    return hook


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_ring_matches_sequential_and_reference(jref, ring_models, k):
    """Speculation over the sliding-window ring (mixtral-8x22b-smoke,
    window 8, hot 4, max_len 64, prefill_chunk 4; the reference test's
    prompts): greedy tokens equal the port's non-speculative serve and the
    JAX speculative engine's, with its drafted / accepted counters and
    ledgers (``spec_traffic_tokens`` charging the committed rows); the ring
    commits only the accepted rows, so its lengths track the draft's, the
    slot's and the host mirror's after every iteration, past the wrap."""
    reqs = _ring_reqs(jref)
    seen = []
    eng, fin, jeng, jfin = _serve_both(jref, ring_models, reqs, k,
                                       port_hook=_ring_lengths_hook(seen),
                                       serve_kw=dict(slots=3))
    assert eng.spec and jeng.spec
    _same_records(fin, jfin)
    base = _base_tokens(ring_models, reqs)
    for rid, f in fin.items():
        np.testing.assert_array_equal(f.tokens, base[rid])
    st_, jst = eng.last_stats, jeng.last_stats
    assert (st_.drafted_tokens, st_.accepted_tokens) == (jst.drafted_tokens, jst.accepted_tokens)
    assert st_.accepted_tokens <= st_.drafted_tokens
    assert st_.drafted_tokens == (0 if k == 1 else sum(f.drafted_tokens for f in fin.values()))
    assert max(seen) > 8  # the rings wrapped while speculating


def test_ring_forced_reject(jref, ring_models):
    """``spec_force="reject"`` over the ring: one token a round, each round
    committing one row to the ring; tokens equal the non-speculative
    serve's, nothing accepted, drafted as the rule gives."""
    k, reqs = 4, _ring_reqs(jref)
    seen = []
    eng = _port_engine(ring_models[1], k, spec_force="reject")
    fin = {f.rid: f for f in eng.serve([Request(r, t, n) for r, t, n in reqs], slots=3,
                                       on_iteration=_ring_lengths_hook(seen))}
    base = _base_tokens(ring_models, reqs)
    drafted = sum(min(k, 12 - r) - 1 for r in range(12))
    for rid, f in fin.items():
        np.testing.assert_array_equal(f.tokens, base[rid])
        assert f.accepted_tokens == 0 and f.drafted_tokens == drafted
    assert max(seen) > 8


def test_stop_token(jref, models):
    """A slot retires where the sequential loop retires it, the stop token
    pending and not emitted, for K = 2 and 4."""
    reqs = _reqs(3, 3, 8, 12)
    free = _base_tokens(models, reqs)
    stop = int(free[0][4])
    seq = _port_engine(models[1]).serve([Request(r, t, n) for r, t, n in reqs], stop_token=stop)
    seq = {f.rid: f for f in seq}
    for k in (2, 4):
        if k == 4:  # the reference engine once (a stop token compiles its own round)
            _, fin, _, jfin = _serve_both(jref, models, reqs, k,
                                          serve_kw=dict(slots=3, stop_token=stop))
            _same_records(fin, jfin)
        else:
            fin = {f.rid: f for f in _port_engine(models[1], k).serve(
                [Request(r, t, n) for r, t, n in reqs], slots=3, stop_token=stop)}
        for rid, f in fin.items():
            np.testing.assert_array_equal(f.tokens, seq[rid].tokens)
            assert f.steps == seq[rid].steps
    assert len(seq[0].tokens) <= 4  # the stop token cut row 0 short


def test_full_accept_and_ledger(jref, models):
    """Draft = target accepts every proposal: a round emits min(K,
    remaining) tokens, so accepted == drafted == new - rounds per request,
    and the stats sum the requests."""
    ref, port = models
    k, new = 4, 14
    reqs = _reqs(5, 2, 9, new)
    eng = _port_engine(port, k, draft=port[:2])
    fin = {f.rid: f for f in eng.serve([Request(r, t, n) for r, t, n in reqs])}
    jeng = _ref_engine(jref, ref, k, draft=ref[:2])
    jfin = {f.rid: f for f in jeng.serve([jref.sched.Request(r, t, n) for r, t, n in reqs])}
    _same_records(fin, jfin)
    base = _base_tokens(models, reqs)
    rounds = -(-new // k)
    for rid, f in fin.items():
        np.testing.assert_array_equal(f.tokens, base[rid])
        assert f.accepted_tokens == f.drafted_tokens == new - rounds
        assert f.acceptance_rate == 1.0 and len(f.tokens) == f.accepted_tokens + rounds
    st_ = eng.last_stats
    assert st_.drafted_tokens == sum(f.drafted_tokens for f in fin.values())
    assert st_.accepted_tokens == sum(f.accepted_tokens for f in fin.values())


@pytest.mark.parametrize("paged", [False, True])
def test_forced_reject(jref, models, paged):
    """``spec_force="reject"``: one token a round through the longest
    rollback; tokens unchanged, nothing accepted, drafted as the rule
    gives, the invariants green when paged."""
    k, new = 4, 12
    reqs = _reqs(6, 2, 9, new)
    eng, fin, _, jfin = _serve_both(
        jref, models, reqs, k, port_hook=check_serving_invariants if paged else None,
        ref_hook=jref.chaos.check_serving_invariants if paged else None,
        paged=paged, spec_force="reject")
    _same_records(fin, jfin)
    base = _base_tokens(models, reqs, paged=paged)
    drafted = sum(min(k, new - r) - 1 for r in range(new))
    for rid, f in fin.items():
        np.testing.assert_array_equal(f.tokens, base[rid])
        assert f.accepted_tokens == 0 and f.drafted_tokens == drafted
        assert f.acceptance_rate == 0.0


def test_cancel_mid_speculation(jref, models):
    """A cancel between rounds harvests a prefix of the uncancelled tokens
    with a sane ledger; the other request finishes unchanged; both engines
    agree."""
    reqs = _reqs(40, 2, 8, 20)
    engines = {}

    def hook(ctx):
        if ctx.iteration == 1:
            engines["eng"].cancel(0)

    def jhook(ctx):
        if ctx.iteration == 1:
            engines["jeng"].cancel(0)

    ref, port = models
    engines["eng"] = eng = _port_engine(port, 4)
    fin = {f.rid: f for f in eng.serve([Request(r, t, n) for r, t, n in reqs], sync_every=2,
                                       on_iteration=hook)}
    engines["jeng"] = jeng = _ref_engine(jref, ref, 4)
    jfin = {f.rid: f for f in jeng.serve([jref.sched.Request(r, t, n) for r, t, n in reqs],
                                         sync_every=2, on_iteration=jhook)}
    _same_records(fin, jfin)
    base = _base_tokens(models, reqs)
    f0 = fin[0]
    assert f0.outcome == "cancelled" and 0 < len(f0.tokens) < 20
    np.testing.assert_array_equal(base[0][: len(f0.tokens)], f0.tokens)
    assert f0.accepted_tokens <= f0.drafted_tokens
    assert fin[1].outcome == "finished"
    np.testing.assert_array_equal(base[1], fin[1].tokens)
    assert eng.last_stats.cancelled == 1
    assert (eng.last_stats.drafted_tokens, eng.last_stats.accepted_tokens) == (
        jeng.last_stats.drafted_tokens, jeng.last_stats.accepted_tokens)


def test_cancel_mid_draft_prefill(models):
    """A cancel while the draft cache still streams its prompt drops both
    prefill trackers; the other request finishes with its tokens."""
    port = models[1]
    long, short = _prompts(50, 1, 24)[0], _prompts(51, 1, 6)[0]
    eng = _port_engine(port, 4)
    seen = []

    def hook(ctx):
        if ctx.iteration == 1:
            seen.append(dict(ctx.draft_prefilling))
            eng.cancel(0)
        check_serving_invariants(ctx)

    fin = {f.rid: f for f in eng.serve([Request(0, long, 8), Request(1, short, 8)], slots=2,
                                       sync_every=1, on_iteration=hook)}
    assert 0 in seen[0]  # rid 0's draft prefill was still streaming
    assert fin[0].outcome == "cancelled" and len(fin[0].tokens) == 0
    assert fin[1].outcome == "finished"
    np.testing.assert_array_equal(fin[1].tokens, _base_tokens(models, [(1, short, 8)])[1])
    ctx = eng._last_ctx
    assert not ctx.prefilling and not ctx.draft_prefilling


def test_preemption_mid_speculation(jref, models):
    """A 6-page pool preempts slots between rounds: recompute-from-prefix
    rebuilds the target and the draft cache, tokens equal the unpressured
    speculative serve's, drafted / accepted carry across attempts, the
    invariants hold every iteration; counters equal the reference
    engine's."""
    reqs = [(i, _prompts(60 + i, 1, 10 + i)[0], 16) for i in range(4)]
    big = _port_engine(models[1], 4, paged=True)
    fin_big = {f.rid: f for f in big.serve([Request(r, t, n) for r, t, n in reqs], slots=2,
                                           sync_every=4)}
    assert big.last_stats.preemptions == 0
    eng, fin, jeng, jfin = _serve_both(jref, models, reqs, 4, port_hook=check_serving_invariants,
                                       ref_hook=jref.chaos.check_serving_invariants,
                                       serve_kw=dict(slots=2, sync_every=4), paged=True,
                                       n_pages=6)
    _same_records(fin, jfin)
    st_, jst = eng.last_stats, jeng.last_stats
    assert st_.preemptions > 0
    assert (st_.preemptions, st_.recompute_tokens, st_.drafted_tokens, st_.accepted_tokens) == (
        jst.preemptions, jst.recompute_tokens, jst.drafted_tokens, jst.accepted_tokens)
    for rid, f in fin.items():
        assert f.outcome == "finished" and f.n_preemptions == jfin[rid].n_preemptions
        np.testing.assert_array_equal(fin_big[rid].tokens, f.tokens)
    assert st_.drafted_tokens == sum(f.drafted_tokens for f in fin.values())
    assert st_.accepted_tokens == sum(f.accepted_tokens for f in fin.values())


def test_round_launch_pattern(models):
    """One round runs K draft decode steps and one verify, and advances
    every active slot by 1..K tokens; the draft cache's lengths track the
    target's at every round boundary."""
    port = models[1]
    eng = _port_engine(port, 4)
    calls = {"draft": 0, "verify": 0}
    lengths = []
    decode, verify = T.decode_step, T.spec_verify_chunk

    def count_decode(*a, **kw):
        calls["draft"] += 1
        return decode(*a, **kw)

    def count_verify(*a, **kw):
        calls["verify"] += 1
        return verify(*a, **kw)

    step = eng._spec_step

    def spy(state, *a):
        step(state, *a)
        lengths.append((state.cache["attn"].lengths.clone(),
                        state.draft_cache["attn"].lengths.clone(), state.seq_len.clone()))

    eng._spec_step = spy
    T.decode_step, T.spec_verify_chunk = count_decode, count_verify
    try:
        eng.serve([Request(r, t, n) for r, t, n in _reqs(8, 2, 6, 6)])
    finally:
        T.decode_step, T.spec_verify_chunk = decode, verify
    assert calls["verify"] == len(lengths) > 0 and calls["draft"] == 4 * len(lengths)
    for target, draft, seq in lengths:
        assert torch.equal(target, draft[: target.shape[0]])
        assert torch.equal(target[0], seq)


# ---------------------------------------------------------------------------
# gates, configs and the tied lm_head
# ---------------------------------------------------------------------------


def test_construction_gates(models):
    cfg, params, dcfg, dparams = models[1]
    kw = dict(prefill_chunk=4, device="cpu")
    with pytest.raises(NotImplementedError, match="greedy-only"):
        Engine(cfg, params, sample="temperature", draft_cfg=dcfg, draft_params=dparams,
               spec_k=4, **kw)
    bad = dataclasses.replace(dcfg, vocab_size=cfg.vocab_size + 1)
    with pytest.raises(ValueError, match="vocab"):
        Engine(cfg, params, draft_cfg=bad, draft_params=dparams, spec_k=4, **kw)
    with pytest.raises(ValueError, match="draft_cfg"):
        Engine(cfg, params, draft_params=dparams, spec_k=4, **kw)
    with pytest.raises(ValueError, match="spec_force"):
        Engine(cfg, params, draft_cfg=dcfg, draft_params=dparams, spec_k=4,
               spec_force="accept", **kw)
    with pytest.raises(NotImplementedError, match="rejection"):
        spec_lib.rejection_sample()
    assert not Engine(cfg, params, draft_cfg=dcfg, draft_params=dparams, spec_k=0, **kw).spec


def test_mla_falls_back_with_warning():
    """MLA cannot chunk: speculation falls back to sequential decode with
    the reference's RuntimeWarning, and nothing is drafted."""
    cfg = get_smoke_config("deepseek-v3-671b")
    params = T.init_params(cfg, seed=0, device="cpu")
    dcfg = spec_lib.make_draft_config(cfg)
    dparams = T.init_params(dcfg, seed=7, device="cpu")
    with pytest.warns(RuntimeWarning, match="falls back"):
        eng = Engine(cfg, params, hot_cap=HOT, max_len=48, prefill_chunk=4, device="cpu",
                     draft_cfg=dcfg, draft_params=dparams, spec_k=4)
    assert not eng.spec and eng.draft_params is None
    res = eng.generate(_prompts(1, 2, 6), max_new_tokens=4)
    assert res.tokens.shape == (2, 4) and eng.last_stats.drafted_tokens == 0


def test_draft_configs_match_reference(jref):
    """falcon3-draft (and its smoke form) and ``make_draft_config`` equal
    the reference's field for field."""
    def same(mine, theirs):
        for f in dataclasses.fields(mine):
            a, b = getattr(mine, f.name), getattr(theirs, f.name)
            if dataclasses.is_dataclass(a):
                same(a, b)
            else:
                assert a == b, f.name

    same(get_config("falcon3-draft"), jref.configs.get_config("falcon3-draft"))
    same(get_smoke_config("falcon3-draft"), jref.configs.get_smoke_config("falcon3-draft"))
    same(spec_lib.make_draft_config(get_smoke_config("falcon3-1b")),
         jref.spec.make_draft_config(jref.configs.get_smoke_config("falcon3-1b")))
    assert get_config("falcon3-draft").tie_embeddings
    assert not get_config("falcon3-1b").tie_embeddings


def test_tied_lm_head_matches_reference(jref):
    """A tied model draws no lm_head (the reference's tree shapes exactly),
    interop carries it, and ``x @ embed.T`` equals the reference's
    ``_lm_logits``."""
    cfg = get_smoke_config("falcon3-draft")
    jcfg = jref.configs.get_smoke_config("falcon3-draft")
    jparams = jref.T.init_params(jref.jax.random.PRNGKey(3), jcfg)
    carried = interop.params_from_reference(_numpy_tree(jref, jparams))
    mine = T.init_params(cfg, seed=0, device="cpu")
    assert "lm_head" not in mine and "lm_head" not in carried

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)

    assert shapes(mine) == shapes(carried)
    x = np.random.default_rng(4).standard_normal((5, cfg.d_model)).astype(np.float32)
    got = T._lm_logits(carried, cfg, torch.from_numpy(x), rows=8)
    want = np.array(jref.T._lm_logits(jparams, jcfg, jref.jnp.asarray(x)))
    assert got.shape == (5, cfg.vocab_size)
    torch.testing.assert_close(got, torch.from_numpy(want), **LOGIT_TOL)
