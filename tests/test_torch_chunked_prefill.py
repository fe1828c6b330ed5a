"""Chunked-prefill admission in the port against the reference: kernel 3's
chunked form (``flash_prefill_attention`` with a live cache), the bulk
``kv_cache.append(valid=)``, ``kv_cache.tiered_chunk_attention``, the
layer (``attention_prefill_chunk``), the model step
(``transformer.prefill_chunk_step``), the scheduler's ``next_fills`` and
the engine's chunked admission on falcon3-1b-smoke, with the reference's
engine at the same ``prefill_chunk``.

Inputs come from numpy seeds and cross to both packages; caches cross with
``interop.to_tensor``. Tolerances are those of the port's other tests:
TOL = 2e-5 for f32 attention in another order (rows past a slot's
``valid`` count are padding and are compared only where the reference's
own tests compare them), LOGIT_TOL = 1e-4 for whole-model logits; the
emitted v, appended rows, lengths, tokens and ledgers are exact. The CUDA
kernel runs only on a card: the ``cuda``-marked tests hold it against the
plain version there, bit for bit, and skip here.
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
from repro_torch.kernels import flash_prefill as fp
from repro_torch.models import attention as attn
from repro_torch.models import transformer as T
from repro_torch.models.layers import apply_rope
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request, SlotScheduler
from test_torch_threads import share_cpu_threads  # noqa: F401 (autouse: torch threads per worker)

TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
THETA = 1_000_042.0
NAME = "falcon3-1b"


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import bitlinear as jbitlinear
    from repro.core import kv_cache as jkvc
    from repro.kernels import flash_prefill as jfp
    from repro.models import attention as jattn
    from repro.models import pack as jpack
    from repro.models import transformer as jT
    from repro.serving import engine as jengine
    from repro.serving import scheduler as jsched

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs, bitlinear=jbitlinear,
                                 kvc=jkvc, fp=jfp, attn=jattn, pack=jpack, T=jT,
                                 engine=jengine, sched=jsched)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _tiers(seed, b, hot, cold, g, d, lens, garbage=1.0):
    """Tier arrays (hot_k, hot_v, cold_k, cold_v) and lengths; rows at or
    past each slot's length hold ``garbage`` times random values (NaN in
    the card tests: no version may read them)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hot, g, d), (b, hot, g, d), (b, cold, g, d), (b, cold, g, d))]
    L = np.asarray(lens, np.int32)
    hot_ok = np.arange(hot)[None] < np.minimum(L, hot)[:, None]
    cold_ok = np.arange(cold)[None] < np.clip(L - hot, 0, cold)[:, None]
    for a, ok in zip(arrs, (hot_ok, hot_ok, cold_ok, cold_ok)):
        a[~ok] *= garbage
    return arrs + [L]


def _qkv(seed, b, c, h, g, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, c, h, d), (b, c, g, d), (b, c, g, d)))


def _caches(jref, arrs):
    """The same tier arrays as the reference's cache and the port's."""
    return (jref.kvc.TieredKVCache(*(jref.jnp.asarray(a) for a in arrs)),
            kvc.TieredKVCache(*(interop.to_tensor(a) for a in arrs)))


CASES = [  # the reference's continuation cases (tests/test_flash_prefill.py)
    ([0, 5, 12], [8, 8, 8]),  # offsets at 0 / mid-hot / into cold
    ([4, 16, 7], [8, 3, 0]),  # offset at the hot/cold edge; idle slot
    ([3, 9, 15], [1, 5, 8]),  # partial chunks at every tier boundary
]


@pytest.mark.parametrize("lens,valid", CASES)
def test_chunk_form_matches_pallas_and_xla(jref, lens, valid):
    """The chunked form's plain version against the reference's Pallas
    kernel (interpret mode) and its XLA path: o on valid rows and k_cast
    to TOL, v_cast exactly."""
    b, c, h, g, d = 3, 8, 4, 2, 8
    arrs = _tiers(sum(lens), b, 4, 12, g, d, lens)
    jc, tc = _caches(jref, arrs)
    q, k, v = _qkv(sum(valid), b, c, h, g, d)
    jv = jref.jnp.asarray(np.asarray(valid, np.int32))
    got = fp.flash_prefill_attention(*(torch.from_numpy(a) for a in (q, k, v)), tc,
                                     torch.tensor(valid, dtype=torch.int32), rope_theta=THETA)
    for impl in ("pallas", "xla"):
        want = jref.fp.flash_prefill_attention(
            *(jref.jnp.asarray(a) for a in (q, k, v)), jc, jv, rope_theta=THETA, impl=impl,
            interpret=True, block_q=4, block_s=4)
        for i, n in enumerate(valid):
            np.testing.assert_allclose(got[0][i, :n].numpy(), np.asarray(want[0])[i, :n], **TOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # the plain version reads no row past a slot's length
    tc_nan = kvc.TieredKVCache(*(interop.to_tensor(a) for a in _tiers(
        sum(lens), b, 4, 12, g, d, lens, garbage=float("nan"))))
    again = fp.flash_prefill_attention(*(torch.from_numpy(a) for a in (q, k, v)), tc_nan,
                                       torch.tensor(valid, dtype=torch.int32), rope_theta=THETA)
    for a, b_ in zip(again, got):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("rep,d", [(2, 32), (1, 16), (4, 64)])
def test_aligned_chunks_equal_the_fresh_form_bit_for_bit(rep, d):
    """A 96-token prompt streamed in three 32-chunks over a hot-32 cache
    (each chunk's rows appended before the next) gives the fresh form's
    output, emitted k and v bit for bit: every tile lines up."""
    b, s, g = 2, 96, 2
    q, k, v = (torch.from_numpy(a) for a in _qkv(rep * d, b, s, g * rep, g, d))
    fo, fk, fv = fp.flash_prefill_attention(q, k, v, rope_theta=THETA)
    cache = kvc.init_cache(b, 32, 96, (g, d))
    full = torch.full((b,), 32, dtype=torch.int32)
    outs = []
    for c0 in range(0, s, 32):
        o, k_c, v_c = fp.flash_prefill_attention(q[:, c0:c0 + 32], k[:, c0:c0 + 32],
                                                 v[:, c0:c0 + 32], cache, full, rope_theta=THETA)
        kvc.append(cache, k_c, v_c, valid=full)
        outs.append((o, k_c, v_c))
    for i, want in enumerate((fo, fk, fv)):
        assert torch.equal(torch.cat([out[i] for out in outs], 1), want)
    assert torch.equal(cache.hot_k, fk[:, :32]) and torch.equal(cache.cold_v[:, :64], fv[:, 32:])


@pytest.mark.parametrize("hot,chunks", [(4, [5, 5, 13, 1, 32, 40]), (32, [70, 26]),
                                        (32, [31, 33, 32]), (0, [7, 89])])
@pytest.mark.parametrize("paged", [False, True])
def test_unaligned_chunks_equal_the_fresh_form_bit_for_bit(hot, chunks, paged):
    """A 96-token prompt streamed in chunks of any size over a cache whose
    hot tier is not a multiple of 32 (or empty), contiguous or paged (page
    size 8, shuffled pages), gives the fresh form's output, emitted k and v
    bit for bit: the chunked form tiles [tiers ‖ chunk] at absolute
    positions, as the fresh form tiles the prompt. (A resume at row 70 is
    the prefix-sharing case: a copy-on-write match ending mid-tile.)"""
    b, s, g, rep, d = 2, 96, 2, 2, 16
    q, k, v = (torch.from_numpy(a) for a in _qkv(hot + len(chunks), b, s, g * rep, g, d))
    fo, fk, fv = fp.flash_prefill_attention(q, k, v, rope_theta=THETA)
    if paged:
        cache = kvc.init_paged_cache(b, hot, 128 - hot, (g, d), page_size=8, n_pages=40)
        perm = torch.as_tensor(np.random.default_rng(hot).permutation(40), dtype=torch.int32)
        cache = cache._replace(page_table=perm[cache.page_table.long()])
    else:
        cache = kvc.init_cache(b, hot, 128 - hot, (g, d))
    outs, c0 = [], 0
    for c in chunks:
        full = torch.full((b,), c, dtype=torch.int32)
        o, k_c, v_c = fp.flash_prefill_attention(q[:, c0:c0 + c], k[:, c0:c0 + c],
                                                 v[:, c0:c0 + c], cache, full, rope_theta=THETA)
        kvc.append(cache, k_c, v_c, valid=full)
        outs.append((o, k_c, v_c))
        c0 += c
    assert c0 == s
    for i, want in enumerate((fo, fk, fv)):
        assert torch.equal(torch.cat([out[i] for out in outs], 1), want)


def test_chunk_form_equals_full_causal_attention():
    """The chunked form equals full causal attention over [prefix ‖ chunk]
    at absolute positions, within TOL (an oracle outside both packages'
    tile order)."""
    b, c, h, g, d, hot, cold = 2, 6, 4, 2, 16, 4, 12
    lens = [5, 11]
    pre_k, pre_v = _qkv(1, b, 11, g, g, d)[1:]
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, b, c, h, g, d))
    pre_pos = torch.arange(11)[None].expand(b, -1)
    pre_kr = apply_rope(torch.from_numpy(pre_k), pre_pos, THETA)
    cache = kvc.init_cache(b, hot, cold, (g, d))
    kvc.append(cache, pre_kr, torch.from_numpy(pre_v), valid=torch.tensor(lens))
    o, _, _ = fp.flash_prefill_attention(q, k, v, cache, rope_theta=THETA)
    for i, n in enumerate(lens):
        pos = n + torch.arange(c)[None]
        kk = torch.cat([pre_kr[i:i + 1, :n], apply_rope(k[i:i + 1], pos, THETA)], 1)
        vv = torch.cat([torch.from_numpy(pre_v[i:i + 1, :n]), v[i:i + 1]], 1)
        qr = apply_rope(q[i:i + 1], pos, THETA).double()
        logits = torch.einsum("bchd,bshd->bhcs", qr, kk.double().repeat_interleave(2, 2))
        logits = logits / d ** 0.5
        mask = (n + torch.arange(c))[:, None] >= torch.arange(n + c)[None]
        p = torch.softmax(logits.masked_fill(~mask, -torch.inf), -1)
        want = torch.einsum("bhcs,bshd->bchd", p, vv.double().repeat_interleave(2, 2))
        torch.testing.assert_close(o[i:i + 1].double(), want, **TOL)


@pytest.mark.parametrize("lens,valid", [
    ([0, 2, 4, 9], [6, 3, 0, 6]),  # from empty; across the hot/cold edge; idle slot
    ([1, 3, 5, 0], [2, 1, 4, 0]),  # partial counts
    ([0, 0, 0, 0], None),  # every row of every slot (t = 6 > hot_cap)
])
def test_bulk_append_bit_identical(jref, lens, valid):
    b, t, g, d, hot, cold = 4, 6, 2, 8, 4, 12
    arrs = _tiers(7, b, hot, cold, g, d, lens)
    jc, tc = _caches(jref, arrs)
    _, k, v = _qkv(8, b, t, g, g, d)
    jv = None if valid is None else jref.jnp.asarray(np.asarray(valid, np.int32))
    want = jref.kvc.append(jc, jref.jnp.asarray(k), jref.jnp.asarray(v), valid=jv)
    got = kvc.append(tc, torch.from_numpy(k), torch.from_numpy(v),
                     valid=None if valid is None else torch.tensor(valid, dtype=torch.int32))
    assert got is tc  # in place
    for a, b_ in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))


def test_bulk_append_refuses_the_ring():
    """Over a paged cache, as the reference asserts; the contiguous ring
    append is ported (``test_ring_bulk_append_matches_reference``)."""
    cache = kvc.init_paged_cache(1, 2, 2, (1, 4), page_size=2)
    with pytest.raises(NotImplementedError):
        kvc.append(cache, torch.zeros(1, 1, 1, 4), torch.zeros(1, 1, 1, 4), ring=True)


@pytest.mark.parametrize("lens,valid", CASES[:2])
def test_ring_bulk_append_matches_reference(jref, lens, valid):
    """The chunked admission's ring append (hot 0, a ring of 6 rows) from
    the slot offsets of the chunk cases, bit for bit: only each slot's
    last 6 valid rows write, at (pos - hot_cap) % cold_cap."""
    b, t, g, d = len(lens), 8, 2, 8
    arrs = _tiers(11, b, 0, 6, g, d, lens)
    jc, tc = _caches(jref, arrs)
    _, k, v = _qkv(12, b, t, g, g, d)
    want = jref.kvc.append(jc, jref.jnp.asarray(k), jref.jnp.asarray(v),
                           valid=jref.jnp.asarray(np.asarray(valid, np.int32)), ring=True)
    got = kvc.append(tc, torch.from_numpy(k), torch.from_numpy(v),
                     valid=torch.tensor(valid, dtype=torch.int32), ring=True)
    for a, b_ in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))


@pytest.mark.parametrize("lens,valid", CASES)
def test_tiered_chunk_attention_matches_reference(jref, lens, valid):
    b, c, h, g, d = 3, 8, 4, 2, 16
    arrs = _tiers(sum(lens) + 1, b, 4, 12, g, d, lens)
    jc, tc = _caches(jref, arrs)
    q, k, v = _qkv(sum(valid) + 1, b, c, h, g, d)
    want = jref.kvc.tiered_chunk_attention(
        *(jref.jnp.asarray(a) for a in (q, k, v)), jc,
        jref.jnp.asarray(np.asarray(valid, np.int32)))
    got = kvc.tiered_chunk_attention(*(torch.from_numpy(a) for a in (q, k, v)), tc,
                                     torch.tensor(valid, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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
    """LoRA B factors (zero at init) filled, so the adapters count."""
    rng = np.random.default_rng(seed)

    def walk(t, name=""):
        if isinstance(t, dict):
            if name.startswith("lora_"):
                return {"a": t["a"], "b": jref.jnp.asarray(
                    rng.normal(0.0, 0.05, t["b"].shape).astype(np.float32))}
            return {k: walk(v, k) for k, v in t.items()}
        return t

    return walk(params)


def _models(jref, seed=0, name=NAME):
    """The smoke config's packed parameters in both packages."""
    jcfg = jref.configs.get_smoke_config(name)
    params = _with_lora_b(jref, jref.T.init_params(jref.jax.random.PRNGKey(seed), jcfg), seed)
    jpacked = jref.pack.pack_params(params, jcfg)
    return (jcfg, jpacked, get_smoke_config(name),
            interop.params_from_reference(_numpy_tree(jref, jpacked)))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_attention_prefill_chunk_matches_reference(jref, impl):
    """One layer's chunk: output to TOL, then the appended cache rows to
    TOL (the rotated k) and exactly (v, lengths, untouched rows)."""
    jcfg, _, cfg, _ = _models(jref)
    jcfg = dataclasses.replace(jcfg, bitnet=dataclasses.replace(jcfg.bitnet, impl=impl))
    jp = jref.pack.pack_params({"attn": jref.attn.init_attention(
        jref.jax.random.PRNGKey(4), jcfg)}, jcfg)["attn"]
    tp = interop.from_reference(_numpy_tree(jref, jp))
    b, c, hot, cold = 3, 4, 4, 12
    g, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    lens, valid = [0, 3, 9], [4, 2, 0]
    arrs = _tiers(11, b, hot, cold, g, hd, lens)
    jc, tc = _caches(jref, arrs)
    x = np.random.default_rng(12).standard_normal((b, c, cfg.d_model)).astype(np.float32)
    jy, jc = jref.attn.attention_prefill_chunk(jp, jref.jnp.asarray(x), jcfg, "packed", jc,
                                               jref.jnp.asarray(np.asarray(valid, np.int32)))
    ty, _ = attn.attention_prefill_chunk(tp, torch.from_numpy(x), cfg, tc,
                                         torch.tensor(valid, dtype=torch.int32))
    for i, n in enumerate(valid):
        np.testing.assert_allclose(ty[i, :n].numpy(), np.asarray(jy)[i, :n], **LOGIT_TOL)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    for name in ("hot_k", "cold_k"):
        np.testing.assert_allclose(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                   **TOL)
    for name in ("hot_v", "cold_v"):
        np.testing.assert_allclose(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                   **LOGIT_TOL)


def test_prefill_chunk_step_matches_reference(jref):
    """The model's chunk dispatch over a live cache (one slot mid-prompt,
    one starting, one idle): logits at the slots' last valid rows to
    LOGIT_TOL, cache lengths exact and rows to LOGIT_TOL."""
    jcfg, jpacked, cfg, tparams = _models(jref, seed=2)
    b, c, max_len, hot = 3, 4, 24, 4
    rng = np.random.default_rng(9)
    jcache = jref.T.init_decode_cache(jcfg, b, max_len, hot, dtype=jref.jnp.float32)
    tcache = T.init_decode_cache(cfg, b, max_len, hot, device="cpu")
    for wave, valid in enumerate(([4, 3, 0], [4, 0, 0], [2, 4, 0])):
        toks = rng.integers(0, cfg.vocab_size, (b, c)).astype(np.int32)
        nv = np.asarray(valid, np.int32)
        jl, jcache = jref.T.prefill_chunk_step(jpacked, jcfg, jref.jnp.asarray(toks), jcache,
                                                jref.jnp.asarray(nv))
        tl, tcache = T.prefill_chunk_step(tparams, cfg, torch.from_numpy(toks), tcache,
                                          torch.from_numpy(nv))
        live = nv > 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], **LOGIT_TOL)
        for name, stack in tcache.items():
            want = jcache[name]
            np.testing.assert_array_equal(stack.lengths.numpy(), np.asarray(want.lengths))
            for got, w in zip(stack[:4], want[:4]):
                np.testing.assert_allclose(got.numpy(), np.asarray(w), **LOGIT_TOL)


def test_next_fills_pairs_slots_like_reference(jref):
    """The reference's case: strict arrival order, mixed lengths admit
    together, nothing waits for a same-length partner."""
    mine, theirs = SlotScheduler(3), jref.sched.SlotScheduler(n_slots=3)
    for rid, p_len in [(0, 4), (1, 9), (2, 4), (3, 7)]:
        mine.submit(Request(rid, np.zeros(p_len, np.int32), 8))
        theirs.submit(jref.sched.Request(rid, np.zeros(p_len, np.int32), 8))
    for _ in range(2):
        got, want = mine.next_fills(), theirs.next_fills()
        assert [(s, r.rid) for s, r in got] == [(s, r.rid) for s, r in want]
        assert [r.rid for r in mine.queue] == [r.rid for r in theirs.queue]
    assert [(s, r.rid) for s, r in got] == []  # no free slot
    mine.retire(1)
    theirs.retire(1)
    assert ([(s, r.rid) for s, r in mine.next_fills()]
            == [(s, r.rid) for s, r in theirs.next_fills()] == [(1, 3)])


# ---------------------------------------------------------------------------
# the engine: the reference's chunked-admission scenario on falcon3-1b-smoke
# ---------------------------------------------------------------------------

SPECS = [(70, 5, 9), (71, 12, 3), (72, 4, 6), (73, 13, 8), (74, 1, 5)]  # (seed, prompt, new)
ENGINE_KW = dict(hot_cap=4, max_len=64)


def _requests(vocab, cls=Request):
    return [cls(i, np.random.default_rng(seed).integers(0, vocab, (p,)).astype(np.int32), n)
            for i, (seed, p, n) in enumerate(SPECS)]


@pytest.fixture(scope="module")
def chunked_runs(jref):
    """The five mixed-length requests through the port's chunked engine
    and the reference's, both at prefill_chunk 4, 2 slots, sync_every 3."""
    jcfg, jpacked, cfg, tparams = _models(jref, seed=3)
    want = jref.engine.Engine(jcfg, jpacked, prefill_chunk=4, **ENGINE_KW).serve(
        _requests(cfg.vocab_size, jref.sched.Request), slots=2, sync_every=3)
    eng = Engine(cfg, tparams, prefill_chunk=4, device="cpu", **ENGINE_KW)
    got = eng.serve(_requests(cfg.vocab_size), slots=2, sync_every=3)
    return types.SimpleNamespace(cfg=cfg, params=tparams, eng=eng, got=got, want=want)


def test_chunked_engine_matches_reference_engine(chunked_runs):
    """Same completion order, tokens, lengths, steps and ledgers as the
    reference's chunked engine; each ledger at its closed form."""
    r = chunked_runs
    assert [f.rid for f in r.got] == [f.rid for f in r.want]
    for g, w in zip(r.got, r.want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert (g.seq_len, g.steps, g.traffic) == (w.seq_len, w.steps, w.traffic)
        assert g.seq_len == g.prompt_len + g.steps == g.prompt_len + SPECS[g.rid][2]
        closed = dr_edram.closed_form_reduction(g.seq_len, 4)
        assert abs(g.external_reduction - closed) <= 1e-12
        sim = dr_edram.simulate(g.seq_len, 4)
        tb = r.eng._kv_token_bytes()
        assert g.traffic["ext_read"] == sim.ext_reads * tb
        assert g.traffic["ondie_read"] == sim.die_reads * tb
    assert r.eng.weight_loads == 0
    # one chunk-wave shape for the whole length mix (the reference's one
    # compile of its chunk step)
    assert r.eng.chunk_shapes == {(2, 4)}


def test_chunked_engine_solo_serves_and_grouped_engine_agree(chunked_runs):
    """Each request served alone (one slot) gives the crowded run's tokens,
    adding one wave shape for the new slot count and none for the
    lengths; the port's grouped engine gives the same tokens."""
    r = chunked_runs
    got = {f.rid: f for f in r.got}
    for req in _requests(r.cfg.vocab_size):
        solo = r.eng.serve([Request(99, req.tokens, req.max_new_tokens)], slots=1)[0]
        np.testing.assert_array_equal(got[req.rid].tokens, solo.tokens)
    assert r.eng.chunk_shapes == {(2, 4), (1, 4)}
    grouped = Engine(r.cfg, r.params, device="cpu", **ENGINE_KW)
    for f in grouped.serve(_requests(r.cfg.vocab_size), slots=2, sync_every=3):
        np.testing.assert_array_equal(got[f.rid].tokens, f.tokens)
    assert grouped.chunk_shapes == set()


def test_chunked_engine_slot_reuse(jref):
    """A slot freed mid-serve takes a prompt of another length through
    chunk waves and behaves as a fresh one."""
    _, _, cfg, tparams = _models(jref, seed=3)
    eng = Engine(cfg, tparams, prefill_chunk=4, device="cpu", **ENGINE_KW)
    rng = np.random.default_rng(80)
    a = Request(0, rng.integers(0, cfg.vocab_size, (10,)).astype(np.int32), 4)
    b = Request(1, rng.integers(0, cfg.vocab_size, (7,)).astype(np.int32), 8)
    fin = {f.rid: f for f in eng.serve([a, b], slots=1, sync_every=2)}
    solo_b = eng.serve([Request(9, b.tokens, b.max_new_tokens)], slots=1)[0]
    np.testing.assert_array_equal(fin[1].tokens, solo_b.tokens)
    assert fin[1].seq_len == 7 + 8 and eng.chunk_shapes == {(1, 4)}


def test_generate_through_chunks_matches_reference(jref):
    """``generate`` admits through chunk waves when ``prefill_chunk`` is
    set: the reference engine's tokens, ``steps_per_row`` and
    ``expected_reduction``."""
    jcfg, jpacked, cfg, tparams = _models(jref, seed=1)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 9)).astype(np.int32)
    kw = dict(hot_cap=4, max_len=48, slots=3, prefill_chunk=4)
    jeng = jref.engine.Engine(jcfg, jpacked, **kw)
    want = jeng.generate(jref.jnp.asarray(prompts), max_new_tokens=12, stop_token=7)
    eng = Engine(cfg, tparams, device="cpu", **kw)
    got = eng.generate(prompts, max_new_tokens=12, stop_token=7)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.steps_per_row == want.steps_per_row and got.traffic == want.traffic
    assert eng.chunk_shapes == {(3, 4)}
    for n in (21, 48, 128):
        assert eng.expected_reduction(n) == jeng.expected_reduction(n)


def test_mla_engine_keeps_grouped_admission(jref):
    """deepseek-v3-671b-smoke cannot chunk (MLA): with ``prefill_chunk``
    set the engine says so, as the reference's does, and serves through
    grouped admission with the grouped engine's tokens."""
    jcfg, jpacked, cfg, tparams = _models(jref, seed=1, name="deepseek-v3-671b")
    eng = Engine(cfg, tparams, prefill_chunk=4, device="cpu", **ENGINE_KW)
    jeng = jref.engine.Engine(jcfg, jpacked, prefill_chunk=4, **ENGINE_KW)
    assert eng._chunked_capable() is False and jeng._chunked_capable() is False
    reqs = _requests(cfg.vocab_size)[:3]
    got = eng.serve(reqs, slots=2, sync_every=3)
    want = Engine(cfg, tparams, device="cpu", **ENGINE_KW).serve(
        _requests(cfg.vocab_size)[:3], slots=2, sync_every=3)
    for g, w in zip(got, want):
        assert g.rid == w.rid
        np.testing.assert_array_equal(g.tokens, w.tokens)
    assert eng.chunk_shapes == set()


# ---------------------------------------------------------------------------
# the CUDA kernel against its plain version (card only)
# ---------------------------------------------------------------------------

OFFSETS = [0, 5, 31, 32, 33, 64, 96]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [16, 32, 48])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_cuda_chunk_kernel_bit_identical_to_plain(cuda, rep, d, c, dtype):
    """Hot 32 / cold 96 tiers, slot offsets 0-96 (into the cold tier),
    valid counts 0, 1, C-5, C, tier rows past each length NaN: o (every
    row), k_cast and v_cast equal bit for bit, one launch of the chunked
    entry point and none of the fresh one."""
    b, g = len(OFFSETS), 2
    dt = getattr(torch, dtype)
    arrs = _tiers(rep * d + c, b, 32, 96, g, d, OFFSETS, garbage=float("nan"))
    cache = kvc.TieredKVCache(*(interop.to_tensor(a, cuda).to(dt) for a in arrs[:4]),
                              interop.to_tensor(arrs[4], cuda))
    q, k, v = (torch.from_numpy(a).to(cuda, dt) for a in _qkv(c + d, b, c, g * rep, g, d))
    valid = torch.tensor([0, 1, c - 5, c, c, 1, c - 5], dtype=torch.int32, device=cuda)
    before = (fp.KERNEL.launches, fp.CHUNK_KERNEL.launches)
    got = fp.flash_prefill_attention(q, k, v, cache, valid, rope_theta=THETA)
    torch.cuda.synchronize()
    assert (fp.KERNEL.launches, fp.CHUNK_KERNEL.launches) == (before[0], before[1] + 1)
    want = fp.flash_prefill_attention(q, k, v, cache, valid, rope_theta=THETA, impl="plain")
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [6, 4])
@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_cuda_chunk_kernel_bit_identical_at_falcon_wave_shape(cuda, b, shift, dtype):
    """falcon3-1b's chunk wave (h 8, g 4, d 256, C 32; 6 slots in generate,
    4 in serve), each slot at a wave boundary 0 / 32 / 64 / 96 with valid
    0, 1, C-5 or C: o, k_cast and v_cast equal the plain version bit for
    bit, one chunked launch."""
    c, h, g, d = 32, 8, 4, 256
    offs = [(32 * (i + shift)) % 128 for i in range(b)]
    dt = getattr(torch, dtype)
    arrs = _tiers(b + shift, b, 32, 96, g, d, offs, garbage=float("nan"))
    cache = kvc.TieredKVCache(*(interop.to_tensor(a, cuda).to(dt) for a in arrs[:4]),
                              interop.to_tensor(arrs[4], cuda))
    q, k, v = (torch.from_numpy(a).to(cuda, dt) for a in _qkv(10 + b + shift, b, c, h, g, d))
    valid = torch.tensor([(0, 1, c - 5, c)[i % 4] for i in range(b)], dtype=torch.int32,
                         device=cuda)
    before = (fp.KERNEL.launches, fp.CHUNK_KERNEL.launches)
    got = fp.flash_prefill_attention(q, k, v, cache, valid, rope_theta=THETA)
    torch.cuda.synchronize()
    assert (fp.KERNEL.launches, fp.CHUNK_KERNEL.launches) == (before[0], before[1] + 1)
    want = fp.flash_prefill_attention(q, k, v, cache, valid, rope_theta=THETA, impl="plain")
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_cuda_aligned_chunks_equal_the_fresh_kernel(cuda):
    """falcon3-1b's shape in f32: three chunk launches over a hot-32 cache
    give the fresh kernel's output over the whole 96-token prompt bit for
    bit."""
    b, s, h, g, d = 6, 96, 8, 4, 256
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _qkv(96, b, s, h, g, d))
    fo, _, _ = fp.flash_prefill_attention(q, k, v, rope_theta=THETA)
    cache = kvc.init_cache(b, 32, 96, (g, d), device=cuda)
    full = torch.full((b,), 32, dtype=torch.int32, device=cuda)
    outs = []
    for c0 in range(0, s, 32):
        o, k_c, v_c = fp.flash_prefill_attention(q[:, c0:c0 + 32], k[:, c0:c0 + 32],
                                                 v[:, c0:c0 + 32], cache, full, rope_theta=THETA)
        kvc.append(cache, k_c, v_c, valid=full)
        outs.append(o)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(outs, 1), fo)


@pytest.mark.cuda
def test_cuda_chunked_engine_matches_plain_run(cuda):
    """falcon3-1b-smoke served through chunk waves on the card: the chunk
    kernel launches (never the fresh one) and the tokens and ledgers equal
    the plain chunked run's."""
    cfg = get_smoke_config(NAME)
    params = T.init_params(cfg, seed=0, device="cuda")
    reqs = _requests(cfg.vocab_size)
    before = (fp.KERNEL.launches, fp.CHUNK_KERNEL.launches)
    got = Engine(cfg, params, prefill_chunk=4, **ENGINE_KW).serve(reqs, slots=2, sync_every=3)
    assert fp.KERNEL.launches == before[0] and fp.CHUNK_KERNEL.launches > before[1]
    plain = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, impl="plain"))
    want = Engine(plain, params, prefill_chunk=4, **ENGINE_KW).serve(
        _requests(cfg.vocab_size), slots=2, sync_every=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.traffic == w.traffic


@pytest.mark.cuda
def test_cuda_chunked_and_grouped_admission_part_outside_the_attention(cuda, monkeypatch):
    """falcon3-1b at full width (random packed weights, LoRA B factors
    filled): six 96-token prompts admitted whole (``T.prefill``) and in
    three waves of 32 over a hot-32 cache. Every norm, ternary matmul,
    LoRA delta and attention output of each wave, and the f32 lm_head
    logits of the last wave, are held against the grouped run's rows of
    the same tokens, in call order: no recorded op differs, bit for bit.
    (The two admissions once parted outside the attention, on the LoRA
    products' cuBLAS order, which depends on M: 6 x 96 rows against
    6 x 32; the LoRA kernel's order is fixed per row.)"""
    from repro_torch.configs import get_config
    from repro_torch.core import bitlinear, lora
    from repro_torch.models import layers as L
    from repro_torch.models.pack import pack_params

    cfg = get_config(NAME)
    params = T.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for blk in params["blocks"]:
        for leaf in (blk["attn"]["lora_v"], blk["attn"]["lora_o"], blk["mlp"]["lora_down"]):
            leaf["b"].normal_(0.0, 0.02, generator=gen)
    packed = pack_params(params, cfg)
    del params
    records = []
    for mod, name, label in ((attn, "rms_norm", "attention rms_norm"),
                             (bitlinear, "packed_matmul", "ternary matmul"),
                             (lora, "apply", "LoRA delta"),
                             (attn, "flash_prefill_attention", "attention"),
                             (L, "rms_norm", "MLP rms_norm"),
                             (T, "_lm_logits", "lm_head")):
        def rec(*args, _orig=getattr(mod, name), _label=label, **kw):
            out = _orig(*args, **kw)
            records.append((_label, (out[0] if isinstance(out, tuple) else out).clone()))
            return out
        monkeypatch.setattr(mod, name, rec)

    b, s, c = 6, 96, 32
    toks = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab_size, (b, s)),
                           dtype=torch.int32, device=cuda)
    with torch.inference_mode():
        T.prefill(packed, cfg, toks, hot_cap=32, max_len=128)
        grouped = list(records)
        cache = T.init_decode_cache(cfg, b, 128, 32, device="cuda")
        full = torch.full((b,), c, dtype=torch.int32, device=cuda)
        waves = []
        for c0 in range(0, s, c):
            records.clear()
            T.prefill_chunk_step(packed, cfg, toks[:, c0:c0 + c], cache, full)
            waves.append(list(records))
    differing = []
    for w, recs in enumerate(waves):
        assert [lab for lab, _ in recs] == [lab for lab, _ in grouped]
        for i, ((label, got), (_, want)) in enumerate(zip(recs, grouped)):
            if label == "lm_head":  # the last row of each prompt: the last wave's
                if w == len(waves) - 1 and not torch.equal(got, want):
                    differing.append((w, i, label))
                continue
            want = want.reshape(b, s, -1)[:, w * c:(w + 1) * c]
            if not torch.equal(got.reshape(want.shape), want):
                differing.append((w, i, label))
    assert not differing, differing[:8]
