"""The KV handoff wire format and the engine's session API against the
reference's (``repro/core/kv_cache.py`` slot-state serialization,
``repro/serving/engine.py`` drain / abandon / export / import,
``repro/distributed/fault.py::PreemptionGuard``).

* Wire format, both directions, for f32, bf16 and fp8 tiers on tiered and
  paged stacked caches and on the MLA latent cache (an empty v-slot): a
  payload the reference packs unpacks in the port to the same bytes, the
  port's payload of the same rows is the reference's byte for byte, a
  port payload imports into the reference bit for bit, and what the port
  imports (``import_slot_state``, ``write_pool_pages``) reads back
  unchanged (``export_slot_state``, ``gather_pool_pages``).
* Typed errors: a flipped byte (with the reference's ``.key`` /
  ``.page``), a torn payload, trailing bytes, a bad magic, an unknown
  dtype name and a dtype cast all raise ``HandoffError``; fp8 payloads are
  a quarter of f32's and half of bf16's.
* The session API on falcon3-1b-smoke (hot 4, max_len 64, page size 8,
  prefill_chunk 4, 2 slots, sync_every 2), the port's engine beside the
  reference's, built from the same packed weights: ``drain_session``
  (with handoffs), ``import_handoff``, ``abandon_session`` and the
  ``PreemptionGuard`` drain give the same drained rids and folds, seeded
  counts, orphans, tokens, reuse and ledgers, and the resumed tokens equal
  an uninterrupted serve's.
"""

import types
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.core import kv_cache as kvc
from repro_torch.core.kv_cache import HandoffError
from repro_torch.distributed.fault import PreemptionGuard
from repro_torch.serving.chaos import check_serving_invariants
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request
from test_torch_threads import share_cpu_threads  # noqa: F401 (autouse: torch threads per worker)

HOT, ML, PS = 4, 64, 8
NAME = "falcon3-1b"
ARRAYS = ("hot_k", "hot_v", "cold_k", "cold_v")
WIRE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float8_e4m3fn": kvc.FP8}


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import bitlinear as jbitlinear
    from repro.core import kv_cache as jkvc
    from repro.distributed import fault as jfault
    from repro.models import pack as jpack
    from repro.models import transformer as jT
    from repro.serving import engine as jengine
    from repro.serving import scheduler as jsched

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs, bitlinear=jbitlinear,
                                 kvc=jkvc, fault=jfault, pack=jpack, T=jT, engine=jengine,
                                 sched=jsched)


def _bytes(a) -> bytes:
    """The bytes of a reference array or a port tensor."""
    if isinstance(a, torch.Tensor):
        return kvc._bytes_of(a.cpu())
    return np.ascontiguousarray(np.asarray(a)).tobytes()


# ---------------------------------------------------------------------------
# the wire format, on caches built from seeded rows
# ---------------------------------------------------------------------------

L, B, G, D, W = 2, 3, 2, 8, 12  # layers, slots, kv heads, head dim, latent width
LENGTHS = (23, 3, 0)  # past the hot tier into a partial page; hot only; empty
TABLE = ((5, 2, 7), (1, 0, 3), (4, 6, 0))  # each slot's pool pages (shuffled)


def _caches(jref, layout, dtype, seed=0):
    """The same seeded rows as a reference cache and a port cache, stacked
    over L layers: tiered (hot 4, cold 20), paged (hot 4, 8 pages of 8,
    the shuffled ``TABLE``) or the MLA latent cache (tiered, an empty
    v-slot)."""
    jnp = jref.jnp
    rng = np.random.default_rng(seed)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
           "float8_e4m3fn": jnp.float8_e4m3fn}[dtype]
    kshape, vshape = ((W,), (0,)) if layout == "mla" else ((G, D), (G, D))

    def arr(*shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(jdt)

    lengths = np.tile(np.asarray(LENGTHS, np.int32), (L, 1))
    hot = (arr(L, B, HOT, *kshape), arr(L, B, HOT, *vshape))
    if layout == "paged":
        table = np.tile(np.asarray(TABLE, np.int32), (L, 1, 1))
        jc = jref.kvc.PagedKVCache(*hot, arr(L, 8, PS, *kshape), arr(L, 8, PS, *vshape),
                                   jnp.asarray(table), jnp.asarray(lengths))
        tc = kvc.PagedKVCache(*(interop.to_tensor(np.asarray(a)) for a in jc))
    else:
        jc = jref.kvc.TieredKVCache(*hot, arr(L, B, 20, *kshape), arr(L, B, 20, *vshape),
                                    jnp.asarray(lengths))
        tc = kvc.TieredKVCache(*(interop.to_tensor(np.asarray(a)) for a in jc))
    return jc, tc


def _blank(tc):
    """A port cache of ``tc``'s layout with zeroed tiers and lengths (its
    page table kept: an import writes through the slot's current row)."""
    return type(tc)(*(t if name == "page_table" else kvc._zeros(t.shape, t.dtype, None)
                      for name, t in zip(tc._fields, tc)))


@pytest.mark.parametrize("dtype", list(WIRE))
@pytest.mark.parametrize("layout", ["tiered", "paged", "mla"])
def test_wire_payload_byte_identical_both_directions(jref, layout, dtype):
    jc, tc = _caches(jref, layout, dtype)
    jc2, tc2 = _caches(jref, layout, dtype, seed=1)
    for slot in range(B):
        js = {"attn": jref.kvc.export_slot_state(jc, slot),
              "attn_b": jref.kvc.export_slot_state(jc2, slot)}
        ts = {"attn": kvc.export_slot_state(tc, slot), "attn_b": kvc.export_slot_state(tc2, slot)}
        for key in js:
            assert ts[key]["length"] == js[key]["length"] == LENGTHS[slot]
            for name in ARRAYS:
                assert ts[key][name].dtype == WIRE[dtype]
                assert tuple(ts[key][name].shape) == np.asarray(js[key][name]).shape
                assert _bytes(ts[key][name]) == _bytes(js[key][name]), (key, name)
        jblob = jref.kvc.pack_slot_state(js, PS)
        tblob = kvc.pack_slot_state(ts, PS)
        assert tblob == jblob  # the port's payload is the reference's, byte for byte
        back = kvc.unpack_slot_state(jblob)  # reference -> port
        jback = jref.kvc.unpack_slot_state(tblob)  # port -> reference
        for key in js:
            for name in ARRAYS:
                assert _bytes(back[key][name]) == _bytes(js[key][name])
                assert _bytes(jback[key][name]) == _bytes(js[key][name])
        # the reference imports the port's payload bit for bit
        jfresh = jc._replace(**{n: jref.jnp.zeros_like(getattr(jc, n)) for n in jc._fields
                                if n != "page_table"})
        jgot = jref.kvc.export_slot_state(
            jref.kvc.import_slot_state(jfresh, slot, jback["attn"]), slot)
        for name in ARRAYS:
            assert _bytes(jgot[name]) == _bytes(js["attn"][name])
        # the port imports the reference's payload and reads it back unchanged
        fresh = _blank(tc)
        kvc.import_slot_state(fresh, slot, back["attn"])
        got = kvc.export_slot_state(fresh, slot)
        assert got["length"] == LENGTHS[slot]
        for name in ARRAYS:
            assert _bytes(got[name]) == _bytes(js["attn"][name])
    if layout == "paged":
        ids = [6, 1, 3]
        kp, vp = jref.kvc.gather_pool_pages(jc, ids)
        tkp, tvp = kvc.gather_pool_pages(tc, ids)
        assert _bytes(tkp) == _bytes(kp) and _bytes(tvp) == _bytes(vp)
        fresh = _blank(tc)
        kvc.write_pool_pages(fresh, ids, tkp, tvp)
        got_k, got_v = kvc.gather_pool_pages(fresh, ids)
        assert _bytes(got_k) == _bytes(kp) and _bytes(got_v) == _bytes(vp)
        jgot = jref.kvc.gather_pool_pages(jref.kvc.write_pool_pages(
            jc._replace(pool_k=jref.jnp.zeros_like(jc.pool_k),
                        pool_v=jref.jnp.zeros_like(jc.pool_v)), ids, kp, vp), ids)
        assert _bytes(jgot[0]) == _bytes(got_k)


def _errors(unpack, blob):
    """(type name, key, page, message) of each damaged variant of ``blob``."""
    flipped = bytearray(blob)
    flipped[len(blob) // 2] ^= 0xFF
    header = bytearray(blob)
    header[18] ^= 0x01  # the first entry's length: only the trailer catches it
    named = blob.replace(b"float32", b"float31", 1)
    out = []
    for bad in (bytes(flipped), blob[: len(blob) // 3], blob + b"\x00", b"NOPE" + blob[4:],
                bytes(header), named):
        with pytest.raises(Exception) as ei:
            unpack(bad)
        e = ei.value
        out.append((type(e).__name__, e.key, e.page, str(e).split(":")[0]))
    return out


def test_handoff_errors_are_typed_as_in_the_reference(jref):
    jc, tc = _caches(jref, "paged", "float32")
    blob = kvc.pack_slot_state({"attn": kvc.export_slot_state(tc, 0)}, PS)
    got = _errors(kvc.unpack_slot_state, blob)
    want = _errors(jref.kvc.unpack_slot_state, blob)
    assert [g[:3] for g in got] == [w[:3] for w in want]
    assert got[0][1] == "attn" and got[0][2] is not None  # the flip names its page
    msgs = [g[3] for g in got]
    assert "handoff page checksum mismatch" in msgs[0]
    assert msgs[1] == "torn handoff payload" and msgs[2] == "torn handoff payload"
    assert "bad magic" in msgs[3] and "corrupted framing" in msgs[4]
    assert "unknown storage dtype" in msgs[5]
    # an import never casts KV bits
    st = kvc.export_slot_state(tc, 0)
    with pytest.raises(HandoffError, match="dtype"):
        kvc.import_slot_state(tc, 0, dict(st, hot_k=st["hot_k"].to(torch.float16)))
    with pytest.raises(HandoffError, match="dtype"):
        kvc.write_pool_pages(tc, [0], *(t.to(torch.bfloat16)
                                         for t in kvc.gather_pool_pages(tc, [0])))


def test_fp8_payload_is_a_quarter_of_f32_and_half_of_bf16(jref):
    sizes, bodies = {}, {}
    for dtype in WIRE:
        _, tc = _caches(jref, "paged", dtype)
        st = {"attn": kvc.export_slot_state(tc, 0)}
        sizes[dtype] = len(kvc.pack_slot_state(st, PS))
        bodies[dtype] = sum(t.numel() * t.element_size() for t in
                            (st["attn"][n] for n in ARRAYS))
    b8 = bodies["float8_e4m3fn"]
    assert bodies["float32"] == 4 * b8 and bodies["bfloat16"] == 2 * b8
    # the frames differ only by the dtype names' lengths
    assert abs((sizes["float32"] - sizes["float8_e4m3fn"]) - 3 * b8) < 128
    assert abs((sizes["bfloat16"] - sizes["float8_e4m3fn"]) - b8) < 128
    assert sizes["float32"] / sizes["float8_e4m3fn"] > 3.5


# ---------------------------------------------------------------------------
# the session API: the port's engine beside the reference's
# ---------------------------------------------------------------------------


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


@pytest.fixture(scope="module")
def sides(jref):
    """The two packages' paged engines over falcon3-1b-smoke's packed
    weights. The reference's engine is built once (its jitted steps
    compile once) and serves every scenario in a session of its own; the
    port's engines are built per scenario."""
    jcfg = jref.configs.get_smoke_config(NAME)
    jpacked = jref.pack.pack_params(jref.T.init_params(jref.jax.random.PRNGKey(0), jcfg), jcfg)
    cfg = get_smoke_config(NAME)
    params = interop.params_from_reference(_numpy_tree(jref, jpacked))
    kw = dict(hot_cap=HOT, max_len=ML, prefill_chunk=4, paged=True, page_size=PS, slots=2,
              sync_every=2)
    jeng = jref.engine.Engine(jcfg, jpacked, **kw)
    port = SimpleNamespace(Request=Request, engine=lambda **k: Engine(cfg, params, device="cpu",
                                                                      **{**kw, **k}))
    ref = SimpleNamespace(Request=jref.sched.Request, engine=lambda **k: jeng)
    prompts = [np.asarray(jref.jax.random.randint(jref.jax.random.PRNGKey(i), (6 + i,), 0,
                                                  jcfg.vocab_size), np.int32) for i in range(5)]
    return SimpleNamespace(port=port, ref=ref, prompts=prompts, cfg=cfg, params=params, kw=kw)


def _reqs(side, prompts, base=0, budget=10):
    return [side.Request(rid=base + i, tokens=p.copy(), max_new_tokens=budget)
            for i, p in enumerate(prompts)]


def _run(eng, ctx, n):
    for _ in range(n):
        if ctx.sched.idle():
            break
        eng.run_iteration(ctx)


def _tree_only(ctx):
    tree = list(ctx.ptree.tree_pages())
    return all(int(ctx.pool.refs[p]) == tree.count(p) for p in range(ctx.pool.n_pages))


def _fins(fins):
    return {f.rid: (f.outcome, f.tokens.tolist(), f.prefix_tokens_reused, dict(f.traffic),
                    f.n_preemptions, f.prompt_len) for f in fins}


@pytest.fixture(scope="module")
def uninterrupted(sides):
    """The port's tokens of the five requests served without a break."""
    fins = sides.port.engine().serve(_reqs(sides.port, sides.prompts))
    return {f.rid: f.tokens for f in fins}


def _drain_and_resume(side, prompts, iters, corrupt=False):
    """Serve ``iters`` iterations, drain with handoffs, import every payload
    into a fresh session of the same engine, resubmit and serve to the end."""
    eng = side.engine()
    ctx = eng.start_session(_reqs(side, prompts))
    _run(eng, ctx, iters)
    early = list(ctx.finished)
    drained, handoffs = eng.drain_session(ctx, with_handoffs=True)
    folds = [(r.rid, np.asarray(r.tokens).tolist(), r.orig_prompt_len, r.max_new_tokens)
             for r in drained]
    assert ctx.sched.idle() and ctx.drained == drained and _tree_only(ctx)
    eng.finish_session(ctx)
    ctx2 = eng.start_session([])
    seeded, errors = {}, []
    for r in drained:
        if r.rid in handoffs:
            blob = handoffs[r.rid]
            if corrupt:
                blob = bytearray(blob)
                blob[len(blob) // 2] ^= 0xFF
                with pytest.raises(Exception) as ei:
                    eng.import_handoff(ctx2, r.tokens, bytes(blob))
                errors.append((type(ei.value).__name__, ei.value.key, ei.value.page))
            else:
                seeded[r.rid] = eng.import_handoff(ctx2, r.tokens, blob)
        assert eng.submit_to_session(ctx2, r)
    while not ctx2.sched.idle():
        eng.run_iteration(ctx2)
    assert _tree_only(ctx2)
    return dict(folds=folds, handoffs=sorted(handoffs), seeded=seeded, errors=errors,
                early=_fins(early), late=_fins(eng.finish_session(ctx2)),
                sizes={rid: len(b) for rid, b in handoffs.items()})


@pytest.mark.parametrize("iters", [3, 6])
def test_drain_with_handoffs_and_import_match_reference_engine(sides, uninterrupted, iters):
    got = _drain_and_resume(sides.port, sides.prompts, iters)
    want = _drain_and_resume(sides.ref, sides.prompts, iters)
    assert got["folds"] == want["folds"] and got["folds"]
    assert got["handoffs"] == want["handoffs"] and got["handoffs"]
    assert got["sizes"] == want["sizes"]  # the same rows: the same frames
    assert got["seeded"] == want["seeded"] and any(got["seeded"].values())
    assert got["early"] == want["early"] and got["late"] == want["late"]
    folded = {rid: toks for rid, toks, _, _ in got["folds"]}
    for rid, (outcome, toks, reused, _, n_pre, plen) in {**got["early"], **got["late"]}.items():
        assert outcome == "finished" and toks == uninterrupted[rid].tolist()
        if got["seeded"].get(rid):
            # the resumed admission matched at least what was seeded, up to
            # the prefix tree's cap of len - 1
            assert reused >= min(got["seeded"][rid], len(folded[rid]) - 1)


def test_corrupted_handoff_raises_typed_and_resumes_cold(sides, uninterrupted):
    got = _drain_and_resume(sides.port, sides.prompts, 4, corrupt=True)
    want = _drain_and_resume(sides.ref, sides.prompts, 4, corrupt=True)
    assert got["errors"] == want["errors"] and got["errors"]
    assert all(name == "HandoffError" and key is not None for name, key, _ in got["errors"])
    assert got["late"] == want["late"]
    for rid, (outcome, toks, *_rest) in {**got["early"], **got["late"]}.items():
        assert outcome == "finished" and toks == uninterrupted[rid].tolist()


@pytest.mark.parametrize("iters", [1, 4])
def test_abandon_session_matches_reference_engine(sides, iters):
    out = {}
    for name, side in (("port", sides.port), ("ref", sides.ref)):
        eng = side.engine()
        ctx = eng.start_session(_reqs(side, sides.prompts))
        _run(eng, ctx, iters)
        orphans = eng.abandon_session(ctx)
        assert ctx.sched.idle() and _tree_only(ctx)
        assert all(not ps for ps in ctx.slot_pages)
        eng.finish_session(ctx)
        out[name] = [(r.rid, np.asarray(r.tokens).tolist(), r.orig_prompt_len) for r in orphans]
    assert out["port"] == out["ref"] and out["port"]
    # the port's checker passes on the torn-down session too
    eng = sides.port.engine()
    ctx = eng.start_session(_reqs(sides.port, sides.prompts))
    _run(eng, ctx, iters)
    eng.abandon_session(ctx)
    check_serving_invariants(ctx)


def test_preemption_guard_drains_serve_and_resumes_bit_exact(sides, jref, uninterrupted):
    out = {}
    for name, side, guard in (("port", sides.port, PreemptionGuard()),
                              ("ref", sides.ref, jref.fault.PreemptionGuard())):
        eng = side.engine()
        eng.guard = guard  # the reference's serve reads the attribute as the port's does

        def hook(ctx, guard=guard):
            if ctx.iteration == 2:
                guard.request()

        try:
            fins = eng.serve(_reqs(side, sides.prompts, base=900), on_iteration=hook)
        finally:
            eng.guard = None
        assert eng.last_drained and not guard.requested
        drained = eng.last_drained
        assert {r.rid for r in drained}.isdisjoint({f.rid for f in fins})
        fins2 = (side.engine() if name == "ref" else sides.port.engine()).serve(drained)
        out[name] = ([(r.rid, np.asarray(r.tokens).tolist()) for r in drained],
                     _fins(fins), _fins(fins2))
    assert out["port"] == out["ref"]
    for rid, (outcome, toks, *_rest) in {**out["port"][1], **out["port"][2]}.items():
        assert outcome == "finished" and toks == uninterrupted[rid - 900].tolist()


def test_preemption_guard_signal_handler_path():
    import signal

    guard = PreemptionGuard(install_handlers=False)
    assert not guard.requested
    guard._handler(signal.SIGTERM, None)
    assert guard.requested


@pytest.mark.parametrize("fp8", [False, True])
def test_imported_handoff_reads_back_from_the_pool(sides, fp8):
    """After ``import_handoff``, the pages the prefix tree adopted hold the
    payload's rows byte for byte: the full cold pages through
    ``write_pool_pages``, the hot rows in the ``save_hot`` layout of its
    snapshot pages; the wire carries the tier dtype (fp8: one byte)."""
    import dataclasses

    cfg = sides.cfg
    if fp8:
        cfg = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, kv_fp8=True))
    eng = Engine(cfg, sides.params, device="cpu", **sides.kw)
    req = Request(rid=1, tokens=sides.prompts[4].copy(), max_new_tokens=30)
    ctx = eng.start_session([req])
    _run(eng, ctx, 8)
    drained, handoffs = eng.drain_session(ctx, with_handoffs=True)
    [r] = drained
    states = kvc.unpack_slot_state(handoffs[1])
    st = states["attn"]
    assert st["hot_k"].dtype == (kvc.FP8 if fp8 else torch.float32)
    assert st["length"] == len(r.tokens) > HOT + PS
    ctx2 = eng.start_session([])
    seeded = eng.import_handoff(ctx2, r.tokens, handoffs[1])
    kf = (len(r.tokens) - HOT) // PS
    assert seeded == HOT + kf * PS
    m = ctx2.ptree.match(np.asarray(r.tokens, np.int32))
    cache = ctx2.state.cache["attn"]
    cold_k, cold_v = kvc.gather_pool_pages(cache, m.shared_pages[:kf])
    rows = cold_k.shape[0], kf * PS
    assert _bytes(cold_k.reshape(rows + tuple(cold_k.shape[3:]))) == _bytes(
        st["cold_k"][:, : kf * PS])
    assert _bytes(cold_v.reshape(rows + tuple(cold_v.shape[3:]))) == _bytes(
        st["cold_v"][:, : kf * PS])
    hot_k, _ = kvc.gather_pool_pages(cache, m.hot_pages)
    hot_rows = hot_k.reshape((hot_k.shape[0], -1) + tuple(hot_k.shape[3:]))[:, :HOT]
    assert _bytes(hot_rows) == _bytes(st["hot_k"])
    # the resubmitted request resumes from the seeded prefix
    assert eng.submit_to_session(ctx2, r)
    while not ctx2.sched.idle():
        eng.run_iteration(ctx2)
    [fin] = eng.finish_session(ctx2)
    assert fin.outcome == "finished" and fin.prefix_tokens_reused >= seeded - 1


def test_unpaged_engine_ships_no_handoff_and_seeds_nothing(sides, uninterrupted):
    """Handoffs need a paged engine's prefix tree: a contiguous engine
    drains without payloads, ``import_handoff`` seeds 0, and the drained
    requests still resume bit for bit."""
    eng = Engine(sides.cfg, sides.params, device="cpu", **{**sides.kw, "paged": False})
    ctx = eng.start_session(_reqs(sides.port, sides.prompts))
    _run(eng, ctx, 4)
    early = list(ctx.finished)
    drained, handoffs = eng.drain_session(ctx, with_handoffs=True)
    assert drained and handoffs == {}
    payload = kvc.pack_slot_state({"attn": kvc.export_slot_state(ctx.state.cache["attn"], 0)},
                                  PS)
    ctx2 = eng.start_session([])
    assert eng.import_handoff(ctx2, drained[0].tokens, payload) == 0
    for r in drained:
        eng.submit_to_session(ctx2, r)
    while not ctx2.sched.idle():
        eng.run_iteration(ctx2)
    for f in early + eng.finish_session(ctx2):
        assert f.outcome == "finished" and np.array_equal(f.tokens, uninterrupted[f.rid])
