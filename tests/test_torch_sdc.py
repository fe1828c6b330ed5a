"""The port's SDC plane against the reference's (``tests/test_sdc.py``, at
smoke size: falcon3-1b-smoke, hot 4, max_len 64, page size 8).

* Integrity stamps: ``iter_packed_leaves`` yields the reference's dotted
  paths in its order over the reference's STACKED sizes, although the port
  keeps one dict per layer; each path's crc (the layers' bytes chained)
  equals the reference's ``packed_crc32`` of its stacked leaf; ``wsum``
  agrees with the reference's to the ABFT envelope (64 eps_f32 times the
  positive-term magnitude, ``WSUM_ENVELOPE``), since the two frameworks sum
  in other orders; ``interop`` carries the stamps and refuses one that
  does not match its bytes.
* The ABFT-checked matmul: ``y`` equal to the unchecked path bit for bit
  on clean leaves with every residual within tolerance, a single flip
  caught; the all-ones probe sees flips in the first, middle and last leaf;
  a flip lands on the byte the reference flips; the load-time crc refusal.
* ``kv_cache.pool_page_crcs`` equal to the reference's on the same rows
  (f32, bf16 and fp8 pools).
* The ladders against the JAX engine (one JAX engine for the module, its
  SDC state reset between serves): a weight flip detected within one
  scrub period and repaired, a hand-corrupted page quarantined, a NaN
  upset contained as ``"numerics"``, the raise mode; and the SDC chaos
  serve on seeds 0, 1, 2 with every plane at once: the same tokens,
  outcomes, SDC counters, strikes, quarantined pages and injected
  addresses as the reference engine, finished requests equal a faultless
  serve's and check 9 green every iteration.
* Falsifiability of check 9 and fleet check 6, and the router's SDC
  retirement of a replica that strikes out.
* The handoff byte-fuzz on the port's wire format (seeded, and a
  hypothesis property): a mutated payload raises ``HandoffError`` or
  imports identical state.
* On the card (``cuda`` marker; skipped here): each kernel of the SDC
  path keeps a NaN row non-finite as its plain version does, finite rows
  bit-identical, and the scrub's kernel-4 probe agrees with
  ``impl="plain"``.
"""

import dataclasses
import types
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch import interop
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import bitlinear, packing
from repro_torch.core import kv_cache as kvc
from repro_torch.core.bitlinear import AbftError
from repro_torch.core.kv_cache import HandoffError, pack_slot_state, unpack_slot_state
from repro_torch.kernels import ternary_matmul as tm
from repro_torch.models import pack as pack_lib
from repro_torch.models import transformer as T
from repro_torch.serving import sdc as sdc_lib
from repro_torch.serving.chaos import (ChaosConfig, ChaosInjector, InvariantViolation,
                                       check_fleet_invariants, check_serving_invariants)
from repro_torch.serving.engine import Engine, ServeStats
from repro_torch.serving.paging import PagePool, PrefixCache
from repro_torch.serving.replica import Replica
from repro_torch.serving.router import Router, RouterStats
from repro_torch.serving.scheduler import Request
from test_torch_threads import share_cpu_threads  # noqa: F401 (autouse: torch threads per worker)

HOT, ML, PS = 4, 64, 8
CI_SEEDS = [0, 1, 2]
NAME = "falcon3-1b"
EPS = float(np.finfo(np.float32).eps)
WSUM_ENVELOPE = 64.0  # wsum gap <= WSUM_ENVELOPE * eps_f32 * sum_n |trit * s|


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
    from repro.serving import sdc as jsdc

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs, bitlinear=jbitlinear,
                                 kvc=jkvc, pack=jpack, T=jT, chaos=jchaos, engine=jengine,
                                 sched=jsched, sdc=jsdc)


def _numpy_tree(jref, tree):
    """Reference tree -> numpy, packed leaves as field dicts (stamps too)."""
    if isinstance(tree, (jref.bitlinear.PackedLinear, jref.bitlinear.FusedPackedLinear)):
        out = dict(packed=np.asarray(tree.packed), scale=np.asarray(tree.scale), k=tree.k,
                   codec=tree.codec)
        if isinstance(tree, jref.bitlinear.FusedPackedLinear):
            out["splits"] = tree.splits
        if tree.wsum is not None:
            out["wsum"] = np.asarray(tree.wsum)
        if tree.crc is not None:
            out["crc"] = tree.crc
        return out
    if isinstance(tree, dict):
        return {k: _numpy_tree(jref, v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def setup(jref):
    """The reference's seed-0 smoke weights, packed, unstamped and stamped,
    and both carried into the port."""
    jcfg = jref.configs.get_smoke_config(NAME)
    jpacked = jref.pack.pack_params(jref.T.init_params(jref.jax.random.PRNGKey(0), jcfg), jcfg)
    jstamped = jref.pack.add_integrity(jpacked)
    return SimpleNamespace(
        jcfg=jcfg, jpacked=jpacked, jstamped=jstamped, cfg=get_smoke_config(NAME),
        params=interop.params_from_reference(_numpy_tree(jref, jpacked)),
        stamped=interop.params_from_reference(_numpy_tree(jref, jstamped)))


def _prompt(jref, seed, n, vocab):
    return np.asarray(jref.jax.random.randint(jref.jax.random.PRNGKey(seed), (n,), 0, vocab),
                      np.int32)


def _bytes_of_stack(stack) -> bytes:
    return b"".join(pw.packed.numpy().tobytes() for pw in stack.layers)


# ---------------------------------------------------------------------------
# integrity stamps against the reference's
# ---------------------------------------------------------------------------


def test_packed_leaf_paths_order_and_sizes_equal_the_reference(jref, setup):
    want = [(p, int(np.asarray(pw.packed).size))
            for p, pw in jref.pack.iter_packed_leaves(setup.jstamped)]
    got = [(p, s.size) for p, s in pack_lib.iter_packed_leaves(setup.stamped)]
    assert got == want
    assert [p for p, _ in pack_lib.iter_packed_leaves(setup.params)] == [p for p, _ in want]
    # each path's layers, in order, are the reference's stacked bytes
    for (path, stack), (_, jpw) in zip(pack_lib.iter_packed_leaves(setup.params),
                                       jref.pack.iter_packed_leaves(setup.jpacked)):
        assert _bytes_of_stack(stack) == np.asarray(jpw.packed).tobytes(), path


def test_packed_crc32_per_path_equals_the_reference(jref, setup):
    """The stack's crc chains its layers' bytes in order: the reference's
    crc of the stacked leaf, exactly; a port-stamped tree and the carried
    stamps agree, and a stamp that does not match its bytes is refused."""
    ported = pack_lib.pack_params(setup.params, setup.cfg, integrity=True)
    for (path, stack), (_, jpw), (_, carried) in zip(
            pack_lib.iter_packed_leaves(ported), jref.pack.iter_packed_leaves(setup.jstamped),
            pack_lib.iter_packed_leaves(setup.stamped)):
        assert pack_lib.stack_crc32(stack) == jpw.crc, path
        assert [pw.crc for pw in stack.layers] == [pw.crc for pw in carried.layers]
    assert pack_lib.verify_packed(ported) == []
    bad = _numpy_tree(jref, setup.jstamped)
    bad["blocks"]["attn"]["wo"]["crc"] ^= 1
    with pytest.raises(ValueError, match="blocks.attn.wo"):
        interop.params_from_reference(bad)


def test_wsum_within_the_abft_envelope_of_the_reference(jref, setup):
    """wsum is an f32 sum in another order than the reference's: every
    entry within WSUM_ENVELOPE eps_f32 of its positive-term magnitude (the
    carried wsum is the reference's own)."""
    ported = pack_lib.add_integrity(setup.params)
    for (path, stack), (_, jpw) in zip(pack_lib.iter_packed_leaves(ported),
                                       jref.pack.iter_packed_leaves(setup.jstamped)):
        jw = np.asarray(jpw.wsum)
        for i, pw in enumerate(stack.layers):
            t = packing.unpack(pw.packed, pw.codec, pw.k).float()
            mag = (t.abs() @ pw.scale.float().reshape(-1).expand(t.shape[1]).abs()).numpy()
            gap = np.abs(pw.wsum.numpy() - jw[i])
            assert (gap <= WSUM_ENVELOPE * EPS * mag + 1e-30).all(), (path, i, gap.max())


# ---------------------------------------------------------------------------
# the ABFT-checked matmul and the probe
# ---------------------------------------------------------------------------


def _slices(tree):
    for path, stack in pack_lib.iter_packed_leaves(tree):
        yield path, next(iter(sdc_lib._leaf_slices(stack)))


def test_abft_clean_weights_no_false_positive(setup):
    """On clean plain and fused (per-column scale) leaves: y equals the
    unchecked path bit for bit and every residual is within tol."""
    ported = pack_lib.add_integrity(setup.params)
    fused_seen = False
    for i, (path, sub) in enumerate(_slices(ported)):
        fused_seen |= sub.scale.ndim == 1 and sub.scale.numel() > 1
        x = torch.from_numpy(np.random.default_rng(i).standard_normal((4, sub.k)).astype(
            np.float32))
        y, residual, tol = bitlinear.abft_check(sub, x)
        assert (residual <= tol).all(), path
        assert torch.equal(bitlinear.packed_matmul_checked(sub, x), bitlinear.packed_matmul(sub, x))
        assert torch.equal(y, bitlinear.packed_matmul(sub, x))
    assert fused_seen


def test_abft_detects_single_trit_flip(setup):
    _, sub = next(_slices(pack_lib.add_integrity(setup.params)))
    words = sub.packed.clone()
    words.view(-1)[3] ^= 1
    bad = dataclasses.replace(sub, packed=words)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((4, sub.k)).astype(np.float32))
    with pytest.raises(AbftError, match="row-sum mismatch") as ei:
        bitlinear.packed_matmul_checked(bad, x)
    assert ei.value.row is not None


def test_probe_catches_flips_where_the_reference_flips(jref, setup):
    """The all-ones probe sees a flip in the first, middle and last leaf; a
    clean tree reports nothing; the port's flip lands on the reference's
    byte (the stacked bytes after both flips are equal) and leaves the
    tree it was given unchanged."""
    ported = pack_lib.add_integrity(setup.params)
    assert sdc_lib.abft_verify_tree(ported) == []
    rng = np.random.default_rng(0)
    paths = [p for p, _ in pack_lib.iter_packed_leaves(ported)]
    for path in (paths[0], paths[len(paths) // 2], paths[-1]):
        stack = sdc_lib.get_leaf(ported, path)
        idx, bit = int(rng.integers(stack.size)), int(rng.integers(8))
        before = _bytes_of_stack(stack)
        flipped = sdc_lib.flip_packed_bit(ported, path, idx, bit)
        assert _bytes_of_stack(sdc_lib.get_leaf(ported, path)) == before
        assert sdc_lib.abft_verify_tree(flipped) == [path]
        assert pack_lib.verify_packed(flipped) == [path]
        jflipped = jref.sdc.flip_packed_bit(setup.jstamped, path, idx, bit)
        assert (_bytes_of_stack(sdc_lib.get_leaf(flipped, path))
                == np.asarray(jref.sdc.get_leaf(jflipped, path).packed).tobytes())
        new = sdc_lib.get_leaf(flipped, path)
        assert [pw.packed.shape for pw in new.layers] == [pw.packed.shape for pw in stack.layers]
        diff = np.frombuffer(_bytes_of_stack(new), np.uint8) != np.frombuffer(before, np.uint8)
        assert diff.sum() == 1


def test_engine_refuses_corrupt_weights_at_load(setup):
    ported = pack_lib.add_integrity(setup.params)
    path = next(iter(pack_lib.iter_packed_leaves(ported)))[0]
    corrupt = sdc_lib.flip_packed_bit(ported, path, 0, 0)
    with pytest.raises(sdc_lib.WeightFaultError, match="crc32 at load"):
        _engine(setup, corrupt, integrity=sdc_lib.IntegrityConfig())


def test_plain_act_quant_matmul_keeps_a_nan_row_non_finite():
    """The plain versions propagate NaN (torch.amax): a row holding a NaN
    comes out non-finite, every other row as without it. The kernels are
    held to this on the card."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.integers(-1, 2, (64, 48)).astype(np.int8))
    packed = packing.pack(w, "pack2")
    col = torch.rand(48, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    clean = tm.ternary_matmul_actq(x, packed, col, k=64)
    x[1, 5] = float("nan")
    got = tm.ternary_matmul_actq(x, packed, col, k=64)
    assert not torch.isfinite(got[1]).any()
    assert torch.equal(got[[0, 2]], clean[[0, 2]])


# ---------------------------------------------------------------------------
# pool page crcs
# ---------------------------------------------------------------------------

L, B, G, D = 2, 3, 2, 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float8_e4m3fn"])
def test_pool_page_crcs_equal_the_reference(jref, dtype):
    jnp = jref.jnp
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
           "float8_e4m3fn": jnp.float8_e4m3fn}[dtype]
    rng = np.random.default_rng(5)

    def arr(*shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(jdt)

    caches, tcaches = {}, {}
    for key in ("attn_b", "attn"):  # sorted-key order is what chains
        table = np.tile(np.asarray([[5, 2, 7], [1, 0, 3], [4, 6, 0]], np.int32), (L, 1, 1))
        jc = jref.kvc.PagedKVCache(arr(L, B, HOT, G, D), arr(L, B, HOT, G, D),
                                   arr(L, 8, PS, G, D), arr(L, 8, PS, G, D), jnp.asarray(table),
                                   jnp.zeros((L, B), jnp.int32))
        caches[key] = jc
        tcaches[key] = kvc.PagedKVCache(*(interop.to_tensor(np.asarray(a)) for a in jc))
    pages = [6, 1, 3, 0]
    want = jref.kvc.pool_page_crcs(caches, pages)
    assert kvc.pool_page_crcs(tcaches, pages) == want
    assert len(set(want.values())) == len(pages)
    # one flipped bit anywhere in a page's storage changes its crc only
    tcaches["attn"].pool_v.view(torch.uint8)[1, 3, 5, 0, 2] ^= 1
    got = kvc.pool_page_crcs(tcaches, pages)
    assert [p for p in pages if got[p] != want[p]] == [3]


# ---------------------------------------------------------------------------
# the engines: one JAX engine for the module, its SDC state reset per serve
# ---------------------------------------------------------------------------


def _engine(setup, params=None, integrity=None, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("sync_every", 2)
    return Engine(setup.cfg, setup.params if params is None else params, hot_cap=HOT,
                  max_len=ML, prefill_chunk=4, paged=True, page_size=PS, integrity=integrity,
                  device="cpu", **kw)


@pytest.fixture(scope="module")
def sides(jref, setup):
    """Both packages' engine makers and request makers. The JAX engine is
    built once (its jitted steps compile once); each serve starts from
    its clean stamped weights, no strikes and the given config."""
    jeng = jref.engine.Engine(setup.jcfg, setup.jpacked, hot_cap=HOT, max_len=ML,
                              prefill_chunk=4, paged=True, page_size=PS, slots=3, sync_every=2,
                              integrity=jref.sdc.IntegrityConfig())
    jclean = jeng.params

    def jengine(integrity=None):
        jeng.params, jeng.integrity = jclean, integrity
        jeng.weight_fault_strikes, jeng.unhealthy, jeng.weight_loads = 0, False, 0
        return jeng

    vocab = setup.cfg.vocab_size
    prompts = [_prompt(jref, 400 + i, 6 + i, vocab) for i in range(5)]

    def reqs(cls, n=4, budget=12):
        return [cls(i, prompts[i].copy(), budget) for i in range(n)]

    port = SimpleNamespace(engine=lambda integrity=None: _engine(setup, integrity=integrity),
                           sdc=sdc_lib, pack=pack_lib, chaos=SimpleNamespace(
                               ChaosConfig=ChaosConfig, ChaosInjector=ChaosInjector,
                               check=check_serving_invariants),
                           reqs=lambda **kw: reqs(Request, **kw), flip_page=_flip_page_port)
    ref = SimpleNamespace(engine=jengine, sdc=jref.sdc, pack=jref.pack, chaos=SimpleNamespace(
                              ChaosConfig=jref.chaos.ChaosConfig,
                              ChaosInjector=jref.chaos.ChaosInjector,
                              check=jref.chaos.check_serving_invariants),
                          reqs=lambda **kw: reqs(jref.sched.Request, **kw),
                          flip_page=lambda ctx: _flip_page_ref(jref, ctx))
    return port, ref


def _flip_page_port(ctx):
    page = sorted(ctx.page_crc)[0]
    key = next(k for k in sorted(ctx.state.cache)
               if isinstance(ctx.state.cache[k], kvc.PagedKVCache))
    cache = ctx.state.cache[key]
    kp, vp = kvc.gather_pool_pages(cache, [page])
    kp.view(torch.uint8).view(-1)[0] ^= 0x10
    kvc.write_pool_pages(cache, [page], kp, vp)
    return page


def _flip_page_ref(jref, ctx):
    page = sorted(ctx.page_crc)[0]
    key = next(k for k in sorted(ctx.state.cache) if hasattr(ctx.state.cache[k], "page_table"))
    cache = ctx.state.cache[key]
    kp, vp = jref.kvc.gather_pool_pages(cache, [page])
    raw = bytearray(np.ascontiguousarray(kp).tobytes())
    raw[0] ^= 0x10
    kp = np.frombuffer(bytes(raw), dtype=kp.dtype).reshape(kp.shape)
    caches = dict(ctx.state.cache)
    caches[key] = jref.kvc.write_pool_pages(cache, [page], kp, vp)
    ctx.state = ctx.state._replace(cache=caches)
    return page


def _run(side, integrity, hook=None, **req_kw):
    eng = side.engine(integrity)
    ctx = eng.start_session(side.reqs(**req_kw), on_iteration=hook and (lambda c: hook(eng, c)))
    while eng.run_iteration(ctx):
        pass
    eng.finish_session(ctx)
    return eng, ctx


def _ledger(eng, ctx):
    st = ctx.stats
    return dict(
        finished=sorted((f.rid, f.outcome, np.asarray(f.tokens).tolist(), f.n_preemptions)
                        for f in ctx.finished),
        counters=(st.sdc_detected, st.weight_reloads, st.pages_scrubbed, st.slots_quarantined,
                  st.preemptions, eng.weight_fault_strikes, eng.weight_loads),
        quarantined=sorted(int(p) for p in ctx.pool.quarantined))


@pytest.fixture(scope="module")
def clean(sides):
    """A faultless serve's tokens per request count (4 and 2 x 20, 5)."""
    port, ref = sides
    out = {}
    for kw in (dict(), dict(n=2, budget=20), dict(n=5)):
        got = _ledger(*_run(port, None, **kw))
        assert got == _ledger(*_run(ref, None, **kw))
        out[tuple(kw.items())] = {rid: toks for rid, _, toks, _ in got["finished"]}
    return out


def _assert_clean(ledger, clean_tokens, outcomes=("finished",)):
    for rid, outcome, toks, _ in ledger["finished"]:
        assert outcome in outcomes
        if outcome == "finished":
            assert toks == clean_tokens[rid], rid


def test_weight_fault_detected_repaired_within_one_scrub_period(sides, clean):
    """A stuck ROM bit planted mid-decode is caught by the next scrub (crc
    and the ABFT probe), reloaded from the golden copy, every slot rolls
    back to its verified count, and the tokens are the faultless ones; the
    same counters as the reference's engine."""
    scrub_every = 2
    out = []
    for side in sides:
        planted, detected = [], []

        def hook(eng, ctx, side=side, planted=planted, detected=detected):
            if ctx.iteration == 2 and not planted:
                path = next(iter(side.pack.iter_packed_leaves(eng.params)))[0]
                eng.params = side.sdc.flip_packed_bit(eng.params, path, 5, 2)
                planted.append(ctx.iteration)
            if ctx.stats.weight_reloads and not detected:
                detected.append(ctx.iteration)

        eng, ctx = _run(side, side.sdc.IntegrityConfig(scrub_every=scrub_every), hook)
        assert planted and detected[0] <= planted[0] + scrub_every
        assert ctx.stats.weight_reloads == eng.weight_fault_strikes == 1
        assert side.pack.verify_packed(eng.params) == []  # the golden copy restored
        out.append(_ledger(eng, ctx))
    assert out[0] == out[1]
    _assert_clean(out[0], clean[()])


def test_weight_fault_caught_by_crc_alone_with_the_abft_probe_off(sides, clean, monkeypatch):
    """``abft_probe=False``: the scrub runs no probe, and the crc alone
    catches and repairs the same planted bit; the same ledger as the
    reference's engine with the probe off."""
    def no_probe(*a, **k):
        raise AssertionError("the ABFT probe ran with abft_probe=False")

    monkeypatch.setattr(sdc_lib, "abft_verify_tree", no_probe)
    out = []
    for side in sides:
        planted = []

        def hook(eng, ctx, side=side, planted=planted):
            if ctx.iteration == 2 and not planted:
                path = next(iter(side.pack.iter_packed_leaves(eng.params)))[0]
                eng.params = side.sdc.flip_packed_bit(eng.params, path, 5, 2)
                planted.append(ctx.iteration)

        eng, ctx = _run(side, side.sdc.IntegrityConfig(scrub_every=2, abft_probe=False), hook)
        assert planted and ctx.stats.weight_reloads == eng.weight_fault_strikes == 1
        assert side.pack.verify_packed(eng.params) == []
        out.append(_ledger(eng, ctx))
    assert out[0] == out[1]
    _assert_clean(out[0], clean[()])


def test_hand_corrupted_page_is_quarantined_and_rolled_back(sides, clean):
    out = []
    for side in sides:
        flipped = []

        def hook(eng, ctx, side=side, flipped=flipped):
            if not flipped and ctx.page_crc:
                flipped.append(side.flip_page(ctx))

        eng, ctx = _run(side, side.sdc.IntegrityConfig(scrub_every=1), hook, n=2, budget=20)
        assert flipped and set(flipped) <= ctx.pool.quarantined
        assert ctx.stats.sdc_detected >= 1
        side.chaos.check(ctx, sdc_budget=dict(page_flips=len(flipped)))
        out.append((_ledger(eng, ctx), flipped))
    assert out[0] == out[1]
    _assert_clean(out[0][0], clean[(("n", 2), ("budget", 20))])


def test_numerics_containment_and_transient_repair(sides, clean):
    """One NaN upset: the poked slot ends ``"numerics"``, the others equal
    the faultless serve; 1 poke, exactly 1 containment, in both."""
    out = []
    for side in sides:
        poked = []

        def hook(eng, ctx, side=side, poked=poked):
            if poked:
                return
            decoding = [s for s in ctx.sched.active_slots() if s not in ctx.prefilling]
            if decoding and side.sdc.inject_activation_nan(ctx, decoding[0]):
                poked.append(ctx.sched.slot_req[decoding[0]].rid)

        eng, ctx = _run(side, side.sdc.IntegrityConfig(scrub_every=2), hook)
        assert len(poked) == 1 and ctx.stats.slots_quarantined == 1
        assert {f.rid: f.outcome for f in ctx.finished}[poked[0]] == "numerics"
        side.chaos.check(ctx, sdc_budget=dict(nan_pokes=1))
        out.append((_ledger(eng, ctx), poked))
    assert out[0] == out[1]
    _assert_clean(out[0][0], clean[()], outcomes=("finished", "numerics"))


def test_numerics_raise_mode_names_the_slot(sides):
    slots = []
    for side in sides:
        armed = [True]

        def hook(eng, ctx, side=side, armed=armed):
            decoding = [s for s in ctx.sched.active_slots() if s not in ctx.prefilling]
            if armed[0] and decoding and side.sdc.inject_activation_nan(ctx, decoding[0]):
                armed[0] = False

        with pytest.raises(side.sdc.NumericsError) as ei:
            _run(side, side.sdc.IntegrityConfig(scrub_every=1, on_numerics="raise"), hook)
        slots.append(ei.value.slot)
    assert slots[0] is not None and slots[0] == slots[1]


def test_harvest_resets_the_verified_count_unlike_the_reference(sides):
    """Fault 5 (ROADMAP section 3): the reference keeps a harvested slot's
    verified count, so its next tenant starts with its predecessor's; the
    port resets it at harvest. After every iteration of the same serve the
    port's free slots hold 0, the reference's do not."""
    free = []
    for side in sides:
        counts = []

        def hook(eng, ctx, counts=counts):
            counts.extend(ctx.verified_len[s] for s, r in enumerate(ctx.sched.slot_req)
                          if r is None)

        _run(side, side.sdc.IntegrityConfig(scrub_every=1), hook, n=5)
        free.append(counts)
    assert free[0] and not any(free[0])
    assert any(free[1])


def test_rollback_after_slot_reuse_keeps_the_faultless_tokens(setup):
    """Fault 5's consequence, in the geometry of chip_smoke.py's SDC phase
    (hot 32, max_len 192, page size 32, prefill_chunk 32, 4 slots,
    sync_every 8, eight requests that reuse slots) at smoke width: a bit
    flipped at iteration 2 is caught at the next scrub and every slot rolls
    back to its verified count. Slots that took a new request after a
    harvest roll back to 0, so the tokens equal the faultless serve's on
    8/8; with the reference's stale counts 4/8 were (a CPU run of the
    phase at smoke width)."""
    cfg = setup.cfg
    vocab = cfg.vocab_size
    rng = np.random.default_rng(22)  # chip_smoke.py's paged_requests, drawn the same way
    p = rng.integers(0, vocab, 96).astype(np.int32)

    def tail(n):
        return rng.integers(0, vocab, n).astype(np.int32)

    other = ((p[70:] + 1 + rng.integers(0, vocab - 1, 26)) % vocab).astype(np.int32)
    specs = [(np.concatenate([p, tail(8)]), 24), (tail(50), 24), (tail(77), 24), (tail(5), 24),
             (np.concatenate([p, tail(17)]), 24), (np.concatenate([p, tail(3)]), 24),
             (np.concatenate([p[:70], other, tail(4)]), 24), (np.concatenate([p, tail(40)]), 40)]
    kw = dict(hot_cap=32, max_len=192, prefill_chunk=32, slots=4, sync_every=8, paged=True,
              page_size=32, device="cpu")

    def reqs():
        return [Request(i, t.copy(), n) for i, (t, n) in enumerate(specs)]

    params = T.init_params(cfg, seed=0, pack=True, device="cpu")
    clean = {f.rid: f.tokens for f in Engine(cfg, params, **kw).serve(reqs())}
    eng = Engine(cfg, params, integrity=sdc_lib.IntegrityConfig(scrub_every=4), **kw)
    path = next(iter(pack_lib.iter_packed_leaves(eng.params)))[0]
    planted = []

    def hook(ctx):
        if ctx.iteration == 2 and not planted:
            eng.params = sdc_lib.flip_packed_bit(eng.params, path, 5, 2)
            planted.append(ctx.iteration)

    ctx = eng.start_session(reqs(), on_iteration=hook)
    while eng.run_iteration(ctx):
        pass
    assert planted and ctx.stats.weight_reloads == 1 and ctx.stats.preemptions > 0
    assert sorted(f.rid for f in ctx.finished) == list(range(8))
    for f in ctx.finished:
        assert f.outcome == "finished"
        np.testing.assert_array_equal(f.tokens, clean[f.rid])


# ---------------------------------------------------------------------------
# the ladder end to end: seeded SDC chaos on the three CI seeds
# ---------------------------------------------------------------------------


def _sdc_chaos(side, seed):
    eng = side.engine(side.sdc.IntegrityConfig(scrub_every=2, max_weight_strikes=10 ** 6))
    chaos = side.chaos.ChaosInjector(eng, side.chaos.ChaosConfig(
        seed=seed, weight_flip_rate=0.2, page_decay_rate=0.1, nan_rate=0.1))
    ctx = eng.start_session(side.reqs(n=5), on_iteration=chaos.on_iteration)
    while eng.run_iteration(ctx):
        pass
    chaos.release_all(ctx)
    side.chaos.check(ctx, sdc_budget=chaos.sdc_budget())
    eng.finish_session(ctx)
    return eng, ctx, chaos


@pytest.mark.parametrize("seed", CI_SEEDS)
def test_sdc_chaos_serve_matches_the_reference_engine(sides, clean, seed):
    """All three planes at once, check 9 inside the hook every iteration:
    the port's tokens, outcomes, every SDC counter, strikes, quarantined
    pages and injected addresses (stuck ROM bits, decayed page lives, NaN
    pokes) equal the reference engine's; finished requests equal the
    faultless serve, and every detection is a reload, a quarantined page
    or a contained slot."""
    got, want = (_sdc_chaos(side, seed) for side in sides)
    assert _ledger(got[0], got[1]) == _ledger(want[0], want[1])
    for (_, _, a), (_, _, b) in ((got, want),):
        assert a.sdc_budget() == b.sdc_budget()
        assert a.rom.stuck == b.rom.stuck and a.rom.addresses == b.rom.addresses
        assert a.retention.pages_hit == b.retention.pages_hit
    eng, ctx, chaos = got
    _assert_clean(_ledger(eng, ctx), clean[(("n", 5),)], outcomes=("finished", "numerics"))
    st = ctx.stats
    assert st.sdc_detected == st.weight_reloads + len(ctx.pool.quarantined) + st.slots_quarantined
    assert st.slots_quarantined <= chaos.nan_pokes
    assert sum(chaos.sdc_budget().values()) > 0


def test_sdc_chaos_is_deterministic_per_seed(sides):
    runs = [_sdc_chaos(sides[0], seed=1) for _ in range(2)]
    ledgers = [(_ledger(e, c), ch.sdc_budget(), ch.rom.stuck) for e, c, ch in runs]
    assert ledgers[0] == ledgers[1]


# ---------------------------------------------------------------------------
# falsifiability: check 9 and fleet check 6 catch hand-built violations
# ---------------------------------------------------------------------------


def _fake_ctx(pool, tree=None, slot_pages=(), stats=None):
    return SimpleNamespace(pool=pool, ptree=tree,
                           sched=SimpleNamespace(slot_req=[object()] * len(slot_pages)),
                           slot_pages=[list(p) for p in slot_pages], host_table=None,
                           stats=stats or ServeStats())


def test_checker_catches_quarantined_pages_that_live_on():
    pool = PagePool(4)
    pool.quarantined.add(pool._free[0])  # behind quarantine()'s back: still free
    with pytest.raises(InvariantViolation, match="free list"):
        check_serving_invariants(_fake_ctx(pool))
    pool = PagePool(4)
    [p] = pool.alloc(1)
    pool.quarantined.add(p)
    with pytest.raises(InvariantViolation, match="still mapped by slot"):
        check_serving_invariants(_fake_ctx(pool, slot_pages=[[p]]))
    pool = PagePool(8)
    tree = PrefixCache(pool, hot_cap=2, page_size=2)
    assert tree.insert(np.asarray([1, 2, 3], np.int32), [], lambda ids: None)
    [hot_page] = tree.tree_pages()
    pool.quarantined.add(hot_page)
    with pytest.raises(InvariantViolation, match="prefix tree"):
        check_serving_invariants(_fake_ctx(pool, tree=tree))


def test_checker_catches_faked_repair_counters():
    """Check 9: each repair counter is bounded by its injection budget."""
    budget = dict(weight_asserts=1, page_flips=1, nan_pokes=1)
    with pytest.raises(InvariantViolation, match="weight_reloads"):
        check_serving_invariants(_fake_ctx(PagePool(4), stats=ServeStats(weight_reloads=2)),
                                 sdc_budget=budget)
    pool = PagePool(4)
    q = pool._free.pop()  # delisted, so only the census of check 9 fires
    other = 0 if q else 1
    pool.quarantined.update({q, other})
    pool._free.remove(other)
    with pytest.raises(InvariantViolation, match="quarantined pages exceed"):
        check_serving_invariants(_fake_ctx(pool), sdc_budget=budget)
    with pytest.raises(InvariantViolation, match="slots_quarantined"):
        check_serving_invariants(_fake_ctx(PagePool(4), stats=ServeStats(slots_quarantined=2)),
                                 sdc_budget=budget)
    with pytest.raises(InvariantViolation, match="sdc_detected"):
        check_serving_invariants(_fake_ctx(PagePool(4), stats=ServeStats(sdc_detected=4)),
                                 sdc_budget=budget)
    check_serving_invariants(_fake_ctx(PagePool(4)), sdc_budget=budget)


def test_fleet_checker_catches_fake_sdc_retirement():
    """Check 6: the retirement counter equals the retired set, and an
    SDC-retired replica stays dead, barred and unhealthy."""
    def router(**kw):
        r = SimpleNamespace(finished=[], pending=[], replicas={}, accepted={}, assigned={},
                            attempts={}, stats=RouterStats(), _retired=set(),
                            _sdc_retired=set())
        for k, v in kw.items():
            setattr(r, k, v)
        return r

    with pytest.raises(InvariantViolation, match="sdc_retirements"):
        check_fleet_invariants(router(stats=RouterStats(sdc_retirements=1)))
    rep = SimpleNamespace(name="x", dead=False, ctx=None, engine=SimpleNamespace(unhealthy=True))
    r2 = router(stats=RouterStats(sdc_retirements=1), replicas={"x": rep}, _retired={"x"},
                _sdc_retired={"x"})
    with pytest.raises(InvariantViolation, match="not permanently dead"):
        check_fleet_invariants(r2)  # resurrected
    rep.dead, rep.engine.unhealthy = True, False
    with pytest.raises(InvariantViolation, match="not permanently dead"):
        check_fleet_invariants(r2)  # no longer flagged
    rep.engine.unhealthy = True
    check_fleet_invariants(r2)


# ---------------------------------------------------------------------------
# the fleet: strikes -> unhealthy -> drain and retirement
# ---------------------------------------------------------------------------


def test_repeated_weight_faults_retire_replica_work_survives(sides, clean):
    """A stuck ROM bank on one replica: it strikes out, the router
    warm-migrates its work and retires it for good (fleet check 6 every
    tick), and every request finishes with the faultless tokens on the
    survivor."""
    port, _ = sides

    def mk(strikes):
        return port.engine(sdc_lib.IntegrityConfig(scrub_every=2, max_weight_strikes=strikes))

    reps = [Replica("a", mk(2)), Replica("b", mk(10 ** 6))]
    router = Router(reps, seed=0, sleep=lambda s: None, straggler_drain=False)
    rom = sdc_lib.RomFaultInjector(7, rate=1.0, reassert=None)

    def on_tick(r):
        a = r.replicas["a"]
        if not a.dead and a.ctx is not None:
            rom.on_iteration(a.engine, a.ctx)
        check_fleet_invariants(r)

    fin = {f.rid: f for f in router.serve(port.reqs(), on_tick=on_tick)}
    check_fleet_invariants(router)
    assert router.stats.sdc_retirements == 1 and router._sdc_retired == {"a"}
    assert reps[0].dead and reps[0].engine.unhealthy and not reps[1].dead
    for rid, want in clean[()].items():
        assert fin[rid].outcome == "finished"
        assert np.asarray(fin[rid].tokens).tolist() == want


# ---------------------------------------------------------------------------
# the handoff byte-fuzz: detected or identical, never silently different
# ---------------------------------------------------------------------------


def _handoff_states(seed=0):
    rng = np.random.default_rng(seed)

    def mk(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    return {"attn": {"length": 11, "stacked": True, "hot_k": mk(2, 4, 2, 8),
                     "hot_v": mk(2, 4, 2, 8), "cold_k": mk(2, 7, 2, 8),
                     "cold_v": mk(2, 7, 2, 8)}}


def _states_equal(a, b):
    if sorted(a) != sorted(b):
        return False
    for k in a:
        if any(a[k][f] != b[k][f] for f in ("length", "stacked")):
            return False
        for f in ("hot_k", "hot_v", "cold_k", "cold_v"):
            x, y = a[k][f], b[k][f]
            if x.dtype != y.dtype or x.shape != y.shape or kvc._bytes_of(x) != kvc._bytes_of(y):
                return False
    return True


def _assert_detect_or_identical(payload, mutated, states):
    if mutated == payload:
        return
    try:
        got = unpack_slot_state(mutated)
    except HandoffError:
        return  # detected: the receiver falls back to a cold recompute
    assert _states_equal(got, states), "a mutated handoff imported DIFFERENT state silently"


@given(st.integers(min_value=0, max_value=10 ** 9), st.integers(min_value=1, max_value=255))
@settings(max_examples=60, deadline=None)
def test_handoff_byte_flip_property(pos_seed, xor):
    states = _handoff_states()
    payload = pack_slot_state(states, page_size=4)
    mutated = bytearray(payload)
    mutated[pos_seed % len(payload)] ^= xor
    _assert_detect_or_identical(payload, bytes(mutated), states)


def test_handoff_fuzz_fixed_seeds():
    """The always-running fallback: seeded byte flips over every region of
    the frame (magic, header, dtype names, page chunks, page crcs, the
    trailer) and torn truncations."""
    states = _handoff_states()
    payload = pack_slot_state(states, page_size=4)
    assert _states_equal(unpack_slot_state(payload), states)
    for seed in CI_SEEDS:
        rng = np.random.default_rng(seed)
        for _ in range(60):
            mutated = bytearray(payload)
            mutated[int(rng.integers(len(payload)))] ^= int(rng.integers(1, 256))
            _assert_detect_or_identical(payload, bytes(mutated), states)
        for _ in range(20):  # torn transfers
            cut = int(rng.integers(1, len(payload)))
            with pytest.raises(HandoffError):
                unpack_slot_state(payload[:cut])


# ---------------------------------------------------------------------------
# on the card: the path's kernels keep a NaN row non-finite
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _finite_rows(t):
    return torch.isfinite(t.float()).reshape(t.shape[0], -1).all(dim=-1).cpu().tolist()


def _nan_row_agrees(fn, args, nan_arg, row, cuda):
    """``fn`` on the card, kernel and plain version, with row ``row`` of
    argument ``nan_arg`` poisoned: the same rows finite, the finite rows
    bit-identical, and the poisoned row non-finite."""
    args = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    args[nan_arg][row].view(-1)[0] = float("nan")
    got = fn(*args, impl="auto")
    want = fn(*args, impl="plain")
    torch.cuda.synchronize()
    fin = _finite_rows(want)
    assert _finite_rows(got) == fin and not fin[row]
    keep = torch.as_tensor(fin, device=got.device)
    assert torch.equal(got[keep], want[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(2048, 4096), (2048, 2048), (2048, 16384), (8192, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ternary_kernels_keep_a_nan_row(cuda, k, n, dtype):
    """Kernel 1's act-quant prologue (falcon3-1b's leaf shapes, M 1 / 6 /
    32) and kernel 4 (codes and a NaN row scale): a NaN row stays
    non-finite, every other row bit-identical to the plain version."""
    rng = np.random.default_rng(k + n)
    w = torch.from_numpy(rng.integers(-1, 2, (k, n)).astype(np.int8))
    packed = packing.pack(w, "pack2").to(cuda)
    col = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda)
    for m in (1, 6, 32):
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda, dtype)

        def actq(x, impl):
            return tm.ternary_matmul_actq(x, packed, col, k=k, impl=impl)

        _nan_row_agrees(actq, [x], 0, m // 2, cuda)
        q = tm.act_quant(x.float(), bits=8)

        def known(xs, impl):
            return tm.ternary_matmul_fused(q.xq, packed, xs, col, k=k, impl=impl)

        _nan_row_agrees(known, [q.scale], 0, m - 1, cuda)


@pytest.mark.cuda
def test_cuda_attention_lora_and_norm_kernels_keep_a_nan_row(cuda):
    """A1b (the paged fused decode), A3b (the paged chunked prefill), the
    LoRA kernel and rms_norm at falcon3-1b's head shapes: a slot (row)
    whose input holds a NaN comes out non-finite in kernel and plain
    version alike, every other one bit-identical."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lora as lk
    from repro_torch.kernels import rms_norm as rn

    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)

    x, w = t(6, 2048), t(2048) + 1.0
    _nan_row_agrees(lambda x, impl: rn.rms_norm(x, w, 1e-6, impl=impl), [x], 0, 2, cuda)
    a, b = t(2048, 16) * 0.1, t(16, 2048) * 0.1
    _nan_row_agrees(lambda x, impl: lk.lora_delta(x, a, b, 2.0, impl=impl), [x], 0, 4, cuda)
    cache = kvc.init_paged_cache(4, 32, 160, (4, 256), page_size=32, device=cuda)
    for tier in (cache.hot_k, cache.hot_v, cache.pool_k, cache.pool_v):
        tier.copy_(t(*tier.shape))
    cache.lengths.copy_(torch.tensor([80, 40, 100, 33], dtype=torch.int32, device=cuda))
    q, k_new, v_new = t(4, 8, 256), t(4, 4, 256), t(4, 4, 256)
    active = torch.ones(4, dtype=torch.bool, device=cuda)

    def decode(q, impl):
        c = type(cache)(*(u.clone() for u in cache))
        return fd.flash_decode_attention(q, c, k_new=k_new, v_new=v_new, active=active,
                                         rope_theta=1e6, impl=impl)[0]

    _nan_row_agrees(decode, [q], 0, 1, cuda)
    qc, kc, vc = t(4, 8, 8, 256), t(4, 8, 4, 256), t(4, 8, 4, 256)
    n_valid = torch.tensor([8, 3, 8, 5], dtype=torch.int32, device=cuda)

    def chunk(qc, impl):
        c = type(cache)(*(u.clone() for u in cache))
        return fp.flash_prefill_attention(qc, kc, vc, c, n_valid, impl=impl)[0]

    _nan_row_agrees(chunk, [qc], 0, 2, cuda)


@pytest.mark.cuda
def test_cuda_scrub_probe_agrees_with_plain(cuda):
    """The weight scrub's kernel-4 probe on falcon3-1b's leaf shapes (M =
    1, K 2048 / 8192): clean leaves pass on the kernel as on the plain
    version with the same y, and with a bit flipped the two flag the same
    paths. At this width one trit moves a row sum by about one column
    scale, inside the f32 envelope of a 4096-column row sum, so the probe
    may miss it; the crc always names the path."""
    cfg = dataclasses.replace(get_config(NAME), n_layers=1, vocab_size=256)
    from repro_torch.models import transformer as T

    params = pack_lib.add_integrity(T.init_params(cfg, seed=0, pack=True, device=cuda))
    launches = tm.KNOWN_KERNEL.launches
    assert sdc_lib.abft_verify_tree(params) == sdc_lib.abft_verify_tree(params, impl="plain") == []
    assert tm.KNOWN_KERNEL.launches - launches == 4
    for path, stack in pack_lib.iter_packed_leaves(params):
        sub = stack.layers[0]
        x = torch.ones((1, sub.k), device=cuda)
        got, want = (bitlinear.abft_check(sub, x, impl=i) for i in ("auto", "plain"))
        assert torch.equal(got[0], want[0]), path
        flipped = sdc_lib.flip_packed_bit(params, path, 12345, 3)
        assert sdc_lib.abft_verify_tree(flipped) == sdc_lib.abft_verify_tree(flipped, impl="plain")
        assert pack_lib.verify_packed(flipped) == [path]
