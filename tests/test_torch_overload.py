"""The port's overload control plane against the reference's
(``tests/test_overload.py``, ``tests/test_scheduler.py``, scenario for
scenario, at smoke size) and recompute-from-prefix at full width.

* Engine scenarios on falcon3-1b-smoke (hot 4, max_len 64, page size 8,
  prefill_chunk 4): the port's engine and the reference's, built from the
  same packed weights and served the same requests, give the same tokens,
  outcomes, ``n_preemptions``, ``prefix_tokens_reused``, traffic ledgers
  and ``ServeStats`` counters; each scenario also keeps the reference
  test's own assertions (bit-exact against the unpressured serve, pages
  returned, invariants green every iteration).
* Recompute-from-prefix at falcon3-1b's full width (4 layers, vocab
  32768): re-admitting prompt ‖ the first k emitted tokens continues with
  the same tokens on every row, because the decode and the chunked
  prefill fold the same absolute key tiles (fault 4).
* The scheduler's claim, priority, ``preempt_victims``, requeue and
  bounded-queue rules; the seeded control-plane fuzz (and its hypothesis
  variant) with the port's invariant checker after every op, the pool's
  refcounts equal to the reference classes' on the same ops.
"""

import dataclasses
import random
import types
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch import interop
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.serving.chaos import InvariantViolation, check_serving_invariants
from repro_torch.serving.engine import Engine
from repro_torch.serving.paging import PagePool, PrefixCache
from repro_torch.serving.scheduler import Request, SchedulerError, SlotScheduler
from test_torch_threads import share_cpu_threads  # noqa: F401 (autouse: torch threads per worker)

HOT, ML, PS = 4, 64, 8
NAME = "falcon3-1b"
STATS = ("preemptions", "rejected", "cancelled", "expired", "recompute_tokens", "grown_pages",
         "iterations")


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")

    from repro import configs as jconfigs
    from repro.core import bitlinear as jbitlinear
    from repro.models import pack as jpack
    from repro.models import transformer as jT
    from repro.serving import chaos as jchaos
    from repro.serving import engine as jengine
    from repro.serving import paging as jpaging
    from repro.serving import scheduler as jsched

    return types.SimpleNamespace(jax=jax, configs=jconfigs, bitlinear=jbitlinear, pack=jpack,
                                 T=jT, chaos=jchaos, engine=jengine, paging=jpaging,
                                 sched=jsched)


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
    """Constructors of the two engines over falcon3-1b-smoke's packed weights
    (the reference's ``init_params(PRNGKey(0))``), with each package's
    Request class and invariant checker."""
    jcfg = jref.configs.get_smoke_config(NAME)
    jpacked = jref.pack.pack_params(jref.T.init_params(jref.jax.random.PRNGKey(0), jcfg), jcfg)
    cfg = get_smoke_config(NAME)
    params = interop.params_from_reference(_numpy_tree(jref, jpacked))

    def paged(engine_cls, c, p, **kw):
        for k, v in dict(hot_cap=HOT, max_len=ML, prefill_chunk=4, page_size=PS).items():
            kw.setdefault(k, v)
        return engine_cls(c, p, paged=True, **kw)

    port = SimpleNamespace(
        name="port", Request=Request, check=check_serving_invariants, vocab=cfg.vocab_size,
        engine=lambda **kw: paged(Engine, cfg, params, device="cpu", **kw))
    ref = SimpleNamespace(
        name="ref", Request=jref.sched.Request, check=jref.chaos.check_serving_invariants,
        vocab=jcfg.vocab_size, engine=lambda **kw: paged(jref.engine.Engine, jcfg, jpacked, **kw))
    return port, ref


def _prompt(seed, n, vocab):
    """The reference test's prompts (``jax.random.randint`` at ``seed``),
    drawn through the JAX package once and cached as numpy."""
    return _PROMPTS[(seed, n, vocab)].copy()


class _Prompts(dict):
    def __missing__(self, key):
        import jax

        seed, n, vocab = key
        self[key] = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (n,), 0, vocab),
                               np.int32)
        return self[key]


_PROMPTS = _Prompts()


def _tree_only(eng):
    """The pool's only readers left are prefix-tree pages."""
    pool, tree = eng._last_pool, eng._last_ptree
    tp = set(tree.tree_pages())
    for p in range(pool.n_pages):
        assert pool.refs[p] == (1 if p in tp else 0), p
    assert pool.available() == pool.n_pages - len(tp)


def _record(fin):
    return {f.rid: (f.outcome, np.asarray(f.tokens).tolist(), f.n_preemptions,
                    f.prefix_tokens_reused, dict(f.traffic), f.seq_len, f.prompt_len, f.steps)
            for f in fin}


# ---------------------------------------------------------------------------
# the scenarios of tests/test_overload.py, run by either package
# ---------------------------------------------------------------------------


def _pool5(side):
    """Pool of 5 pages against a peak of 8: eviction + preemption +
    recompute; tokens equal the unpressured run, invariants green every
    iteration."""
    reqs = lambda: [side.Request(i, _prompt(100 + i, 10 + i, side.vocab), 20)  # noqa: E731
                    for i in range(4)]
    big = side.engine(slots=2)
    fin_big = {f.rid: f for f in big.serve(reqs(), slots=2, sync_every=4)}
    assert big.last_stats.preemptions == 0
    eng = side.engine(slots=2, n_pages=5)
    fin = eng.serve(reqs(), slots=2, sync_every=4, on_iteration=side.check)
    by = {f.rid: f for f in fin}
    st_ = eng.last_stats
    assert set(by) == {0, 1, 2, 3}
    assert st_.preemptions > 0 and st_.recompute_tokens > 0
    assert sum(f.n_preemptions for f in fin) == st_.preemptions
    for r in reqs():
        f = by[r.rid]
        assert f.outcome == "finished" and f.prompt_len == r.prompt_len
        np.testing.assert_array_equal(f.tokens, fin_big[r.rid].tokens)
        assert len(f.tokens) == r.max_new_tokens
    _tree_only(eng)
    assert any(f.prefix_tokens_reused > 0 for f in fin)
    return eng, fin


def _lazy_growth(side):
    """Admission funds the prompt's pages only; growth totals peak - prompt."""
    eng = side.engine(slots=1)
    p_len, m_new = 6, 30
    fin = eng.serve([side.Request(0, _prompt(7, p_len, side.vocab), m_new)], slots=1,
                    sync_every=4, on_iteration=side.check)
    assert fin[0].outcome == "finished" and len(fin[0].tokens) == m_new
    prompt_pages = -(-max(p_len - HOT, 0) // PS)
    peak_pages = -(-max(p_len + m_new - HOT, 0) // PS)
    assert eng.last_stats.grown_pages == peak_pages - prompt_pages
    assert eng.last_stats.preemptions == 0
    _tree_only(eng)
    return eng, fin


CLOCK = [0.0]  # one fake clock, shared by both packages' engines


def _deadline_queued(side):
    """A queued request whose deadline passes is shed as 'expired' with no
    tokens; the running one is untouched and equals its solo serve."""
    CLOCK[0] = 0.0
    eng = side.engine(slots=1, clock=lambda: CLOCK[0])
    reqs = [side.Request(0, _prompt(20, 8, side.vocab), 12),
            side.Request(1, _prompt(21, 8, side.vocab), 12, deadline=1.0)]

    def advance(ctx):
        if ctx.iteration >= 1:
            CLOCK[0] = 2.0

    fin = eng.serve(reqs, slots=1, sync_every=4, on_iteration=advance)
    by = {f.rid: f for f in fin}
    assert by[1].outcome == "expired" and len(by[1].tokens) == 0
    assert by[0].outcome == "finished" and eng.last_stats.expired == 1
    [solo] = side.engine(slots=1).serve([side.Request(9, reqs[0].tokens, 12)], slots=1)
    np.testing.assert_array_equal(by[0].tokens, solo.tokens)
    _tree_only(eng)
    return eng, fin


def _deadline_active(side):
    """An active slot past its deadline retires at the next sync point with
    the tokens emitted so far (a prefix of its solo serve), pages freed."""
    CLOCK[0] = 0.0
    eng = side.engine(slots=1, clock=lambda: CLOCK[0])
    req = side.Request(0, _prompt(22, 8, side.vocab), 16, deadline=1.0)

    def advance(ctx):
        if ctx.iteration >= 1:
            CLOCK[0] = 5.0

    fin = eng.serve([req], slots=1, sync_every=4, on_iteration=advance)
    f = fin[0]
    assert f.outcome == "expired" and 0 < len(f.tokens) < 16 and f.steps == len(f.tokens)
    [solo] = side.engine(slots=1).serve([side.Request(9, req.tokens, 16)], slots=1)
    np.testing.assert_array_equal(f.tokens, solo.tokens[: len(f.tokens)])
    assert eng.last_stats.expired == 1
    _tree_only(eng)
    return eng, fin


def _cancel(side):
    """``Engine.cancel`` at the next sync point: the active slot surfaces its
    partial tokens, the queued rid never runs, an unknown rid is a no-op."""
    eng = side.engine(slots=2)
    reqs = [side.Request(i, _prompt(30 + i, 8, side.vocab), 14) for i in range(3)]

    def hook(ctx):
        if ctx.iteration == 0:
            eng.cancel(0)
            eng.cancel(2)
            eng.cancel(99)

    fin = eng.serve(reqs, slots=2, sync_every=4, on_iteration=hook)
    by = {f.rid: f for f in fin}
    assert by[0].outcome == "cancelled" and 0 < len(by[0].tokens) < 14
    assert by[2].outcome == "cancelled" and len(by[2].tokens) == 0
    assert by[1].outcome == "finished" and len(by[1].tokens) == 14
    assert eng.last_stats.cancelled == 2
    for rid in (0, 1):
        [solo] = side.engine(slots=1).serve([side.Request(9, reqs[rid].tokens, 14)], slots=1)
        np.testing.assert_array_equal(by[rid].tokens, solo.tokens[: len(by[rid].tokens)])
    _tree_only(eng)
    return eng, fin


def _cancel_prefill(side):
    """Cancellation while the prompt still streams: no tokens, pages freed."""
    eng = side.engine(slots=1)

    def hook(ctx):
        if ctx.iteration == 0:
            assert 0 in ctx.prefilling  # 30 tokens / chunk 4 > two waves
            eng.cancel(0)
        side.check(ctx)

    fin = eng.serve([side.Request(0, _prompt(40, 30, side.vocab), 8)], slots=1, sync_every=2,
                    on_iteration=hook)
    assert fin[0].outcome == "cancelled" and len(fin[0].tokens) == 0
    _tree_only(eng)
    return eng, fin


def _bounded_queue(side):
    """``max_queue`` sheds overflow as 'rejected' with no work; a per-call
    bound overrides the engine's."""
    eng = side.engine(slots=1, max_queue=2)
    reqs = lambda: [side.Request(i, _prompt(50 + i, 8, side.vocab), 6)  # noqa: E731
                    for i in range(5)]
    fin = eng.serve(reqs(), slots=1, sync_every=4)
    assert {f.rid: f.outcome for f in fin} == {0: "finished", 1: "finished", 2: "rejected",
                                                3: "rejected", 4: "rejected"}
    assert eng.last_stats.rejected == 3
    assert all(len(f.tokens) == 0 and f.steps == 0 for f in fin if f.outcome == "rejected")
    fin2 = eng.serve(reqs(), slots=1, sync_every=4, max_queue=16)
    assert all(f.outcome == "finished" for f in fin2)
    return eng, fin + fin2


def _priority(side):
    """A high-priority late arrival takes pages from the running weaker
    slot; the victim completes through recompute, both bit-exact."""
    reqs = lambda: [side.Request(0, _prompt(70, 12, side.vocab), 20),  # noqa: E731
                    side.Request(1, _prompt(71, 12, side.vocab), 20, priority=5)]
    fin_big = {f.rid: f for f in side.engine(slots=2).serve(reqs(), slots=2)}
    eng = side.engine(slots=2, n_pages=5)
    fin = eng.serve(reqs(), slots=2, sync_every=4, on_iteration=side.check)
    by = {f.rid: f for f in fin}
    assert eng.last_stats.preemptions > 0
    assert by[0].n_preemptions > 0 and by[1].n_preemptions == 0
    for rid in (0, 1):
        assert by[rid].outcome == "finished"
        np.testing.assert_array_equal(by[rid].tokens, fin_big[rid].tokens)
    _tree_only(eng)
    return eng, fin


SCENARIOS = {f.__name__[1:]: f for f in (_pool5, _lazy_growth, _deadline_queued,
                                         _deadline_active, _cancel, _cancel_prefill,
                                         _bounded_queue, _priority)}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_overload_scenario_matches_reference_engine(sides, scenario):
    """Each scenario holds on both engines (its own assertions inside), and
    the port gives the reference's terminal records (tokens, outcome,
    preemptions, prefix reuse, ledgers, lengths) and ServeStats counters."""
    port, ref = sides
    eng, fin = SCENARIOS[scenario](port)
    jeng, jfin = SCENARIOS[scenario](ref)
    assert sorted(_record(fin).items()) == sorted(_record(jfin).items())
    assert [getattr(eng.last_stats, k) for k in STATS] == [
        getattr(jeng.last_stats, k) for k in STATS]
    assert eng.weight_loads == 0


def test_unservable_request_refused_up_front(sides):
    """A request whose peak page demand exceeds the whole pool is refused at
    validation by both engines; the default pool serves it."""
    for side in sides:
        bad = side.Request(0, _prompt(60, 8, side.vocab), 52)  # peak 7 > 5
        with pytest.raises(ValueError, match="unservable"):
            side.engine(slots=2, n_pages=5).serve([bad], slots=2)
        [f] = side.engine(slots=2).serve([side.Request(0, bad.tokens, 52)], slots=2)
        assert f.outcome == "finished"


def test_stall_guard_raises_page_pool_error(sides, jref):
    """A pool pinned for good by an outside reader (a hook that takes every
    free page each iteration, after cancelling the running request) leaves
    the queued request unfundable: both engines end in the stall guard's
    PagePoolError after _STALL_LIMIT idle iterations, never in a silent
    spin."""
    from repro_torch.serving.paging import PagePoolError

    for side, err in zip(sides, (PagePoolError, jref.paging.PagePoolError)):
        eng = side.engine(slots=1)

        def pin(ctx, eng=eng):
            if ctx.iteration == 0:
                eng.cancel(0)
            ctx.pool.alloc(ctx.pool.available())

        reqs = [side.Request(i, _prompt(80 + i, 30, side.vocab), 20) for i in range(2)]
        with pytest.raises(err, match="unreclaimable"):
            eng.serve(reqs, slots=1, sync_every=2, on_iteration=pin)


# ---------------------------------------------------------------------------
# recompute-from-prefix at full width (fault 4)
# ---------------------------------------------------------------------------

FW_ROWS, FW_PROMPT, FW_NEW = 4, 21, 20


@pytest.fixture(scope="module")
def full_width():
    """falcon3-1b at full width, 4 layers, vocab cut to 32768, paged over
    page size 32 with hot 32 and prefill_chunk 8; its unpressured serve of
    four 21-token prompts."""
    cfg = dataclasses.replace(get_config(NAME), n_layers=4, vocab_size=32768)
    params = T.init_params(cfg, seed=0, pack=True, device="cpu")
    eng = Engine(cfg, params, hot_cap=32, max_len=64, prefill_chunk=8, paged=True,
                 page_size=32, slots=FW_ROWS, device="cpu")
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (FW_ROWS, FW_PROMPT))
    base = {f.rid: f.tokens for f in eng.serve(
        [Request(i, prompts[i].astype(np.int32), FW_NEW) for i in range(FW_ROWS)])}
    return eng, prompts, base


@pytest.mark.parametrize("k", [5, 13, 17])
def test_recompute_from_prefix_bit_exact_at_full_width(full_width, k):
    """Re-admitting prompt ‖ the first k emitted tokens (what a preemption
    after k tokens re-prefills) continues with the unpressured tokens on
    4/4 rows. Before the decode folded absolute tiles, k = 13 gave 3/4."""
    eng, prompts, base = full_width
    reqs = [Request(i, np.concatenate([prompts[i], base[i][:k]]).astype(np.int32), FW_NEW - k)
            for i in range(FW_ROWS)]
    got = {f.rid: f.tokens for f in eng.serve(reqs)}
    same = [bool(np.array_equal(got[i], base[i][k:])) for i in range(FW_ROWS)]
    assert same == [True] * FW_ROWS


# ---------------------------------------------------------------------------
# the scheduler's rules (tests/test_scheduler.py)
# ---------------------------------------------------------------------------


def _req(rid, n=3, **kw):
    return Request(rid, np.zeros(n, np.int32), 2, **kw)


def test_scheduler_slot_misuse_raises_typed_error():
    sched = SlotScheduler(2)
    with pytest.raises(SchedulerError, match="retiring free slot"):
        sched.retire(1)
    with pytest.raises(SchedulerError, match="requeueing free slot"):
        sched.requeue(0)
    with pytest.raises(SchedulerError) as e:
        sched.retire(1)
    assert e.value.slot == 1


def test_scheduler_bounded_queue_sheds():
    """Overflow is shed; a requeue (preemption) passes the bound."""
    sched = SlotScheduler(1, max_queue=2)
    assert sched.submit(_req(0)) and sched.submit(_req(1))
    assert not sched.submit(_req(2))
    assert [r.rid for r in sched.queue] == [0, 1]
    sched.next_fills()
    assert sched.submit(_req(3))
    sched.requeue(0)
    assert len(sched.queue) == 3


def test_scheduler_claim_ordering_priorities():
    """Admission by claim (priority desc, arrival asc), in both pairings."""
    sched = SlotScheduler(2)
    for r in (_req(0), _req(1), _req(2, priority=5)):
        sched.submit(r)
    assert [r.rid for _, r in sched.next_fills()] == [2, 0]
    sched2 = SlotScheduler(2)
    for r in (_req(0), _req(1, 7, priority=1), _req(2, 7, priority=1)):
        sched2.submit(r)
    assert [r.rid for r in sched2.next_group()[1]] == [1, 2]


def test_scheduler_preempt_victims_policy():
    """Only strictly weaker claims, fewest emitted first, newest on a tie;
    a FIFO peer cannot be preempted by a later arrival; exclusions hold."""
    sched = SlotScheduler(3)
    for rid, prio in [(0, 0), (1, 0), (2, 3)]:
        sched.submit(_req(rid, 4, priority=prio))
    fills = {r.rid: s for s, r in sched.next_fills()}
    late = _req(9, 4, priority=1)
    sched.submit(late)
    assert sched.preempt_victims(late, {fills[0]: 5, fills[1]: 2, fills[2]: 0}) == [
        fills[1], fills[0]]
    victims = sched.preempt_victims(late, {})
    assert victims == [fills[1], fills[0]]
    peer = _req(10, 4)
    sched.submit(peer)
    assert sched.preempt_victims(peer, {}) == []
    assert sched.preempt_victims(late, {}, exclude=victims) == []


def test_scheduler_requeue_keeps_arrival_claim():
    sched = SlotScheduler(1)
    sched.submit(_req(0))
    [(s, first)] = sched.next_fills()
    sched.submit(_req(1))
    back = sched.requeue(s)
    assert back is first and back.arrival == 0
    assert [r.rid for _, r in sched.next_fills()] == [0]


def test_scheduler_rules_match_reference(jref):
    """The same submissions, fills, requeues and victim queries give the
    reference scheduler's answers."""
    out = []
    for sched_cls, req_cls in ((SlotScheduler, Request),
                               (jref.sched.SlotScheduler, jref.sched.Request)):
        sched = sched_cls(3, max_queue=4)
        log = [sched.submit(req_cls(i, np.zeros(3 + i % 2, np.int32), 2, priority=i % 3))
               for i in range(6)]
        log.append([(s, r.rid) for s, r in sched.next_fills()])
        log.append(sched.preempt_victims(req_cls(7, np.zeros(3, np.int32), 2, priority=2),
                                         {0: 1, 1: 4, 2: 1}))
        log.append(sched.requeue(1).rid)
        log.append(sched.next_group())
        log[-1] = (log[-1][0], [r.rid for r in log[-1][1]])
        out.append(log)
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# property fuzz of the host control plane (tests/test_overload.py)
# ---------------------------------------------------------------------------


def _fuzz_control_plane(seed, pool_cls=PagePool, tree_cls=PrefixCache, check=True,
                        steps=150):
    """Random admit / retire / evict / match sequences against a pool and
    a prefix tree, mirroring the engine's bookkeeping, with the port's
    invariant checker after every op (``check``); returns the refcounts
    after every op."""
    rng = random.Random(seed)
    hc, ps, n_pages, vocab = 4, 4, 20, 40
    pool = pool_cls(n_pages)
    tree = tree_cls(pool, hot_cap=hc, page_size=ps)
    slots, prompts, next_sid, trace = {}, [], [0], []

    def ctx():
        live = sorted(slots)
        return SimpleNamespace(pool=pool, ptree=tree,
                               sched=SimpleNamespace(slot_req=[object()] * len(live)),
                               slot_pages=[slots[s] for s in live], host_table=None)

    def rand_prompt():
        if prompts and rng.random() < 0.5:
            base = prompts[rng.randrange(len(prompts))]
            cut = rng.randrange(1, len(base) + 1)
            ext = [rng.randrange(vocab) for _ in range(rng.randrange(0, 2 * ps))]
            return np.asarray(list(base[:cut]) + ext, np.int32)
        n = rng.randrange(1, hc + 4 * ps)
        return np.asarray([rng.randrange(vocab) for _ in range(n)], np.int32)

    def admit():
        toks = rand_prompt()
        m = tree.match(toks)
        shared = list(m.shared_pages)
        if shared:
            pool.incref(shared)
        n_cold = -(-max(len(toks) - hc, 0) // ps)
        tree.evict_for(n_cold - len(shared))
        fresh = pool.alloc(n_cold - len(shared))
        if fresh is None:
            if shared:
                pool.decref(shared)
            return
        sid = next_sid[0]
        next_sid[0] += 1
        slots[sid] = shared + fresh
        prompts.append(tuple(int(t) for t in toks))
        tree.insert(toks, slots[sid], lambda ids: None)

    def retire():
        if slots:
            pool.decref(slots.pop(rng.choice(sorted(slots))))

    def evict():
        tree.evict_for(rng.randrange(0, n_pages + 1))

    def match():
        tree.match(rand_prompt())

    ops = [admit, admit, retire, evict, match]
    for _ in range(steps):
        rng.choice(ops)()
        if check:
            check_serving_invariants(ctx())
        trace.append(pool.refs.tolist())
    for sid in sorted(slots):
        pool.decref(slots.pop(sid))
    if check:
        check_serving_invariants(ctx())
        assert pool.used() == len(set(tree.tree_pages()))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_control_plane_fuzz_seeded(seed):
    _fuzz_control_plane(seed)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**30))
def test_control_plane_fuzz_property(seed):
    _fuzz_control_plane(seed, steps=60)


@pytest.mark.parametrize("seed", [0, 1])
def test_control_plane_fuzz_matches_reference_classes(jref, seed):
    """The same op sequence on the reference's PagePool / PrefixCache gives
    the same refcounts after every op."""
    want = _fuzz_control_plane(seed, jref.paging.PagePool, jref.paging.PrefixCache,
                               check=False)
    assert _fuzz_control_plane(seed) == want


def test_fuzz_checker_is_not_vacuous():
    """The fuzz's checker can fail: a leaked page raises."""
    pool = PagePool(4)
    tree = PrefixCache(pool, hot_cap=2, page_size=2)
    pool.alloc(1)  # born with a reader nobody registered
    ctx = SimpleNamespace(pool=pool, ptree=tree, sched=SimpleNamespace(slot_req=[]),
                          slot_pages=[], host_table=None)
    with pytest.raises(InvariantViolation, match="leak"):
        check_serving_invariants(ctx)
