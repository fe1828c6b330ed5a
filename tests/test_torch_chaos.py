"""The port's serving fault-injection harness against the reference's
(``tests/test_chaos.py``, case for case, at smoke size).

* The invariant checker is falsifiable: hand-built protocol breaches (a
  leak, a double free, a negative count, a corrupted free list, a stale
  host table) each raise ``InvariantViolation``, and it passes on a tree
  and live slots; the reference's checker gives the same verdicts.
* Seeded chaos serves (pool exhaustion and cancellation injected into a
  paged serve under page pressure, falcon3-1b-smoke): every request ends
  once, finished requests equal a fault-free run, invariants hold after
  every iteration and after teardown, and the port's outcomes, tokens,
  injection points and counters equal the reference engine's under the
  same seed. The injection sequence is deterministic per seed, and a
  straggler injection is flagged.
* The fault vocabulary (``distributed/fault.py``): the multi-point
  ``FaultInjector``, ``FaultSchedule`` determinism (the reference's draws
  at the same seed) and ``StragglerMonitor``.
"""

import types
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.fault import (FaultInjector, FaultSchedule, InjectedFault,
                                           StragglerMonitor)
from repro_torch.serving.chaos import (ChaosConfig, ChaosInjector, InvariantViolation,
                                       check_serving_invariants)
from repro_torch.serving.engine import Engine
from repro_torch.serving.paging import PagePool, PrefixCache
from repro_torch.serving.scheduler import Request
from test_torch_threads import share_cpu_threads  # noqa: F401 (autouse: torch threads per worker)

HOT, ML, PS = 4, 64, 8
NAME = "falcon3-1b"


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")

    from repro import configs as jconfigs
    from repro.core import bitlinear as jbitlinear
    from repro.distributed import fault as jfault
    from repro.models import pack as jpack
    from repro.models import transformer as jT
    from repro.serving import chaos as jchaos
    from repro.serving import engine as jengine
    from repro.serving import paging as jpaging
    from repro.serving import scheduler as jsched

    return types.SimpleNamespace(jax=jax, configs=jconfigs, bitlinear=jbitlinear, fault=jfault,
                                 pack=jpack, T=jT, chaos=jchaos, engine=jengine, paging=jpaging,
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
    """Both packages' paged engines over falcon3-1b-smoke's packed weights,
    with their Request, ChaosInjector and checker."""
    jcfg = jref.configs.get_smoke_config(NAME)
    jpacked = jref.pack.pack_params(jref.T.init_params(jref.jax.random.PRNGKey(0), jcfg), jcfg)
    cfg = get_smoke_config(NAME)
    params = interop.params_from_reference(_numpy_tree(jref, jpacked))
    kw = dict(hot_cap=HOT, max_len=ML, prefill_chunk=4, paged=True, page_size=PS)
    port = SimpleNamespace(
        Request=Request, Chaos=ChaosInjector, Config=ChaosConfig, check=check_serving_invariants,
        vocab=cfg.vocab_size, engine=lambda **k: Engine(cfg, params, device="cpu", **kw, **k))
    ref = SimpleNamespace(
        Request=jref.sched.Request, Chaos=jref.chaos.ChaosInjector, Config=jref.chaos.ChaosConfig,
        check=jref.chaos.check_serving_invariants, vocab=jcfg.vocab_size,
        engine=lambda **k: jref.engine.Engine(jcfg, jpacked, **kw, **k))
    return port, ref


def _prompt(seed, n, vocab):
    """The reference test's prompts (``jax.random.randint`` at ``seed``)."""
    import jax

    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (n,), 0, vocab), np.int32)


# ---------------------------------------------------------------------------
# the checker must be falsifiable
# ---------------------------------------------------------------------------


def _fake_ctx(pool, tree=None, slot_pages=(), host_table=None):
    return SimpleNamespace(pool=pool, ptree=tree,
                           sched=SimpleNamespace(slot_req=[object()] * len(slot_pages)),
                           slot_pages=[list(p) for p in slot_pages], host_table=host_table)


def _leak(pool_cls, tree_cls):
    pool = pool_cls(4)
    pool.alloc(1)  # a reader nobody registered
    return _fake_ctx(pool), "leak"


def _double_free(pool_cls, tree_cls):
    pool = pool_cls(4)
    [p] = pool.alloc(1)
    pool.decref([p])  # freed while the (fake) slot still maps it
    return _fake_ctx(pool, slot_pages=[[p]]), "double-free|free list"


def _negative(pool_cls, tree_cls):
    pool = pool_cls(4)
    pool.refs[2] = -1  # corrupted directly: decref refuses to
    return _fake_ctx(pool), "negative"


def _referenced_and_free(pool_cls, tree_cls):
    pool = pool_cls(4)
    [p] = pool.alloc(1)
    pool._free.append(p)
    return _fake_ctx(pool, slot_pages=[[p]]), "AND free|free list with refcount"


def _duplicate_free(pool_cls, tree_cls):
    pool = pool_cls(4)
    pool._free.append(pool._free[0])
    return _fake_ctx(pool), "duplicate"


def _stale_host_table(pool_cls, tree_cls):
    pool = pool_cls(8)
    pages = pool.alloc(2)
    table = np.zeros((1, 4), np.int32)
    table[0, :2] = pages[::-1]  # the mirror disagrees with the page list
    return _fake_ctx(pool, slot_pages=[pages], host_table=table), "host-table"


def _unknown_reader(pool_cls, tree_cls):
    pool = pool_cls(4)
    pool.alloc(2)  # a chaos hold, without its extra_refs hint
    return _fake_ctx(pool), "leak"


BREACHES = {f.__name__[1:]: f for f in (_leak, _double_free, _negative, _referenced_and_free,
                                        _duplicate_free, _stale_host_table, _unknown_reader)}


@pytest.mark.parametrize("breach", list(BREACHES))
def test_checker_catches_breach(breach):
    ctx, match = BREACHES[breach](PagePool, PrefixCache)
    with pytest.raises(InvariantViolation, match=match):
        check_serving_invariants(ctx)


@pytest.mark.parametrize("breach", list(BREACHES))
def test_checker_verdicts_match_reference(jref, breach):
    """The reference's checker, on its own classes in the same state,
    raises the same message."""
    msgs = []
    for pool_cls, tree_cls, check, exc in (
            (PagePool, PrefixCache, check_serving_invariants, InvariantViolation),
            (jref.paging.PagePool, jref.paging.PrefixCache, jref.chaos.check_serving_invariants,
             jref.chaos.InvariantViolation)):
        ctx, _ = BREACHES[breach](pool_cls, tree_cls)
        with pytest.raises(exc) as e:
            check(ctx)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_checker_accepts_extra_refs_for_held_pages():
    pool = PagePool(4)
    pages = pool.alloc(2)
    ctx = _fake_ctx(pool)
    with pytest.raises(InvariantViolation):
        check_serving_invariants(ctx)
    check_serving_invariants(ctx, extra_refs=Counter(pages))


def test_checker_green_on_tree_and_slots():
    pool = PagePool(8)
    tree = PrefixCache(pool, hot_cap=2, page_size=2)
    toks = np.asarray([1, 2, 3, 4, 5], np.int32)
    pages = pool.alloc(1)
    assert tree.insert(toks, pages, lambda ids: None)
    check_serving_invariants(_fake_ctx(pool, tree, slot_pages=[pages]))
    pool.decref(pages)  # the slot retires; the tree keeps its copy
    check_serving_invariants(_fake_ctx(pool, tree))
    check_serving_invariants(SimpleNamespace(pool=None))  # unpaged: vacuous


def test_sdc_injection_is_refused():
    """Refused until the SDC plane was ported; now an SDC rate builds the
    three adversaries on their own streams, seed + 3 / + 4 / + 5, so they
    never move the other classes' points (the ladder itself:
    tests/test_torch_sdc.py)."""
    import numpy as np

    inj = ChaosInjector(None, ChaosConfig(seed=4, weight_flip_rate=0.2, page_decay_rate=0.1,
                                          nan_rate=0.1))
    assert inj.rom._rng.random() == np.random.default_rng(7).random()
    assert inj.retention._rng.random() == np.random.default_rng(8).random()
    nan = FaultSchedule(9, 0.1)
    assert [inj._nan.fires(i) for i in range(50)] == [nan.fires(i) for i in range(50)]
    assert inj.sdc_budget() == {"weight_asserts": 0, "page_flips": 0, "nan_pokes": 0}


# ---------------------------------------------------------------------------
# seeded chaos against a real paged serve under page pressure
# ---------------------------------------------------------------------------

CI_SEEDS = [0, 1, 2]


def _chaos_serve(side, seed):
    """Five requests over 2 slots and a pool the workload alone just fits;
    the injector's holds make the pressure."""
    reqs = lambda: [side.Request(i, _prompt(200 + i, 8 + i, side.vocab), 12)  # noqa: E731
                    for i in range(5)]
    eng = side.engine(slots=2, n_pages=12)
    chaos = side.Chaos(eng, side.Config(seed=seed, exhaust_rate=0.4, exhaust_pages=2,
                                        exhaust_hold=2, cancel_rate=0.08))
    fin = eng.serve(reqs(), slots=2, sync_every=2, on_iteration=chaos.on_iteration)
    chaos.release_all(eng._last_ctx)
    side.check(eng._last_ctx)
    return reqs, eng, chaos, fin


@pytest.fixture(scope="module")
def fault_free(sides):
    """Each package's fault-free serve of the chaos workload (ample pool)."""
    out = []
    for side in sides:
        reqs = [side.Request(i, _prompt(200 + i, 8 + i, side.vocab), 12) for i in range(5)]
        out.append({f.rid: f for f in side.engine(slots=2).serve(reqs, slots=2, sync_every=2)})
    return out


@pytest.mark.parametrize("seed", CI_SEEDS)
def test_chaos_serve_survives_and_matches_reference(sides, fault_free, seed):
    """Under seeded exhaustion + cancellation: one terminal outcome per
    request, finished ones equal the fault-free run, cancelled ones a
    prefix of it, invariants green every iteration (inside the injector)
    and after teardown, tree-only refs at the end; and the reference engine
    under the same seed fires at the same points, cancels the same rids and
    ends every request the same way, with the same tokens and counters."""
    results = []
    for side, ref in zip(sides, fault_free):
        reqs, eng, chaos, fin = _chaos_serve(side, seed)
        by = {f.rid: f for f in fin}
        assert sorted(by) == [r.rid for r in reqs()]
        assert {f.outcome for f in fin} <= {"finished", "cancelled"}
        assert chaos.exhaustions > 0
        for f in fin:
            if f.outcome == "finished":
                np.testing.assert_array_equal(f.tokens, ref[f.rid].tokens)
            else:
                assert f.rid in set(chaos.cancelled)
                np.testing.assert_array_equal(f.tokens, ref[f.rid].tokens[: len(f.tokens)])
        assert eng.last_stats.cancelled == sum(f.outcome == "cancelled" for f in fin)
        pool, tree = eng._last_pool, eng._last_ptree
        tp = set(tree.tree_pages())
        assert all(pool.refs[p] == (1 if p in tp else 0) for p in range(pool.n_pages))
        results.append((chaos._exhaust.fired_at, chaos._cancel.fired_at, chaos.cancelled,
                        chaos.exhaustions,
                        sorted((f.rid, f.outcome, np.asarray(f.tokens).tolist(), f.n_preemptions,
                                f.prefix_tokens_reused, f.traffic) for f in fin),
                        [getattr(eng.last_stats, k) for k in (
                            "preemptions", "cancelled", "recompute_tokens", "grown_pages",
                            "iterations")]))
    assert results[0] == results[1]


def test_chaos_is_deterministic_per_seed(sides):
    """Same seed, same workload: the same injection points, cancellations
    and outcomes."""
    port, _ = sides
    runs = [_chaos_serve(port, seed=1) for _ in range(2)]
    (_, _, a, fa), (_, _, b, fb) = runs
    assert a._exhaust.fired_at == b._exhaust.fired_at and a.cancelled == b.cancelled
    assert (sorted((f.rid, f.outcome, len(f.tokens)) for f in fa)
            == sorted((f.rid, f.outcome, len(f.tokens)) for f in fb))


class _FakeClock:
    """One clock for the engine and the chaos injector. Each of the
    engine's ``perf_counter`` reads costs one tick (its iteration's work);
    the injector reads it for free, and its ``sleep`` advances it. So every
    iteration time is a count of ticks, whatever the machine's load."""

    TICK = 1e-3

    def __init__(self):
        self.t = 0.0
        self.engine = types.SimpleNamespace(perf_counter=self._work)
        self.chaos = types.SimpleNamespace(perf_counter=lambda: self.t, sleep=self._sleep)

    def _work(self):
        self.t += self.TICK
        return self.t

    def _sleep(self, seconds):
        self.t += seconds


def test_chaos_straggler_injection_flags(sides, monkeypatch):
    """A slow decode chunk (a sleep inside the loop, 6x the median
    iteration of a warm-up serve just before) is flagged by the injector's
    StragglerMonitor and shows in the session's iteration stats. The
    engine's iteration timer and the injector's clock and sleep run on one
    fake clock, so no wall clock decides the test."""
    from repro_torch.serving import chaos as chaos_mod
    from repro_torch.serving import engine as engine_mod

    port, _ = sides
    reqs = lambda: [Request(0, _prompt(300, 8, port.vocab), 40)]  # noqa: E731
    eng = port.engine(slots=1)
    clock = _FakeClock()
    monkeypatch.setattr(engine_mod, "time", clock.engine)
    monkeypatch.setattr(chaos_mod, "time", clock.chaos)
    eng.serve(reqs(), slots=1, sync_every=2)
    nap = 6 * eng.last_stats.iter_p50
    chaos = ChaosInjector(eng, ChaosConfig(seed=3, straggle_rate=0.15, straggle_seconds=nap))
    fin = eng.serve(reqs(), slots=1, sync_every=2, on_iteration=chaos.on_iteration)
    assert fin[0].outcome == "finished"
    assert chaos._straggle.fired_at and chaos.monitor.flagged
    assert eng.last_stats.iter_max >= nap > eng.last_stats.iter_p50


# ---------------------------------------------------------------------------
# the shared fault vocabulary
# ---------------------------------------------------------------------------


def test_fault_injector_multi_step_fires_each_once():
    inj = FaultInjector(fail_at_steps=(3, 7))
    fired = []
    for step in range(10):
        try:
            inj.check(step)
        except InjectedFault:
            fired.append(step)
    assert fired == [3, 7]
    for step in range(10):
        inj.check(step)
    single = FaultInjector(fail_at_step=2)
    with pytest.raises(InjectedFault):
        single.check(2)
    single.check(2)


def test_fault_schedule_is_seed_deterministic():
    a, b = FaultSchedule(seed=42, rate=0.3), FaultSchedule(seed=42, rate=0.3)
    ha, hb = [a.fires(i) for i in range(200)], [b.fires(i) for i in range(200)]
    assert ha == hb and a.fired_at == b.fired_at and 0 < sum(ha) < 200
    assert a.pick([10, 20, 30]) == b.pick([10, 20, 30])
    c = FaultSchedule(seed=43, rate=0.3)
    assert [c.fires(i) for i in range(200)] != ha


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_fault_schedule_draws_the_references_points(jref, seed):
    """The port's schedule fires where the reference's does at the same
    seed, and picks the same targets."""
    ours, theirs = FaultSchedule(seed, 0.25), jref.fault.FaultSchedule(seed, 0.25)
    for i in range(300):
        assert ours.fires(i) == theirs.fires(i)
    assert ours.fired_at == theirs.fired_at
    assert [ours.pick(list(range(9))) for _ in range(20)] == [
        theirs.pick(list(range(9))) for _ in range(20)]


def test_straggler_monitor_flags_outlier(jref):
    mons = [StragglerMonitor(window=10, factor=3.0),
            jref.fault.StragglerMonitor(window=10, factor=3.0)]
    seen = []
    mons[0].on_straggler = lambda *a: seen.append(a)
    times = [0.01] * 8 + [0.1, 0.011, 0.2, 0.01, 0.012]
    flags = [[m.record(i, t) for i, t in enumerate(times)] for m in mons]
    assert flags[0] == flags[1] and flags[0][8] and not any(flags[0][:8])
    assert mons[0].flagged == mons[1].flagged and mons[0].flagged[0][0] == 8
    assert seen == mons[0].flagged and mons[0].median == mons[1].median
