"""The port's replica fleet against the reference's (``tests/test_router.py``,
its control-plane cases, at smoke size): ``serving/replica.py``,
``serving/router.py`` and the fleet chaos of ``serving/chaos.py``.

* Bit-exact failover: under seeded replica kills (seeds 0-2), kills at each
  lifecycle stage, a second kill mid-migration, kill and cancel in one
  tick and a cancel mid-migration, every request ends exactly once and the
  finished ones carry a faultless serve's tokens, with
  ``check_fleet_invariants`` green after every tick.
* Warm migration: a straggler flag or a stale heartbeat drains a replica
  with KV handoffs that seed the survivor's prefix tree; corrupted
  payloads raise ``HandoffError`` and fall back cold, with the same tokens.
* The control plane: least-loaded placement, backoff (the reference's
  draws at the same seed) and its exhaustion, heartbeat timeouts on an
  injected clock, restarts through ``run_with_recovery`` and a spent
  restart budget, a dead replica refusing work, the one-shot transport
  faults, and the fleet checker's hand-built violations.
* Against the reference's router (one seed, kills and handoff corruption
  and a heartbeat drain on an injected clock): the same ``RouterStats``,
  injection points, outcomes and tokens.

Stragglers are driven without wall-clock sleeps: a test hook flags an
iteration in the session's ``StragglerMonitor`` (or moves an injected
clock). The router reacts to straggler flags only in the straggler tests,
whose monitors ignore wall time, so no case depends on how busy the
machine is.
"""

import random
import types
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.fault import FaultInjector, InjectedFault, run_with_recovery
from repro_torch.models import transformer as T
from repro_torch.serving import (Engine, FleetChaosConfig, FleetChaosInjector,
                                 InvariantViolation, LocalTransport, PagePool, Replica,
                                 ReplicaDead, Request, Router, check_fleet_invariants)
from test_torch_threads import share_cpu_threads  # noqa: F401 (autouse: torch threads per worker)

CI_SEEDS = [0, 1, 2]
HOT, ML, PS = 4, 64, 8
NAME = "falcon3-1b"
KW = dict(hot_cap=HOT, max_len=ML, prefill_chunk=4, paged=True, page_size=PS, slots=2,
          sync_every=2)


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config(NAME)
    return cfg, T.init_params(cfg, seed=0, device="cpu")


def _engine(cfg, params, **kw):
    return Engine(cfg, params, device="cpu", **{**KW, **kw})


def _prompts(vocab, n=5):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, 6 + i).astype(np.int32) for i in range(n)]


def _reqs(cfg, n=5, base_rid=0, budget=10):
    return [Request(rid=base_rid + i, tokens=p, max_new_tokens=budget)
            for i, p in enumerate(_prompts(cfg.vocab_size, n))]


def _fleet(cfg, params, n=2, **router_kw):
    """``n`` replicas behind a router; straggler drains off unless asked
    for (a loaded machine's slow iteration would drain a replica)."""
    reps = [Replica(f"r{i}", _engine(cfg, params)) for i in range(n)]
    return Router(reps, **{"straggler_drain": False, **router_kw}), reps


@pytest.fixture(scope="module")
def reference(setup):
    """A faultless single-engine serve's tokens, by rid offset."""
    cfg, params = setup
    return {f.rid: f.tokens for f in _engine(cfg, params).serve(_reqs(cfg))}


def _assert_bit_exact(fins, reference, base_rid=0):
    assert len(fins) == len(reference)
    for f in fins:
        assert f.outcome == "finished", (f.rid, f.outcome)
        np.testing.assert_array_equal(f.tokens, reference[f.rid - base_rid])


def _tick_clock(step=0.005):
    """A clock that moves a fixed step per read: backoff windows count
    control-flow events, not wall time."""
    state = {"t": 0.0}

    def clock():
        state["t"] += step
        return state["t"]

    return clock


def _quiet(rep):
    """Start the replica's session with a monitor that never flags by wall
    time (``_flag_straggler`` flags for it)."""
    rep.start()
    rep.ctx.monitor.factor = float("inf")


def _flag_straggler(rep):
    """Flag the replica's last iteration in its session's monitor, as the
    monitor does an iteration slower than ``factor`` x its median."""
    mon = rep.ctx.monitor
    mon.flagged.append((len(mon.times) - 1, float("inf"), mon.median))
    return True


# ---------------------------------------------------------------------------
# bit-exact failover
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", CI_SEEDS)
def test_kill_and_migrate_bit_exact(setup, reference, seed):
    cfg, params = setup
    rid0 = 100 * (seed + 1)

    def run():
        router, _ = _fleet(cfg, params, seed=seed, clock=_tick_clock(), sleep=lambda s: None)
        chaos = FleetChaosInjector(FleetChaosConfig(seed=seed, kill_rate=0.3, max_kills=2))
        return router, chaos, router.serve(_reqs(cfg, base_rid=rid0), on_tick=chaos.on_tick)

    router, chaos, fins = run()
    _assert_bit_exact(fins, reference, base_rid=rid0)
    assert chaos.kills and router.stats.cold_migrations > 0
    assert router.stats.restarts == len(chaos.kills)
    router2, chaos2, fins2 = run()  # the same seed: the same run
    assert chaos2.kills == chaos.kills and router2.stats == router.stats
    for a, b in zip(fins, fins2):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def _straggle_once(name, tick):
    """Flag ``name`` a straggler once, from ``tick`` on, when it holds a
    decoding slot (whose drain ships a handoff)."""
    def hook(r):
        rep = r.replicas[name]
        decoding = rep.busy() and any(s not in rep.ctx.prefilling
                                      for s in rep.ctx.sched.active_slots())
        if r.stats.ticks >= tick and not hook.done and decoding:
            hook.done = _flag_straggler(rep)
        check_fleet_invariants(r)
    hook.done = False
    return hook


@pytest.mark.parametrize("corrupt", [False, True])
def test_straggler_drain_migrates_warm(setup, reference, corrupt):
    """A straggler flag drains the replica with KV handoffs: the survivor's
    admissions ride the imported prefix; with every payload corrupted in
    flight each import raises ``HandoffError``, is counted, and the
    requests recompute cold. Tokens stay exact either way."""
    cfg, params = setup

    class Corrupting(LocalTransport):
        def send(self, payload):
            self.corrupt_next()
            return super().send(payload)

    router, reps = _fleet(cfg, params, seed=0, clock=_tick_clock(), sleep=lambda s: None,
                          straggler_drain=True,
                          transport=Corrupting() if corrupt else LocalTransport())
    for rep in reps:
        _quiet(rep)
    hook = _straggle_once("r0", 3)
    fins = router.serve(_reqs(cfg, base_rid=300), on_tick=hook)
    _assert_bit_exact(fins, reference, base_rid=300)
    st = router.stats
    assert hook.done and st.drains == 1 and st.warm_migrations >= 1
    if corrupt:
        assert st.handoff_corruptions == st.warm_migrations and st.handoffs_imported == 0
    else:
        assert st.handoffs_imported == st.warm_migrations and st.handoff_corruptions == 0
        assert sum(f.prefix_tokens_reused for f in fins) > 0


def _kill_at_tick(name, tick):
    def hook(r):
        if r.stats.ticks == tick and not r.replicas[name].dead:
            r.replicas[name].kill()
        check_fleet_invariants(r)
    return hook


@pytest.mark.parametrize("tick", [1, 2, 4])
def test_kill_at_stage(setup, reference, tick):
    """Tick 1 kills while the victims are queued or mid-prefill, later
    ticks mid-decode; every stage recovers bit for bit."""
    cfg, params = setup
    rid0 = 500 + 20 * tick
    router, _ = _fleet(cfg, params, seed=0)
    fins = router.serve(_reqs(cfg, base_rid=rid0), on_tick=_kill_at_tick("r0", tick))
    _assert_bit_exact(fins, reference, base_rid=rid0)
    assert router.stats.replica_failures == 1


def test_kill_mid_migration_double_kill(setup, reference):
    cfg, params = setup
    router, _ = _fleet(cfg, params, seed=0, max_restarts=2)
    state = {"killed": 0}

    def hook(r):
        t = r.stats.ticks
        if state["killed"] == 0 and t == 1:
            r.replicas["r0"].kill()
            state["killed"] = 1
        elif state["killed"] == 1 and t == 3:
            r.replicas["r1"].kill()
            state["killed"] = 2
        check_fleet_invariants(r)

    fins = router.serve(_reqs(cfg, base_rid=600), on_tick=hook)
    _assert_bit_exact(fins, reference, base_rid=600)
    assert state["killed"] == 2 and router.stats.replica_failures == 2


def _tree_only(rep):
    tree = list(rep.ctx.ptree.tree_pages())
    return all(int(rep.ctx.pool.refs[p]) == tree.count(p) for p in range(rep.ctx.pool.n_pages))


def test_kill_and_cancel_same_tick(setup):
    """The cancel lands in the tick its replica dies: one ``cancelled``
    terminal, no resurrection on the survivor, pools reconciled."""
    cfg, params = setup
    router, reps = _fleet(cfg, params, seed=0)
    reqs = _reqs(cfg, base_rid=700)
    victim = reqs[0].rid
    fired = {"done": False}

    def hook(r):
        if not fired["done"] and r.stats.ticks == 1:
            owner = r.assigned.get(victim)
            r.cancel(victim)
            if owner is not None:
                r.replicas[owner].kill()
            fired["done"] = True
        check_fleet_invariants(r)

    fins = router.serve(reqs, on_tick=hook)
    terms = [f for f in fins if f.rid == victim]
    assert fired["done"] and len(terms) == 1 and terms[0].outcome == "cancelled"
    assert all(f.outcome == "finished" for f in fins if f.rid != victim)
    assert len(fins) == len(reqs)
    assert all(_tree_only(rep) for rep in reps if rep.ctx is not None)


def test_cancel_mid_migration_window(setup):
    """The cancel lands while the request waits in the router's pending
    list between its harvest and its re-admission: the tombstone ends it."""
    cfg, params = setup
    router, _ = _fleet(cfg, params, seed=0)
    reqs = _reqs(cfg, base_rid=720)
    victim = reqs[1].rid
    state = {"phase": 0}

    def hook(r):
        if state["phase"] == 0 and r.stats.ticks == 1:
            owner = r.assigned.get(victim)
            if owner is not None:
                r.replicas[owner].kill()
                state["phase"] = 1
        elif state["phase"] == 1:
            assert any(p.req.rid == victim for p in r.pending)
            r.cancel(victim)
            state["phase"] = 2
        check_fleet_invariants(r)

    fins = router.serve(reqs, on_tick=hook)
    terms = [f for f in fins if f.rid == victim]
    assert state["phase"] == 2 and len(terms) == 1 and terms[0].outcome == "cancelled"
    assert len(fins) == len(reqs)


def test_fresh_session_forgets_stale_cancels(setup):
    cfg, params = setup
    eng = _engine(cfg, params)
    eng.cancel(740)  # a stale mark: no such request yet
    fins = eng.serve([Request(rid=740, tokens=_prompts(cfg.vocab_size, 1)[0], max_new_tokens=4)])
    assert len(fins) == 1 and fins[0].outcome == "finished"


# ---------------------------------------------------------------------------
# the control plane
# ---------------------------------------------------------------------------


def test_least_loaded_placement_spreads(setup):
    cfg, params = setup
    router, reps = _fleet(cfg, params, seed=0)
    for rep in reps:
        rep.start()
    for r in _reqs(cfg, n=4, base_rid=800, budget=4):
        router.submit(r)
    router._dispatch()
    assert set(router.assigned.values()) == {"r0", "r1"}
    while router.tick():
        pass
    assert len(router.finished) == 4


def test_backoff_is_deterministic_and_matches_the_reference(setup):
    """The same seed gives the same backoff windows (the reference's draws:
    its router is built over stand-in replicas, since only names matter
    here), capped; without jitter the base doubles up to the cap."""
    cfg, params = setup
    reps = [SimpleNamespace(name="r0")]

    def draws(router_cls):
        router = router_cls(reps, seed=7)
        return [router._backoff(k) for k in (1, 1, 2, 3, 4)]

    a = draws(Router)
    assert a == draws(Router)
    assert all(x <= 0.5 * 1.5 for x in a)
    rng = random.Random(7)
    assert a == [min(0.5, 0.02 * 2 ** (k - 1)) * (1 + 0.5 * rng.random()) for k in (1, 1, 2, 3, 4)]
    try:
        from repro.serving.router import Router as JRouter
    except ImportError:
        JRouter = None
    if JRouter is not None:
        assert a == draws(JRouter)
    bases = [Router(reps, seed=7, backoff_jitter=0.0)._backoff(k) for k in range(1, 7)]
    assert bases == sorted(bases) and bases[-1] == 0.5


def test_retry_budget_exhaustion_fails_terminally(setup):
    cfg, params = setup
    router = Router([Replica("r0", _engine(cfg, params))], seed=0, retry_limit=2,
                    max_restarts=3, sleep=lambda s: None, straggler_drain=False)

    def hook(r):
        rep = r.replicas["r0"]
        if not rep.dead and rep.busy():  # the replica dies whenever it holds work
            rep.kill()
        check_fleet_invariants(r)

    fins = router.serve(_reqs(cfg, n=1, base_rid=820), on_tick=hook)
    assert len(fins) == 1 and fins[0].outcome == "failed"
    assert router.attempts[820] == 2 and router.stats.failed == 1


def test_heartbeat_timeout_drains(setup, reference):
    """A stale heartbeat on an injected clock drains the replica (warm
    migration) with straggler detection off."""
    cfg, params = setup
    now = {"t": 0.0}
    clock = lambda: now["t"]  # noqa: E731
    reps = [Replica(f"r{i}", _engine(cfg, params), clock=clock) for i in range(2)]
    router = Router(reps, seed=0, straggler_drain=False, heartbeat_timeout=5.0, clock=clock,
                    sleep=lambda s: None)
    fired = {"done": False}

    def hook(r):
        now["t"] += 0.1
        if not fired["done"] and r.stats.ticks == 2:
            r.replicas["r0"].heartbeat = now["t"] - 10.0
            fired["done"] = True
        check_fleet_invariants(r)

    fins = router.serve(_reqs(cfg, base_rid=840), on_tick=hook)
    _assert_bit_exact(fins, reference, base_rid=840)
    assert router.stats.drains == 1 and router.stats.warm_migrations >= 1


def test_restart_retries_through_run_with_recovery(setup):
    cfg, params = setup
    router, reps = _fleet(cfg, params, seed=0, max_restarts=2)
    reps[0].restart_faults = FaultInjector(fail_at_steps=(1,))
    fins = router.serve(_reqs(cfg, base_rid=860), on_tick=_kill_at_tick("r0", 1))
    assert len(fins) == 5 and all(f.outcome == "finished" for f in fins)
    assert reps[0].restart_faults.fired and not reps[0].dead
    assert router.stats.restarts == 1 and reps[0].restarts == 1


def test_restart_budget_exhausted_replica_stays_dead(setup):
    cfg, params = setup
    router, reps = _fleet(cfg, params, seed=0, max_restarts=1)
    reps[0].restart_faults = FaultInjector(fail_at_steps=(1, 2, 3, 4, 5))
    fins = router.serve(_reqs(cfg, base_rid=880), on_tick=_kill_at_tick("r0", 1))
    assert len(fins) == 5 and all(f.outcome == "finished" for f in fins)
    assert reps[0].dead and "r0" in router._retired


def test_run_with_recovery_retries_then_gives_up():
    calls = []

    def flaky(resume):
        calls.append(resume)
        if len(calls) < 3:
            raise InjectedFault("down")
        return "up"

    seen = []
    assert run_with_recovery(flaky, max_restarts=2, on_restart=lambda n, e: seen.append(n)) == "up"
    assert calls == [None] * 3 and seen == [1, 2]
    with pytest.raises(InjectedFault):
        run_with_recovery(lambda _: (_ for _ in ()).throw(InjectedFault("x")), max_restarts=1)


def test_router_uses_drain_for_warm_migration(setup, reference):
    cfg, params = setup
    router, _ = _fleet(cfg, params, seed=0)
    state = {"drained": False}

    def hook(r):
        if not state["drained"] and r.stats.ticks == 2 and r.replicas["r0"].busy():
            r._drain_replica(r.replicas["r0"], "manual")
            state["drained"] = True
        check_fleet_invariants(r)

    fins = router.serve(_reqs(cfg, base_rid=920), on_tick=hook)
    _assert_bit_exact(fins, reference, base_rid=920)
    assert state["drained"] and router.stats.drains == 1


def test_replica_exposes_straggler_flags(setup):
    cfg, params = setup
    rep = Replica("r0", _engine(cfg, params))
    _quiet(rep)
    assert rep.straggler_flags() == 0
    for r in _reqs(cfg, n=2, base_rid=960, budget=12):
        rep.submit(r)
    steps, flagged = 0, False
    while rep.busy():
        rep.step()
        steps += 1
        if steps == 5:
            flagged = _flag_straggler(rep)
    assert flagged and rep.straggler_flags() == 1
    assert rep.heartbeat_age() >= 0.0


def test_dead_replica_refuses_work(setup):
    cfg, params = setup
    rep = Replica("r0", _engine(cfg, params))
    rep.start()
    rep.kill()
    with pytest.raises(ReplicaDead):
        rep.submit(Request(rid=1, tokens=np.asarray([1, 2, 3], np.int32), max_new_tokens=2))
    with pytest.raises(ReplicaDead):
        rep.step()
    with pytest.raises(ReplicaDead):
        rep.drain()
    with pytest.raises(ReplicaDead):
        rep.import_handoff([1, 2, 3], b"")


def test_local_transport_corruption_is_one_shot():
    t = LocalTransport()
    payload = bytes(range(64))
    t.corrupt_next()
    assert t.send(payload) != payload
    assert t.send(payload) == payload
    t.truncate_next()
    assert len(t.send(payload)) < len(payload)
    assert t.sent == 3 and t.corrupted == 2


def test_fleet_chaos_refuses_sdc_rates():
    """Refused until the SDC plane was ported; now each replica gets its
    own stream family at seed + 3 * (rank + 1), by its rank in sorted-name
    order (the retirement it drives: tests/test_torch_sdc.py)."""
    chaos = FleetChaosInjector(FleetChaosConfig(seed=2, page_decay_rate=0.1))
    rom, retention, _ = chaos._sdc_for("r1", 1)
    assert rom._rng.random() == np.random.default_rng(8).random()
    assert retention._rng.random() == np.random.default_rng(9).random()
    assert chaos._sdc_for("r1", 1)[0] is rom
    assert chaos.sdc_budget() == {"weight_asserts": 0, "page_flips": 0, "nan_pokes": 0}


# ---------------------------------------------------------------------------
# the fleet checker is falsifiable
# ---------------------------------------------------------------------------


def _fake_router(**kw):
    base = dict(finished=[], pending=[], replicas={}, assigned={}, attempts={}, accepted={},
                stats=SimpleNamespace(retries=0, failed=0))
    base.update(kw)
    return SimpleNamespace(**base)


def _lost():
    return _fake_router(accepted={1: object()}), "NOWHERE"


def _double_terminal():
    fin = SimpleNamespace(rid=1, outcome="finished")
    return _fake_router(accepted={1: object()}, finished=[fin, fin]), "2 places"


def _two_replicas():
    req = SimpleNamespace(rid=1)

    def rep(name):
        return SimpleNamespace(name=name, dead=False, ctx=SimpleNamespace(
            sched=SimpleNamespace(queue=[req], slot_req=[None]), pool=None))

    return _fake_router(accepted={1: req}, replicas={"a": rep("a"), "b": rep("b")}), "2 places"


def _shared_pool():
    pool = PagePool(4)

    def rep(name):
        return SimpleNamespace(name=name, dead=False, ctx=SimpleNamespace(
            sched=SimpleNamespace(queue=[], slot_req=[]), pool=pool, ptree=None, slot_pages=[],
            host_table=None, spec=False))

    return _fake_router(replicas={"a": rep("a"), "b": rep("b")}), "share one PagePool"


def _retry_mismatch():
    return _fake_router(attempts={1: 3}), "retries"


@pytest.mark.parametrize("case", [_lost, _double_terminal, _two_replicas, _shared_pool,
                                  _retry_mismatch])
def test_fleet_checker_catches_violations(case):
    router, match = case()
    with pytest.raises(InvariantViolation, match=match):
        check_fleet_invariants(router)


# ---------------------------------------------------------------------------
# against the reference's router
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
def jref():
    jax = pytest.importorskip("jax")

    from repro import configs as jconfigs
    from repro import serving as jserving
    from repro.core import bitlinear as jbitlinear
    from repro.models import pack as jpack
    from repro.models import transformer as jT

    return types.SimpleNamespace(jax=jax, configs=jconfigs, serving=jserving,
                                 bitlinear=jbitlinear, pack=jpack, T=jT)


def _router_run(serving, engines, prompts, seed, clock_kind):
    """One router run of a package (``serving``: its ``repro.serving``)
    over two replicas on ``engines()``: seeded kills and a handoff
    corruption every tick (``FleetChaosInjector``), and r0's heartbeat
    made stale at tick 3 on an injected clock (a warm drain)."""
    now = {"t": 0.0}

    def clock():
        if clock_kind == "tick":
            now["t"] += 0.005
        return now["t"]

    reps = [serving.Replica(f"r{i}", e, clock=clock) for i, e in enumerate(engines())]
    router = serving.Router(reps, seed=seed, clock=clock, sleep=lambda s: None,
                            straggler_drain=False, heartbeat_timeout=5.0)
    chaos = serving.FleetChaosInjector(serving.FleetChaosConfig(
        seed=seed, kill_rate=0.3, corrupt_rate=1.0, max_kills=1))
    stale = {"done": False}

    def on_tick(r):
        if not stale["done"] and r.stats.ticks == 3 and r.replicas["r0"].busy():
            r.replicas["r0"].heartbeat = clock() - 100.0
            stale["done"] = True
        chaos.on_tick(r)

    reqs = [serving.Request(rid=i, tokens=p.copy(), max_new_tokens=10)
            for i, p in enumerate(prompts)]
    fins = router.serve(reqs, on_tick=on_tick)
    return (vars(router.stats), chaos.kills, len(chaos.corruptions),
            [(f.rid, f.outcome, f.tokens.tolist(), f.n_preemptions) for f in fins])


def test_router_matches_reference_router(jref):
    """The port's router and the reference's, over engines built from the
    same packed weights, serving the same requests under the same seeded
    faults: the same counters, injection points, outcomes and tokens. The
    reference's two replicas share one engine, so its jitted steps
    compile once (a replica owns only its session)."""
    jcfg = jref.configs.get_smoke_config(NAME)
    jpacked = jref.pack.pack_params(jref.T.init_params(jref.jax.random.PRNGKey(0), jcfg), jcfg)
    cfg = get_smoke_config(NAME)
    params = interop.params_from_reference(_numpy_tree(jref, jpacked))
    jeng = jref.serving.Engine(jcfg, jpacked, **KW)
    prompts = [np.asarray(jref.jax.random.randint(jref.jax.random.PRNGKey(i), (6 + i,), 0,
                                                  jcfg.vocab_size), np.int32) for i in range(5)]
    import repro_torch.serving as tserving

    got = _router_run(tserving, lambda: [_engine(cfg, params) for _ in range(2)], prompts, 0,
                      "tick")
    want = _router_run(jref.serving, lambda: [jeng, jeng], prompts, 0, "tick")
    assert got == want
    stats = got[0]
    assert got[1] and stats["cold_migrations"] > 0 and stats["drains"] == 1
    # the transport flips the first payload of each tick: two sent in one
    # tick leave the second intact
    assert stats["warm_migrations"] >= stats["handoff_corruptions"] > 0
    assert all(outcome == "finished" for _, outcome, _, _ in got[3])
