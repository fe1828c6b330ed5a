"""Serving-plane fault injection and machine-checked invariants (reference:
``repro/serving/chaos.py``).

- ``check_serving_invariants`` derives the page pool's refcount protocol
  from first principles against a live ``_ServeCtx`` (every count equals
  its known readers: the prefix tree, the live slots' page lists and any
  pages the injector holds) and checks the host page-table mirror. Run it
  after every loop iteration through ``Engine.serve(on_iteration=...)``.
- ``ChaosInjector`` is a seeded, deterministic adversary built on
  ``distributed/fault.py``: transient pool exhaustion (takes free pages
  and holds them for a few iterations), straggler stalls (sleeps inside the
  loop, which its ``StragglerMonitor`` flags), mid-flight cancellation
  (a slot still prefilling first) and the three SDC planes of
  ``serving/sdc.py`` (stuck ROM bits, page retention decay, NaN upsets),
  whose totals bound the engine's detections (check 9). Same seed, same
  serve: same injections.

The injector uses public calls only (``PagePool.alloc`` / ``decref``,
``Engine.cancel``): it is a hostile client, so what it breaks is a real
protocol hole.

The fleet level (``serving/router.py``): ``FleetChaosInjector`` kills
replicas, stalls them and corrupts the next warm handoff, each from its own
seeded stream, and ``check_fleet_invariants`` audits the router after every
tick (checks 1-6), and injects the SDC planes into each replica from a
stream family of its own.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

from repro_torch.distributed.fault import FaultSchedule, StragglerMonitor
from repro_torch.serving import sdc
from repro_torch.serving.paging import pages_needed


class InvariantViolation(RuntimeError):
    """A serving-plane protocol invariant failed under test."""


def check_serving_invariants(ctx, extra_refs: Optional[Dict[int, int]] = None,
                             sdc_budget: Optional[Dict[str, int]] = None) -> None:
    """Check the page pool's refcount protocol against ``ctx`` (an
    ``Engine`` session's ``_ServeCtx``), raising ``InvariantViolation`` at
    the first breach:

    1. no refcount is negative;
    2. the free list has no duplicates and only pages in range;
    3. free pages have refcount 0 and referenced pages are not free, so
       free, referenced and quarantined pages partition the pool;
    4. ``pool.used()`` reconciles with the free list and the quarantine;
    5. every page's refcount equals its known readers: prefix-tree nodes,
       live slots' page lists and ``extra_refs`` (pages the injector
       holds), strictly, so leaks and double frees are both caught (valid
       at iteration boundaries, once admission has dropped its transient
       increfs);
    6. the host page-table mirror's live rows equal the slots' page lists
       and hold only ids in range;
    7. (speculative engines, ``ctx.spec``) the accept ledger is sane
       (``accepted_tokens <= drafted_tokens``, in the stats and per
       finished request) and, when paged, every decoding slot holds
       exactly the pages its mirrored length needs: the rollback returned
       every page the rejected suffix held;
    8. quarantined pages (the SDC scrub's) are dead: never free, in the
       tree or mapped by a live slot;
    9. with ``sdc_budget`` (the injectors' totals: ``weight_asserts``,
       ``page_flips``, ``nan_pokes``), no SDC repair counter exceeds what
       was injected: detection may lag injection, never exceed it.

    A context without a pool (non-paged serving) passes the page checks
    and check 9 vacuously, as in the reference; check 7's ledger part still
    runs."""
    if getattr(ctx, "spec", False):
        _check_speculation(ctx)
    pool = ctx.pool
    if pool is None:
        return
    quarantined = getattr(pool, "quarantined", set())
    if (pool.refs < 0).any():
        bad = int((pool.refs < 0).argmax())
        raise InvariantViolation(f"negative refcount: page {bad} = {int(pool.refs[bad])}")
    free = list(pool._free)
    free_set = set(free)
    if len(free_set) != len(free):
        raise InvariantViolation("free list contains duplicate pages")
    for p in free:
        if not 0 <= p < pool.n_pages:
            raise InvariantViolation(f"free list holds out-of-range page {p}")
        if pool.refs[p] != 0:
            raise InvariantViolation(
                f"page {p} is on the free list with refcount {int(pool.refs[p])}")
    for p in range(pool.n_pages):
        if pool.refs[p] > 0 and p in free_set:
            raise InvariantViolation(f"page {p} is referenced ({int(pool.refs[p])}) AND free")
        if pool.refs[p] == 0 and p not in free_set and p not in quarantined:
            raise InvariantViolation(f"page {p} has no readers but is not on the free list")
    if pool.used() != pool.n_pages - len(free) - len(quarantined):
        raise InvariantViolation(f"used() = {pool.used()} but pool has {len(free)} free and "
                                 f"{len(quarantined)} quarantined of {pool.n_pages}")
    expected: Counter = Counter()
    if ctx.ptree is not None:
        expected.update(ctx.ptree.tree_pages())
    live = {s for s, r in enumerate(ctx.sched.slot_req) if r is not None}
    for s in live:
        expected.update(ctx.slot_pages[s])
    if extra_refs:
        expected.update(extra_refs)
    for p in range(pool.n_pages):
        if int(pool.refs[p]) != expected.get(p, 0):
            kind = "leak" if pool.refs[p] > expected.get(p, 0) else "double-free"
            raise InvariantViolation(f"refcount {kind}: page {p} has count "
                                     f"{int(pool.refs[p])} but {expected.get(p, 0)} known readers")
    if ctx.host_table is not None:
        if (ctx.host_table < 0).any() or (ctx.host_table >= pool.n_pages).any():
            raise InvariantViolation("host page table holds out-of-range ids")
        for s in live:
            row = list(ctx.host_table[s, : len(ctx.slot_pages[s])])
            if row != ctx.slot_pages[s]:
                raise InvariantViolation(f"slot {s} host-table row {row} != page list "
                                         f"{ctx.slot_pages[s]}")
    tree = set(ctx.ptree.tree_pages()) if ctx.ptree is not None else set()
    for p in sorted(quarantined):
        if p in free_set:
            raise InvariantViolation(f"quarantined page {p} is on the free list")
        if p in tree:
            raise InvariantViolation(f"quarantined page {p} is still in the prefix tree")
        for s in live:
            if p in ctx.slot_pages[s]:
                raise InvariantViolation(f"quarantined page {p} is still mapped by slot {s}")
    if sdc_budget is not None:
        _check_sdc_counters(ctx, sdc_budget)


def _check_sdc_counters(ctx, budget: Dict[str, int]) -> None:
    """Check 9 (reference: ``_check_sdc_counters``): the SDC ladder's
    counters against the injectors' own totals. A repair counter above its
    budget means the scrub invented a fault."""
    st = ctx.stats
    w = int(budget.get("weight_asserts", 0))
    p = int(budget.get("page_flips", 0))
    n = int(budget.get("nan_pokes", 0))
    if st.weight_reloads > w:
        raise InvariantViolation(f"weight_reloads {st.weight_reloads} exceeds injected weight "
                                 f"asserts {w}")
    n_quar = len(getattr(ctx.pool, "quarantined", set()) or ())
    if n_quar > p:
        raise InvariantViolation(f"{n_quar} quarantined pages exceed injected page flips {p}")
    if st.slots_quarantined > n:
        raise InvariantViolation(f"slots_quarantined {st.slots_quarantined} exceeds injected "
                                 f"NaN pokes {n}")
    if st.sdc_detected > w + p + n:
        raise InvariantViolation(f"sdc_detected {st.sdc_detected} exceeds total injected "
                                 f"faults {w + p + n}")


def _check_speculation(ctx) -> None:
    """Check 7 (reference: ``_check_speculation``): the draft / accept
    ledger, and no page stranded by a rollback. Valid at iteration
    boundaries only: mid-round the cache holds the whole unverified
    chunk."""
    st = ctx.stats
    if st.accepted_tokens > st.drafted_tokens:
        raise InvariantViolation(f"speculation ledger: accepted {st.accepted_tokens} > "
                                 f"drafted {st.drafted_tokens}")
    for fin in ctx.finished:
        if fin.accepted_tokens > fin.drafted_tokens:
            raise InvariantViolation(f"rid {fin.rid}: accepted {fin.accepted_tokens} > "
                                     f"drafted {fin.drafted_tokens}")
    if ctx.pool is None:
        return
    for s, req in enumerate(ctx.sched.slot_req):
        if req is None or s in ctx.prefilling or s in ctx.draft_prefilling:
            continue
        want = pages_needed(ctx.seq_mirror[s], ctx.hot_cap, ctx.page_size)
        if len(ctx.slot_pages[s]) != want:
            raise InvariantViolation(
                f"speculative rollback stranded pages: slot {s} holds "
                f"{len(ctx.slot_pages[s])} pages but its length {ctx.seq_mirror[s]} needs {want}")


@dataclasses.dataclass
class ChaosConfig:
    """Per-class injection rates (probability per loop iteration) and
    shapes; each class draws from its own seeded stream (``seed``,
    ``seed + 1``, ``seed + 2``; the SDC planes ``seed + 3``, ``+ 4``,
    ``+ 5``), so enabling one does not move another's points. The SDC
    planes need ``Engine(integrity=...)`` for the engine to fight back."""

    seed: int = 0
    exhaust_rate: float = 0.0  # take pages from the pool...
    exhaust_pages: int = 4  # ...this many at a time...
    exhaust_hold: int = 3  # ...for this many iterations
    straggle_rate: float = 0.0  # sleep inside the serving loop...
    straggle_seconds: float = 0.02  # ...this long (a slow decode chunk)
    cancel_rate: float = 0.0  # cancel a live request mid-flight
    weight_flip_rate: float = 0.0  # mint a stuck ROM bit address
    weight_reassert: Optional[int] = 1  # re-asserts per address (None: forever)
    page_decay_rate: float = 0.0  # per-iteration retention decay rate
    nan_rate: float = 0.0  # poke NaN into a decoding slot's hot K
    check_invariants: bool = True


class ChaosInjector:
    """Deterministic adversary for ``Engine.serve(on_iteration=...)``::

        chaos = ChaosInjector(engine, ChaosConfig(seed=0, exhaust_rate=.2,
                                                  cancel_rate=.1))
        finished = engine.serve(reqs, on_iteration=chaos.on_iteration)
        chaos.release_all(engine._last_ctx)  # drop the pages still held
        check_serving_invariants(engine._last_ctx)  # tree-only refs remain

    Held pages are legitimate pool readers (``extra_refs`` of the
    invariant check), so exhaustion drives eviction and preemption without
    faking state."""

    def __init__(self, engine, config: ChaosConfig):
        self.engine = engine
        self.cfg = config
        self._exhaust = FaultSchedule(config.seed, config.exhaust_rate)
        self._straggle = FaultSchedule(config.seed + 1, config.straggle_rate)
        self._cancel = FaultSchedule(config.seed + 2, config.cancel_rate)
        # the SDC adversaries ride their own streams, so enabling them
        # never moves the other classes' points
        self.rom = sdc.RomFaultInjector(config.seed + 3, config.weight_flip_rate,
                                        reassert=config.weight_reassert)
        self.retention = sdc.RetentionInjector(config.seed + 4, config.page_decay_rate)
        self._nan = FaultSchedule(config.seed + 5, config.nan_rate)
        self.nan_pokes = 0
        self.monitor = StragglerMonitor(window=20, factor=3.0)
        self.held: List[Tuple[int, List[int]]] = []  # (release_at, pages)
        self.cancelled: List[int] = []
        self.exhaustions = 0
        self._last_t: Optional[float] = None

    def on_iteration(self, ctx) -> None:
        it = ctx.iteration
        # holds that served their term return, like any reader leaving
        due = [h for h in self.held if h[0] <= it]
        self.held = [h for h in self.held if h[0] > it]
        for _, pages in due:
            ctx.pool.decref(pages)
        # transient pool exhaustion: become a reader of free pages
        if ctx.pool is not None and self._exhaust.fires(it):
            pages = ctx.pool.alloc(min(self.cfg.exhaust_pages, ctx.pool.available()))
            if pages:
                self.held.append((it + self.cfg.exhaust_hold, pages))
                self.exhaustions += 1
        # a straggler: a slow decode chunk is wall time inside the loop
        now = time.perf_counter()
        if self._straggle.fires(it):
            time.sleep(self.cfg.straggle_seconds)
            now = time.perf_counter()
        if self._last_t is not None:
            self.monitor.record(it, now - self._last_t)
        self._last_t = time.perf_counter()
        # cancellation: a slot still mid-prefill first (the hardest
        # teardown), else any live slot, else a queued request
        if self._cancel.fires(it):
            prefill = [ctx.sched.slot_req[s].rid for s in ctx.prefilling
                       if ctx.sched.slot_req[s] is not None]
            active = [r.rid for r in ctx.sched.slot_req if r is not None]
            queued = [r.rid for r in ctx.sched.queue]
            cands = prefill or active or queued
            if cands:
                rid = self._cancel.pick(cands)
                self.engine.cancel(rid)
                self.cancelled.append(rid)
        # the SDC planes: stuck ROM bits (asserted again after a repair),
        # retention decay of stamped pages, NaN upsets in a decoding slot
        self.rom.on_iteration(self.engine, ctx)
        self.retention.on_iteration(self.engine, ctx)
        if self._nan.fires(it):
            decoding = _decoding_slots(ctx)
            if decoding and sdc.inject_activation_nan(ctx, self._nan.pick(decoding)):
                self.nan_pokes += 1
        if self.cfg.check_invariants:
            check_serving_invariants(ctx, extra_refs=self._held_counts(),
                                     sdc_budget=self.sdc_budget())

    def sdc_budget(self) -> Dict[str, int]:
        """The injected totals check 9 bounds the detections by."""
        return {"weight_asserts": self.rom.injected, "page_flips": self.retention.injected,
                "nan_pokes": self.nan_pokes}

    def _held_counts(self) -> Counter:
        c: Counter = Counter()
        for _, pages in self.held:
            c.update(pages)
        return c

    def release_all(self, ctx) -> None:
        """Drop every page still held (after ``serve`` returns, so the final
        pool state is tree-only and checkable)."""
        for _, pages in self.held:
            ctx.pool.decref(pages)
        self.held = []


def _decoding_slots(ctx) -> List[int]:
    return [s for s in ctx.sched.active_slots()
            if s not in ctx.prefilling and s not in ctx.draft_prefilling]


# ---------------------------------------------------------------------------
# fleet chaos: replica kills, stalls and handoff corruption against the
# router, and the fleet-wide invariant checker
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetChaosConfig:
    """Replica-level injection rates (probability per router tick). Kill,
    stall and corruption draw from their own seeded streams (``seed``,
    ``seed + 1``, ``seed + 2``), so enabling one never moves another's
    points. The SDC planes act per replica per tick (its engine needs an
    ``IntegrityConfig``); each replica gets its own stream family at
    ``seed + 3 * (rank + 1)``, its rank in sorted-name order."""

    seed: int = 0
    kill_rate: float = 0.0  # kill a live replica (its device state is lost)
    stall_rate: float = 0.0  # make one iteration a straggler...
    stall_seconds: float = 0.25  # ...this slow
    corrupt_rate: float = 0.0  # flip a byte in the next warm handoff
    max_kills: int = 2  # the run's kill budget
    min_survivors: int = 1  # never kill below this many live replicas
    weight_flip_rate: float = 0.0  # mint a stuck ROM bit on one replica
    weight_reassert: Optional[int] = 1  # re-asserts per address (None: forever)
    page_decay_rate: float = 0.0  # per-page-per-tick retention decay
    nan_rate: float = 0.0  # a NaN upset in a decoding slot
    check_invariants: bool = True


class FleetChaosInjector:
    """Deterministic fleet adversary for ``Router.serve(on_tick=...)``::

        chaos = FleetChaosInjector(FleetChaosConfig(seed=0, kill_rate=.1))
        finished = router.serve(reqs, on_tick=chaos.on_tick)

    Every fault goes through a public call (``Replica.kill`` / ``stall``,
    ``Transport.corrupt_next``); with ``check_invariants``,
    ``check_fleet_invariants`` runs after every injection round."""

    def __init__(self, config: FleetChaosConfig):
        self.cfg = config
        self._kill = FaultSchedule(config.seed, config.kill_rate)
        self._stall = FaultSchedule(config.seed + 1, config.stall_rate)
        self._corrupt = FaultSchedule(config.seed + 2, config.corrupt_rate)
        self.kills: List[Tuple[int, str]] = []  # (tick, replica)
        self.stalls: List[Tuple[int, str]] = []
        self.corruptions: List[int] = []
        # per-replica SDC adversaries, made on first sight of a name
        self._sdc: Dict[str, tuple] = {}
        self.nan_pokes = 0

    def _sdc_for(self, name: str, rank: int):
        if name not in self._sdc:
            base = self.cfg.seed + 3 * (rank + 1)
            self._sdc[name] = (
                sdc.RomFaultInjector(base, self.cfg.weight_flip_rate,
                                     reassert=self.cfg.weight_reassert),
                sdc.RetentionInjector(base + 1, self.cfg.page_decay_rate),
                FaultSchedule(base + 2, self.cfg.nan_rate),
            )
        return self._sdc[name]

    def _inject_sdc(self, router) -> None:
        tick = router.stats.ticks
        for rank, name in enumerate(sorted(router.replicas)):
            rep = router.replicas[name]
            if rep.dead or rep.ctx is None:
                continue
            rom, retention, nan = self._sdc_for(name, rank)
            rom.on_iteration(rep.engine, rep.ctx)
            retention.on_iteration(rep.engine, rep.ctx)
            if nan.fires(tick):
                decoding = _decoding_slots(rep.ctx)
                if decoding and sdc.inject_activation_nan(rep.ctx, nan.pick(decoding)):
                    self.nan_pokes += 1

    def sdc_budget(self) -> Dict[str, int]:
        """The fleet's injected totals, summed over the replicas."""
        return {"weight_asserts": sum(v[0].injected for v in self._sdc.values()),
                "page_flips": sum(v[1].injected for v in self._sdc.values()),
                "nan_pokes": self.nan_pokes}

    def on_tick(self, router) -> None:
        tick = router.stats.ticks
        live = [r for r in router.replicas.values() if not r.dead]
        if (self._kill.fires(tick) and len(self.kills) < self.cfg.max_kills
                and len(live) > self.cfg.min_survivors):
            victim = self._kill.pick(live)
            victim.kill()
            self.kills.append((tick, victim.name))
            live = [r for r in live if r.name != victim.name]
        if self._stall.fires(tick) and live:
            target = self._stall.pick(live)
            target.stall(self.cfg.stall_seconds)
            self.stalls.append((tick, target.name))
        if self._corrupt.fires(tick):
            corrupt = getattr(router.transport, "corrupt_next", None)
            if corrupt is not None:
                corrupt()
                self.corruptions.append(tick)
        self._inject_sdc(router)
        if self.cfg.check_invariants:
            check_fleet_invariants(router)


def check_fleet_invariants(router) -> None:
    """Fleet-wide protocol audit at a tick boundary (reference:
    ``check_fleet_invariants``), raising ``InvariantViolation``:

    1. every accepted rid is in exactly one place: the terminal records,
       the router's pending list, or one replica's queue or slots (no rid
       live on two replicas, none with two terminal records);
    2. the router's ``assigned`` map agrees with where requests are;
    3. every live replica's session passes ``check_serving_invariants`` (a
       killed one is exempt: its pool reconciled when it was abandoned);
    4. no two replicas share a ``PagePool``;
    5. the router's retries equal the dispatch surplus per request, and
       every terminal record is of an accepted request, ``failed`` ones
       counted in ``stats.failed``;
    6. ``stats.sdc_retirements`` equals the SDC-retired set, each of whose
       replicas is dead, barred from restart and flagged ``unhealthy``
       (nothing resurrected a replica whose ROM plane struck out)."""
    locations: Dict[int, List[str]] = {}

    def seen(rid: int, where: str) -> None:
        locations.setdefault(rid, []).append(where)

    for fin in router.finished:
        seen(fin.rid, f"terminal:{fin.outcome}")
    for p in router.pending:
        seen(p.req.rid, "router:pending")
    live = [r for r in router.replicas.values() if not r.dead and r.ctx is not None]
    # a replica killed this tick still holds its requests in its host
    # bookkeeping until the router harvests it next tick
    for rep in (r for r in router.replicas.values() if r.ctx is not None):
        tag = rep.name if not rep.dead else f"{rep.name}(dead)"
        for req in rep.ctx.sched.queue:
            seen(req.rid, f"{tag}:queued")
        for s, req in enumerate(rep.ctx.sched.slot_req):
            if req is not None:
                seen(req.rid, f"{tag}:slot{s}")
    for rid in router.accepted:
        where = locations.get(rid, [])
        if len(where) != 1:
            raise InvariantViolation(f"rid {rid} is in {len(where)} places: {where or 'NOWHERE'}")
    for rid, name in router.assigned.items():
        where = locations[rid][0]
        if not (where.startswith(f"{name}:") or where.startswith(f"{name}(dead):")):
            raise InvariantViolation(f"rid {rid} assigned to {name} but found at {where}")
    for rep in live:
        check_serving_invariants(rep.ctx)
    pools = [id(rep.ctx.pool) for rep in live if rep.ctx.pool is not None]
    if len(set(pools)) != len(pools):
        raise InvariantViolation("two replicas share one PagePool")
    surplus = sum(max(n - 1, 0) for n in router.attempts.values())
    if router.stats.retries != surplus:
        raise InvariantViolation(f"router retries {router.stats.retries} != dispatch surplus "
                                 f"{surplus}")
    for fin in router.finished:
        if fin.rid not in router.accepted:
            raise InvariantViolation(f"terminal record for never-accepted rid {fin.rid}")
    n_failed = sum(1 for f in router.finished if f.outcome == "failed")
    if n_failed != router.stats.failed:
        raise InvariantViolation(f"failed terminals {n_failed} != stats.failed "
                                 f"{router.stats.failed}")
    sdc_retired = getattr(router, "_sdc_retired", set())
    if getattr(router.stats, "sdc_retirements", 0) != len(sdc_retired):
        raise InvariantViolation(f"sdc_retirements {router.stats.sdc_retirements} != retired "
                                 f"set {sorted(sdc_retired)}")
    for name in sdc_retired:
        rep = router.replicas[name]
        if (not rep.dead or name not in router._retired
                or not getattr(rep.engine, "unhealthy", False)):
            raise InvariantViolation(f"SDC-retired replica {name} is not permanently dead "
                                     f"(dead={rep.dead}, retired={name in router._retired}, "
                                     f"unhealthy={getattr(rep.engine, 'unhealthy', False)})")
