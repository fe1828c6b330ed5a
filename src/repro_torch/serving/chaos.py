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
  loop, which its ``StragglerMonitor`` flags) and mid-flight cancellation
  (a slot still prefilling first). Same seed, same serve: same injections.

The injector uses public calls only (``PagePool.alloc`` / ``decref``,
``Engine.cancel``): it is a hostile client, so what it breaks is a real
protocol hole. Not ported: check 9 and the SDC injectors (the SDC plane),
and the fleet chaos (sessions, router).
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

from repro_torch.distributed.fault import FaultSchedule, StragglerMonitor
from repro_torch.serving.paging import pages_needed


class InvariantViolation(RuntimeError):
    """A serving-plane protocol invariant failed under test."""


def check_serving_invariants(ctx, extra_refs: Optional[Dict[int, int]] = None) -> None:
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
    8. quarantined pages are dead: never free, in the tree or mapped by a
       live slot (nothing quarantines a page yet, so this passes
       vacuously).

    A context without a pool (non-paged serving) passes the page checks
    vacuously; check 7's ledger part still runs."""
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
    ``seed + 1``, ``seed + 2``), so enabling one does not move another's
    points. The SDC classes of the reference belong to the SDC plane,
    which is not ported: a non-zero rate there raises."""

    seed: int = 0
    exhaust_rate: float = 0.0  # take pages from the pool...
    exhaust_pages: int = 4  # ...this many at a time...
    exhaust_hold: int = 3  # ...for this many iterations
    straggle_rate: float = 0.0  # sleep inside the serving loop...
    straggle_seconds: float = 0.02  # ...this long (a slow decode chunk)
    cancel_rate: float = 0.0  # cancel a live request mid-flight
    weight_flip_rate: float = 0.0
    page_decay_rate: float = 0.0
    nan_rate: float = 0.0
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
        if config.weight_flip_rate or config.page_decay_rate or config.nan_rate:
            raise NotImplementedError("SDC fault injection belongs to the SDC plane, which "
                                      "is not ported")
        self.engine = engine
        self.cfg = config
        self._exhaust = FaultSchedule(config.seed, config.exhaust_rate)
        self._straggle = FaultSchedule(config.seed + 1, config.straggle_rate)
        self._cancel = FaultSchedule(config.seed + 2, config.cancel_rate)
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
        if self.cfg.check_invariants:
            check_serving_invariants(ctx, extra_refs=self._held_counts())

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
