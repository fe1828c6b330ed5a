"""Data-parallel router over N engine replicas: placement, health checks,
retries and bit-exact failover (reference: ``repro/serving/router.py``).

The router is the fleet's one control plane. It places requests on the
least-loaded live replica, retries with exponential backoff and jitter,
sweeps health (heartbeat age and each session's ``StragglerMonitor``
flags) and migrates work off a replica that fails or degrades:

- cold migration (the replica died): the orphans come from the dead
  replica's host bookkeeping (``Replica.abandon``: pages decref, no device
  work), each one's journaled tokens fold into its prompt, and it is
  re-admitted on a survivor. Greedy tokens stay those of a faultless run:
  re-prefilling prompt ‖ emitted samples the pending token again from the
  same row, and the prefix tree bounds the recompute to the suffix;
- warm migration (alive but unhealthy: new straggler flags or a stale
  heartbeat): ``Replica.drain(with_handoffs=True)`` folds every request
  and ships each decoding slot's rows in the tier storage dtype with
  per-page checksums over the ``Transport``; the receiver verifies them
  and seeds its prefix tree. A payload that fails verification raises
  ``HandoffError``: the router counts it and the request runs cold.

Restarts go through ``run_with_recovery`` (bounded retries); a replica
whose budget is spent stays dead and the survivors serve its load. A
replica whose engine struck out on weight faults (``Engine.unhealthy``,
the SDC ladder) is retired for good: its work migrates warm and it is
never restarted. Every
accepted request ends in exactly one terminal record across the fleet,
cancels that land mid-migration (tombstoned here) and requests whose
retry budget runs out (outcome ``failed``) included;
``serving/chaos.py``'s ``check_fleet_invariants`` derives that after
every tick.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.kv_cache import HandoffError
from repro_torch.distributed.fault import InjectedFault, run_with_recovery
from repro_torch.serving.paging import PagePoolError
from repro_torch.serving.replica import LocalTransport, Replica, ReplicaDead, Transport
from repro_torch.serving.scheduler import FinishedRequest, Request, terminal_record


@dataclasses.dataclass
class RouterStats:
    """Fleet counters, reconciled by ``check_fleet_invariants``."""

    ticks: int = 0
    admitted: int = 0  # dispatches onto a replica, re-admissions included
    retries: int = 0  # dispatches past each request's first
    cold_migrations: int = 0  # re-admissions after a replica's death
    warm_migrations: int = 0  # drained requests that carried a handoff
    handoffs_imported: int = 0  # payloads that seeded the receiver's tree
    handoff_corruptions: int = 0  # HandoffError caught: ran cold instead
    replica_failures: int = 0
    restarts: int = 0
    drains: int = 0
    failed: int = 0  # retry budget spent: outcome "failed"
    sheds: int = 0  # a replica's bounded queue bounced an admission
    sdc_retirements: int = 0  # replicas retired for repeated weight faults


@dataclasses.dataclass
class _Pending:
    """A request the router owns and no replica holds."""

    req: Request
    attempts: int = 0
    retry_at: float = 0.0
    handoff: Optional[bytes] = None  # a warm-migration payload in transit
    avoid: Optional[str] = None  # the replica it just left


class Router:
    """The front door over ``replicas``, scheduled cooperatively in one
    process: each ``tick`` dispatches pending requests, advances every
    busy replica by one engine iteration, sweeps health and restarts the
    dead. ``clock`` and ``sleep`` are injectable, so backoff windows and
    heartbeats can run on a clock that only the caller moves."""

    def __init__(self, replicas: Sequence[Replica], seed: int = 0, retry_limit: int = 4,
                 backoff_base: float = 0.02, backoff_cap: float = 0.5,
                 backoff_jitter: float = 0.5, heartbeat_timeout: Optional[float] = None,
                 straggler_drain: bool = True, max_restarts: int = 2,
                 transport: Optional[Transport] = None,
                 clock: Optional[Callable[[], float]] = None,
                 sleep: Optional[Callable[[float], None]] = None):
        if not replicas:
            raise ValueError("router needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        self.replicas: Dict[str, Replica] = {r.name: r for r in replicas}
        self.retry_limit = retry_limit
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.backoff_jitter = backoff_jitter
        self.heartbeat_timeout = heartbeat_timeout
        self.straggler_drain = straggler_drain
        self.max_restarts = max_restarts
        self.transport = transport or LocalTransport()
        self._clock = clock or time.monotonic
        self._sleep = sleep or time.sleep
        # the reference's generator: both packages draw the same windows
        self._rng = random.Random(seed)
        self.stats = RouterStats()
        self.accepted: Dict[int, Request] = {}
        self.pending: List[_Pending] = []
        self.assigned: Dict[int, str] = {}  # rid -> the replica holding it
        self.attempts: Dict[int, int] = {}  # rid -> dispatches so far
        self.finished: List[FinishedRequest] = []
        self._done: set = set()
        self._cancel: set = set()  # tombstones: cancelled before a terminal
        self._retired: set = set()  # replicas whose restart budget is spent
        self._sdc_retired: set = set()  # retired for weight-fault strikes
        self._stop_token: Optional[int] = None
        # straggler flags already acted on, per replica (the sweep reacts
        # to new flags only)
        self._flags_seen: Dict[str, int] = {n: 0 for n in self.replicas}

    # -- client surface --------------------------------------------------
    def submit(self, req: Request) -> None:
        """Accept a request. Claims (priority, arrival) are fleet-global:
        the router stamps the arrival."""
        if req.rid in self.accepted:
            raise ValueError(f"duplicate rid {req.rid}")
        if req.arrival is None:
            req.arrival = len(self.accepted)
        self.accepted[req.rid] = req
        self.pending.append(_Pending(req))

    def cancel(self, rid: int) -> None:
        """Cancel ``rid`` wherever it is: queued here, live on a replica or
        between the two. The tombstone keeps the re-admission path from
        resurrecting it, so it ends once, as ``cancelled``."""
        if rid in self._done:
            return
        self._cancel.add(rid)
        name = self.assigned.get(rid)
        if name is not None:
            rep = self.replicas[name]
            if not rep.dead and rep.ctx is not None:
                rep.engine.cancel(rid)

    def serve(self, requests: Sequence[Request], stop_token: Optional[int] = None,
              on_tick: Optional[Callable[["Router"], None]] = None,
              max_ticks: int = 100_000) -> List[FinishedRequest]:
        """Serve ``requests`` across the fleet to the end: one terminal
        record per accepted request, by rid. ``on_tick(router)`` runs after
        every tick (the fleet chaos and invariant hook)."""
        self._stop_token = stop_token
        for rep in self.replicas.values():
            if rep.ctx is None and not rep.dead:
                rep.start(stop_token=stop_token)
        for r in requests:
            self.submit(r)
        for _ in range(max_ticks):
            if not self.tick(on_tick=on_tick):
                break
        else:
            raise RuntimeError(f"router did not converge in {max_ticks} ticks: "
                               f"{len(self.pending)} pending, {sorted(self.assigned)} assigned")
        return sorted(self.finished, key=lambda f: f.rid)

    # -- the tick --------------------------------------------------------
    def tick(self, on_tick: Optional[Callable[["Router"], None]] = None) -> bool:
        """One control-plane round; True while work remains."""
        # health first: react to the previous tick's signals before this
        # tick's steps refresh them
        self._health_sweep()
        self._dispatch()
        stepped = False
        for name in list(self.replicas):
            rep = self.replicas[name]
            if rep.dead:
                if rep.ctx is not None:
                    # killed outside a step: harvest it before a restart
                    # replaces the session
                    self._on_replica_failure(rep)
                continue
            if not rep.busy():
                continue
            try:
                rep.step()
                stepped = True
            except (ReplicaDead, InjectedFault, PagePoolError):
                self._on_replica_failure(rep)
                continue
            self._collect(rep)
        self._restart_dead()
        self.stats.ticks += 1
        if on_tick is not None:
            on_tick(self)
        live_work = any(rep.busy() for rep in self.replicas.values())
        more = bool(self.pending) or bool(self.assigned) or live_work
        if more and not stepped:
            self._sleep(0.001)  # everything is backing off: yield
        return more

    # -- placement -------------------------------------------------------
    def _live(self) -> List[Replica]:
        return [r for r in self.replicas.values() if not r.dead and r.ctx is not None]

    def _backoff(self, attempts: int) -> float:
        base = min(self.backoff_cap, self.backoff_base * (2 ** max(attempts - 1, 0)))
        return base * (1.0 + self.backoff_jitter * self._rng.random())

    def _dispatch(self) -> None:
        """Place pending requests on the least-loaded live replica in claim
        order, honouring backoff windows; tombstones and deadlines end a
        request here before placement, and an in-transit handoff is
        imported on the chosen replica."""
        if not self.pending:
            return
        now = self._clock()
        self.pending.sort(key=lambda p: p.req.claim)
        remaining: List[_Pending] = []
        for p in self.pending:
            rid = p.req.rid
            if rid in self._cancel:
                self._terminal(terminal_record(p.req, "cancelled"))
                continue
            if p.req.deadline is not None and now >= p.req.deadline:
                self._terminal(terminal_record(p.req, "expired"))
                continue
            if p.retry_at > now:
                remaining.append(p)
                continue
            cands = [r for r in self._live() if r.name != p.avoid] or self._live()
            if not cands:
                remaining.append(p)
                continue
            target = min(cands, key=lambda r: (r.load(), r.name))
            if p.handoff is not None:
                self._import_handoff(target, p)
            if not target.submit(p.req):
                # the replica's bounded queue shed it: back off, elsewhere
                self.stats.sheds += 1
                p.avoid = target.name
                p.retry_at = now + self._backoff(p.attempts + 1)
                remaining.append(p)
                continue
            p.attempts += 1
            self.attempts[rid] = self.attempts.get(rid, 0) + 1
            if self.attempts[rid] > 1:
                self.stats.retries += 1
            self.stats.admitted += 1
            self.assigned[rid] = target.name
        self.pending = remaining

    def _import_handoff(self, target: Replica, p: _Pending) -> None:
        """Ship a payload over the transport and seed the target's prefix
        tree; a payload that fails verification is counted and the request
        runs cold: unverified rows never reach a decode."""
        blob, p.handoff = p.handoff, None
        try:
            seeded = target.import_handoff(np.asarray(p.req.tokens, np.int32),
                                           self.transport.send(blob))
        except HandoffError:
            self.stats.handoff_corruptions += 1
            return
        if seeded:
            self.stats.handoffs_imported += 1

    # -- failure handling ------------------------------------------------
    def _fold_journal(self, req: Request, emitted: np.ndarray) -> None:
        """The preemption fold on the host: the dead replica's journaled
        tokens join the prompt, so the re-admission resumes bit for bit."""
        if emitted.size == 0:
            return
        if req.orig_prompt_len is None:
            req.orig_prompt_len = req.prompt_len
        req.tokens = np.concatenate([np.asarray(req.tokens, np.int32), emitted])
        req.max_new_tokens -= int(emitted.size)
        req.n_preemptions += 1

    def _requeue(self, req: Request, avoid: Optional[str], handoff: Optional[bytes] = None,
                 backoff: bool = True) -> None:
        """Take a harvested request back, unless its retry budget is spent:
        then it fails, with whatever tokens were folded."""
        rid = req.rid
        self.assigned.pop(rid, None)
        if self.attempts.get(rid, 0) >= self.retry_limit:
            self.stats.failed += 1
            self._terminal(terminal_record(req, "failed"))
            return
        p = _Pending(req, attempts=self.attempts.get(rid, 0), handoff=handoff, avoid=avoid)
        if backoff:
            p.retry_at = self._clock() + self._backoff(p.attempts)
        self.pending.append(p)

    def _on_replica_failure(self, rep: Replica) -> None:
        """A replica died: keep the terminals it produced, then migrate
        every orphan cold (its journal folded: the device is gone)."""
        self.stats.replica_failures += 1
        rep.kill()
        self._collect(rep)
        journal = dict(rep.journal)
        for req in rep.abandon():
            emitted = journal.get(req.rid)
            if emitted is not None:
                self._fold_journal(req, emitted)
            self.stats.cold_migrations += 1
            self._requeue(req, avoid=rep.name)

    def _drain_replica(self, rep: Replica, reason: str) -> None:
        """Warm migration off a live but unhealthy replica: the engine
        folds every request and exports each decoding slot's rows; the
        survivors import what verifies and recompute the rest."""
        del reason  # for the reader
        self.stats.drains += 1
        drained, handoffs = rep.drain(with_handoffs=True)
        self._collect(rep)
        for req in drained:
            self.assigned.pop(req.rid, None)
            blob = handoffs.get(req.rid)
            if blob is not None:
                self.stats.warm_migrations += 1
            self._requeue(req, avoid=rep.name, handoff=blob, backoff=False)

    def _health_sweep(self) -> None:
        """An engine that struck out on repeated weight faults
        (``Engine.unhealthy``) is retired for good; new straggler flags or
        a heartbeat older than the timeout drain a busy replica (warm
        migration), which stays live and takes new work once it steps
        again."""
        for rep in self._live():
            if getattr(rep.engine, "unhealthy", False):
                self._retire_sdc(rep)
                continue
            flags = rep.straggler_flags()
            fresh = flags - self._flags_seen.get(rep.name, 0)
            self._flags_seen[rep.name] = flags
            unhealthy = self.straggler_drain and fresh > 0
            if (not unhealthy and self.heartbeat_timeout is not None and rep.busy()
                    and rep.heartbeat_age() > self.heartbeat_timeout):
                unhealthy = True
            if unhealthy and rep.busy():
                self._drain_replica(rep, "unhealthy")

    def _retire_sdc(self, rep: Replica) -> None:
        """Retire a replica whose engine declared itself ``unhealthy``
        (reference: ``_retire_sdc``). Unlike a straggler drain it does not
        come back: its weights keep corrupting. Its last scrub verified
        every surviving slot, so the work warm-migrates off with handoffs
        before the kill."""
        self.stats.sdc_retirements += 1
        if rep.busy():
            self._drain_replica(rep, "sdc")
        else:
            self._collect(rep)
        rep.seal()  # close the now idle session, keep its stats
        rep.kill()
        self._retired.add(rep.name)
        self._sdc_retired.add(rep.name)

    def _restart_dead(self) -> None:
        """Restart dead replicas through ``run_with_recovery``: a failing
        restart is retried up to ``max_restarts`` times, and a replica that
        spends the budget stays dead."""
        for rep in self.replicas.values():
            if not rep.dead or rep.name in self._retired:
                continue
            try:
                run_with_recovery(lambda _resume, rep=rep: rep.restart(self._stop_token),
                                  max_restarts=self.max_restarts)
            except Exception:  # noqa: BLE001 (the budget is spent: it stays dead)
                self._retired.add(rep.name)
                continue
            self._flags_seen[rep.name] = 0
            self.stats.restarts += 1

    # -- terminal accounting ---------------------------------------------
    def _collect(self, rep: Replica) -> None:
        for fin in rep.take_finished():
            self.assigned.pop(fin.rid, None)
            self._terminal(fin)

    def _terminal(self, fin: FinishedRequest) -> None:
        self._cancel.discard(fin.rid)
        self._done.add(fin.rid)
        self.finished.append(fin)
