"""One data-parallel serving replica: an ``Engine`` session plus the
control-plane surface the router drives it through (reference:
``repro/serving/replica.py``).

Every replica shares the same immutable packed-ternary weights, so a
replica's state is only its mutable KV pages and its host bookkeeping:
the state the paged engine already keeps refcounted, serializable and
recomputable from a prefix. A ``Replica`` wraps one engine's resumable
session (``start_session`` / ``run_iteration``) and adds:

- a token journal: after every step, a host copy of each decoding slot's
  emitted tokens, by rid. When the replica dies, the router folds an
  orphan's journal into its prompt and re-admits it elsewhere, where the
  greedy decode continues bit for bit. Queued and mid-prefill requests
  get no entry: after a preemption inside the engine their emitted tokens
  are already in ``req.tokens``, and an entry would fold them twice;
- a heartbeat, stamped on the replica's clock when a step begins;
- the session's ``StragglerMonitor`` flags, which the router polls;
- fault hooks: ``kill()`` (the device state is gone, only the host
  bookkeeping survives), ``stall(s)`` (the next iteration sleeps inside
  the monitored window) and ``restart_faults``, an injector that makes
  ``restart()`` itself fail (``run_with_recovery`` retries it);
- evacuation: ``drain()`` (cooperative: the fold, and the KV handoff
  payloads of ``Engine.drain_session``) and ``abandon()`` (after a death:
  host-only page release; the journal is the only source of tokens).

``Transport`` is the byte channel handoffs cross. ``LocalTransport`` is an
in-process copy with deterministic faults (``corrupt_next``,
``truncate_next``) so the checksummed wire format can be shown to catch
them.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.distributed.fault import FaultInjector
from repro_torch.serving.engine import Engine, ServeStats
from repro_torch.serving.scheduler import FinishedRequest, Request


class ReplicaDead(RuntimeError):
    """The replica's device state is gone (a crash or a kill); only its
    host bookkeeping survives, and the router abandons the session and
    migrates its requests cold."""

    def __init__(self, name: str):
        super().__init__(f"replica {name} is dead")
        self.name = name


class Transport:
    """Byte channel for handoffs between replicas: ``send`` returns what
    the receiver observes, which may be corrupted, torn or dropped."""

    def send(self, payload: bytes) -> bytes:  # pragma: no cover - interface
        raise NotImplementedError


class LocalTransport(Transport):
    """In-process transport: a byte copy, and one-shot faults:
    ``corrupt_next()`` flips the byte in the middle of the next payload
    (inside a page chunk, so a page crc catches it), ``truncate_next()``
    tears it in half."""

    def __init__(self):
        self.sent = 0
        self.corrupted = 0
        self._corrupt_armed = False
        self._truncate_armed = False

    def corrupt_next(self) -> None:
        self._corrupt_armed = True

    def truncate_next(self) -> None:
        self._truncate_armed = True

    def send(self, payload: bytes) -> bytes:
        self.sent += 1
        if self._corrupt_armed:
            self._corrupt_armed = False
            self.corrupted += 1
            buf = bytearray(payload)
            buf[len(buf) // 2] ^= 0xFF
            return bytes(buf)
        if self._truncate_armed:
            self._truncate_armed = False
            self.corrupted += 1
            return payload[: max(len(payload) // 2, 1)]
        return bytes(payload)


class Replica:
    """One engine behind the router. All device work happens in ``step()``
    (one engine iteration); the rest is host-side control. A restart opens
    a fresh session on the same engine: its weights are never reloaded."""

    def __init__(self, name: str, engine: Engine, clock: Optional[Callable[[], float]] = None):
        self.name = name
        self.engine = engine
        self._clock = clock or time.monotonic
        self.ctx = None  # the live session; None once abandoned or sealed
        self.dead = False
        # rid -> emitted tokens as of the last completed iteration,
        # rebuilt every step (module docstring)
        self.journal: Dict[int, np.ndarray] = {}
        self.heartbeat = self._clock()
        self._stall_s = 0.0
        self._user_hook: Optional[Callable] = None
        # deterministic restart failures, checked once per restart() call
        self.restart_faults: Optional[FaultInjector] = None
        self._restart_no = 0
        self.restarts = 0
        # the sealed ServeStats of every earlier session
        self.past_stats: List[ServeStats] = []

    # -- session lifecycle ----------------------------------------------
    def start(self, stop_token: Optional[int] = None,
              on_iteration: Optional[Callable] = None) -> None:
        """Open an empty session. ``on_iteration`` runs after the
        replica's own stall hook, so an injected stall lies inside the
        window the session's monitor times."""
        self._user_hook = on_iteration
        self.ctx = self.engine.start_session([], stop_token=stop_token,
                                             on_iteration=self._on_iteration)
        self.dead = False
        self.journal = {}
        self.heartbeat = self._clock()

    def _on_iteration(self, ctx) -> None:
        if self._stall_s > 0.0:
            time.sleep(self._stall_s)  # inside the span run_iteration times
            self._stall_s = 0.0
        if self._user_hook is not None:
            self._user_hook(ctx)

    def submit(self, req: Request) -> bool:
        if self.dead or self.ctx is None:
            raise ReplicaDead(self.name)
        return self.engine.submit_to_session(self.ctx, req)

    def busy(self) -> bool:
        return self.ctx is not None and not self.dead and not self.ctx.sched.idle()

    def load(self) -> Tuple[int, int]:
        """Placement key: (requests in flight, -free pages); fewer requests
        win, and more free pages break a tie."""
        if self.ctx is None or self.dead:
            return (1 << 30, 0)
        sched = self.ctx.sched
        n = len(sched.queue) + len(sched.active_slots())
        free = self.ctx.pool.available() if self.ctx.pool is not None else 0
        return (n, -free)

    def step(self) -> bool:
        """One engine iteration. Raises ``ReplicaDead`` once killed; any
        error out of the engine propagates for the router to classify.
        Refreshes the journal and the heartbeat."""
        if self.dead:
            raise ReplicaDead(self.name)
        if self.ctx is None or self.ctx.sched.idle():
            return False
        self.heartbeat = self._clock()  # a step began
        progress = self.engine.run_iteration(self.ctx)
        self._refresh_journal()
        return progress

    def _refresh_journal(self) -> None:
        """Rebuild the journal from the sync point's device state, for the
        decoding slots only (module docstring)."""
        ctx = self.ctx
        self.journal = {}
        decoding = [s for s in ctx.sched.active_slots()
                    if s not in ctx.prefilling and s not in ctx.draft_prefilling]
        if not decoding:
            return
        n_gen = ctx.state.n_gen.cpu().numpy()
        out = ctx.state.out.cpu().numpy()
        for s in decoding:
            req = ctx.sched.slot_req[s]
            self.journal[req.rid] = out[s, : int(n_gen[s])].astype(np.int32, copy=True)

    def take_finished(self) -> List[FinishedRequest]:
        """The terminal records since the last call."""
        if self.ctx is None:
            return []
        out = list(self.ctx.finished)
        self.ctx.finished.clear()
        return out

    # -- health signals --------------------------------------------------
    def straggler_flags(self) -> int:
        if self.ctx is None or self.ctx.monitor is None:
            return 0
        return len(self.ctx.monitor.flagged)

    def heartbeat_age(self) -> float:
        return self._clock() - self.heartbeat

    # -- fault hooks -----------------------------------------------------
    def kill(self) -> None:
        """A crash: the device state is lost. The journal keeps its last
        snapshot, which is what a monitor knows of a dead worker."""
        self.dead = True

    def stall(self, seconds: float) -> None:
        """Make the next iteration a straggler (a sleep inside the
        monitored window)."""
        self._stall_s = float(seconds)

    # -- evacuation ------------------------------------------------------
    def drain(self, with_handoffs: bool = False) -> Tuple[List[Request], Dict[int, bytes]]:
        """Evacuate the live session (warm migration): every request comes
        back folded, and decoding slots ship their rows when
        ``with_handoffs``. The session stays open and idle."""
        if self.dead or self.ctx is None:
            raise ReplicaDead(self.name)
        drained, handoffs = self.engine.drain_session(self.ctx, with_handoffs=with_handoffs)
        self.journal = {}
        return drained, handoffs

    def abandon(self) -> List[Request]:
        """Harvest a dead replica's host bookkeeping: the orphaned requests
        (not folded: the router folds the journal) and every page their
        slots held, so the pool reconciles with no device work."""
        if self.ctx is None:
            return []
        orphans = self.engine.abandon_session(self.ctx)
        self.seal()
        return orphans

    def seal(self) -> None:
        """Close the session, keeping its stats for the fleet's accounts."""
        if self.ctx is not None:
            self.engine.finish_session(self.ctx)
            self.past_stats.append(self.ctx.stats)
            self.ctx = None

    def restart(self, stop_token: Optional[int] = None) -> "Replica":
        """Bring a dead replica back with a fresh session on the same
        engine. ``restart_faults`` may fail the attempt (``InjectedFault``),
        which the router's ``run_with_recovery`` retries."""
        self._restart_no += 1
        if self.restart_faults is not None:
            self.restart_faults.check(self._restart_no)
        self.start(stop_token=stop_token, on_iteration=self._user_hook)
        self.restarts += 1
        return self

    # -- the warm-migration receiving side --------------------------------
    def import_handoff(self, tokens, blob: bytes) -> int:
        """Seed this replica's prefix tree from a payload; the tokens
        seeded (0: cold). ``HandoffError`` on a corrupted or torn one."""
        if self.dead or self.ctx is None:
            raise ReplicaDead(self.name)
        return self.engine.import_handoff(self.ctx, tokens, blob)
