"""Fault injection and straggler detection (reference:
``repro/distributed/fault.py``): the vocabulary the serving plane's chaos
harness (``serving/chaos.py``) and the engine's iteration watchdog share.

- ``FaultInjector``: raises ``InjectedFault`` at fixed steps, each once;
- ``FaultSchedule``: a seeded per-step event sampler; a fixed seed and
  call sequence give the same injection points on every run (Python's
  ``random.Random``, the reference's generator, so both packages draw the
  same points);
- ``StragglerMonitor``: flags steps slower than ``factor`` x the median of
  a sliding window;
- ``PreemptionGuard``: a SIGTERM-style flag that ``Engine.serve`` turns
  into a graceful drain (``Engine(guard=...)``);
- ``run_with_recovery``: the bounded-restart supervisor; the router
  restarts dead replicas through it (``serving/router.py``). The training
  loop that the reference also supervises with it is not ported.
"""

from __future__ import annotations

import dataclasses
import random
import signal
import statistics
import time
from typing import Callable, Optional, Sequence, Tuple


class InjectedFault(RuntimeError):
    """Deterministic fault for recovery tests."""


@dataclasses.dataclass
class FaultInjector:
    """Raise :class:`InjectedFault` at ``fail_at_step`` or at each of
    ``fail_at_steps``, each point at most once."""

    fail_at_step: int = -1
    fail_at_steps: Tuple[int, ...] = ()
    fired: bool = False

    def __post_init__(self):
        self._pending = set(self.fail_at_steps)

    def check(self, step: int) -> None:
        if step == self.fail_at_step and not self.fired:
            self.fired = True
            raise InjectedFault(f"injected node failure at step {step}")
        if step in self._pending:
            self._pending.discard(step)
            self.fired = True
            raise InjectedFault(f"injected node failure at step {step}")


class FaultSchedule:
    """Seeded per-step event sampler: ``fires(step)`` draws once per call
    from a private generator; ``rate`` is the per-step probability."""

    def __init__(self, seed: int, rate: float):
        self.rate = rate
        self._rng = random.Random(seed)
        self.fired_at: list = []

    def fires(self, step: int) -> bool:
        hit = self._rng.random() < self.rate
        if hit:
            self.fired_at.append(step)
        return hit

    def pick(self, items: Sequence):
        """Deterministically choose one of ``items`` (an injection target)."""
        return items[self._rng.randrange(len(items))]


class StragglerMonitor:
    """Sliding-window step-time watchdog: ``record`` flags a step slower
    than ``factor`` x the median of the last ``window`` steps (from the
    fifth step on) and calls ``on_straggler(step, seconds, median)``."""

    def __init__(self, window: int = 20, factor: float = 3.0,
                 on_straggler: Optional[Callable] = None):
        self.window = window
        self.factor = factor
        self.on_straggler = on_straggler
        self.times: list = []
        self.flagged: list = []

    def record(self, step: int, seconds: float) -> bool:
        self.times.append(seconds)
        hist = self.times[-self.window:]
        if len(hist) >= 5:
            med = statistics.median(hist)
            if seconds > self.factor * med:
                self.flagged.append((step, seconds, med))
                if self.on_straggler:
                    self.on_straggler(step, seconds, med)
                return True
        return False

    @property
    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0


class PreemptionGuard:
    """Turns SIGTERM / SIGINT into a cooperative flag (``requested``); the
    serving loop drains when it sees it raised."""

    def __init__(self, install_handlers: bool = False):
        self.requested = False
        if install_handlers:  # not in tests: pytest owns the signals
            signal.signal(signal.SIGTERM, self._handler)
            signal.signal(signal.SIGINT, self._handler)

    def _handler(self, signum, frame):
        self.requested = True

    def request(self) -> None:
        """Raise the flag by hand (tests, an external agent)."""
        self.requested = True


def run_with_recovery(loop_fn: Callable[[Optional[int]], object], max_restarts: int = 3,
                      on_restart: Optional[Callable] = None):
    """Supervise ``loop_fn(resume_step)``: call it with ``None`` and return
    its result; on an exception call it again, up to ``max_restarts``
    times, then re-raise. ``on_restart(attempt, error)`` runs before each
    retry."""
    attempts = 0
    while True:
        try:
            return loop_fn(None)
        except Exception as e:  # noqa: BLE001
            attempts += 1
            if attempts > max_restarts:
                raise
            if on_restart:
                on_restart(attempts, e)
            time.sleep(0.01)
