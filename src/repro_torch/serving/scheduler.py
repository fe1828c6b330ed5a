"""Slot scheduler for continuous batching (reference:
``repro/serving/scheduler.py``; the host-side control plane, no tensors).

The engine holds a fixed number of slots (batch rows of the per-slot
tiered KV cache). This module owns:

- a bounded admission queue (``submit`` returns False when the queue is
  full: the request is shed, never queued without bound);
- the slot table (which request occupies which slot);
- admission pairing: ``next_group`` pairs the strongest-claim queued
  request with every queued request of the same prompt length and the
  same patch shape (or none), up to the number of free slots, so one
  prefill dispatch serves the group;
  ``next_fills`` (chunked admission) gives each free slot the
  strongest-claim queued request, whatever its length;
- retirement, and preemption support: ``requeue`` puts a victim's request
  back in the queue and ``preempt_victims`` ranks the active slots a
  pressured admission or growth may reclaim.

Admission order is by claim, (priority desc, arrival asc), which is FIFO
when every request has the default priority.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.kv_cache import TRAFFIC_KEYS, external_reduction


class SchedulerError(RuntimeError):
    """Slot-table misuse (retiring or requeueing an unoccupied slot),
    carrying the slot index."""

    def __init__(self, msg: str, slot: Optional[int] = None):
        if slot is not None:
            msg = f"{msg} (slot={slot})"
        super().__init__(msg)
        self.slot = slot


@dataclasses.dataclass(eq=False)
class Request:
    """One generation request (identity equality: the queue removes by object).

    ``patches`` carries a vision model's image features (n_patches,
    frontend_dim), projected ahead of the prompt at admission.
    ``deadline`` is an absolute time on the engine's clock
    (``Engine(clock=...)``) after which the request expires; ``priority``
    orders admission and bounds preemption (a request preempts only
    strictly weaker claims). The other fields are the engine's: a
    preempted request's emitted tokens fold into ``tokens``,
    ``orig_prompt_len`` keeps where the real prompt ended, and the carried
    ledgers sum what the earlier attempts cost."""

    rid: int
    tokens: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int
    patches: Optional[np.ndarray] = None
    deadline: Optional[float] = None
    priority: int = 0
    # -- engine-managed (preemption / accounting) --
    arrival: Optional[int] = None  # submission order, stamped once
    n_preemptions: int = 0
    orig_prompt_len: Optional[int] = None  # set when emitted tokens fold in
    carry_traffic: Optional[Dict[str, int]] = None  # bytes, earlier attempts
    carry_reused: int = 0  # prefix tokens reused by earlier attempts
    # the speculation ledger of earlier attempts (a preempted speculative
    # request folds its drafted / accepted counts here)
    carry_drafted: int = 0
    carry_accepted: int = 0

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.tokens).shape[-1])

    @property
    def claim(self) -> Tuple[int, int]:
        """Admission and preemption strength: smaller is stronger. Arrival
        breaks priority ties, so the oldest request of the top priority
        can preempt every other one and is itself never preempted."""
        return (-self.priority, self.arrival if self.arrival is not None else 0)


@dataclasses.dataclass
class FinishedRequest:
    """A request's terminal record with its per-sequence DR-traffic ledger
    (bytes, split into ondie_read / ext_read / ondie_write / ext_write).

    ``outcome``: ``finished`` (budget or stop token), ``cancelled``
    (``Engine.cancel``), ``expired`` (deadline) or ``rejected`` (shed by
    the bounded queue before any work ran); the others still surface the
    tokens emitted before the end. ``n_preemptions`` counts the times the
    request was evicted and recomputed from its prefix; its ledger then
    carries the earlier attempts' work too."""

    rid: int
    prompt_len: int
    tokens: np.ndarray  # (n_generated,) int32
    seq_len: int  # prompt + appended decode tokens
    steps: int  # decode dispatches this request was active for
    traffic: Dict[str, int]
    # prompt tokens restored from the shared prefix cache instead of being
    # prefilled (paged serving with prefix sharing, ``serving/paging.py``);
    # the skipped prefill work is absent from ``traffic``
    prefix_tokens_reused: int = 0
    outcome: str = "finished"
    n_preemptions: int = 0
    # speculative decoding: draft proposals the target scored and accepted;
    # every round emits 1 + its accepted proposals, so len(tokens) ==
    # accepted_tokens + rounds; both 0 on non-speculative engines
    drafted_tokens: int = 0
    accepted_tokens: int = 0

    @property
    def acceptance_rate(self) -> float:
        """Fraction of draft proposals the target confirmed (0.0 when
        nothing was drafted)."""
        return self.accepted_tokens / self.drafted_tokens if self.drafted_tokens else 0.0

    @property
    def external_reduction(self) -> float:
        return external_reduction(self.traffic)


def terminal_record(req: Request, outcome: str) -> FinishedRequest:
    """Terminal record of a request that holds no slot (rejected, or
    cancelled / expired while queued). A request preempted earlier still
    surfaces the tokens its attempts emitted (folded into ``tokens`` past
    ``orig_prompt_len``) and their cost (``carry_traffic``)."""
    if req.orig_prompt_len is not None:
        tokens = np.asarray(req.tokens, np.int32)[req.orig_prompt_len:]
        prompt_len = req.orig_prompt_len
    else:
        tokens = np.zeros((0,), np.int32)
        prompt_len = req.prompt_len
    traffic = dict(req.carry_traffic) if req.carry_traffic else {k: 0 for k in TRAFFIC_KEYS}
    return FinishedRequest(
        rid=req.rid, prompt_len=prompt_len, tokens=tokens, seq_len=prompt_len + len(tokens),
        steps=len(tokens), traffic=traffic, prefix_tokens_reused=req.carry_reused,
        outcome=outcome, n_preemptions=req.n_preemptions,
        drafted_tokens=req.carry_drafted, accepted_tokens=req.carry_accepted,
    )


class SlotScheduler:
    """Host-side slot table + bounded claim-ordered admission queue."""

    def __init__(self, n_slots: int, max_queue: Optional[int] = None):
        self.n_slots = n_slots
        self.max_queue = max_queue
        self.queue: Deque[Request] = deque()
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self._arrival = 0

    # -- queue --
    def submit(self, req: Request) -> bool:
        """Enqueue ``req``; False (shed) when the bounded queue is full.
        The arrival stamp is given once and survives requeues, so a
        preempted request keeps its claim."""
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            return False
        if req.arrival is None:
            req.arrival = self._arrival
            self._arrival += 1
        self.queue.append(req)
        return True

    def drop(self, req: Request) -> None:
        """Remove a queued request (cancellation / deadline expiry)."""
        self.queue.remove(req)

    # -- slot table --
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    # -- admission --
    def _pop_best(self) -> Request:
        """Remove and return the strongest-claim queued request."""
        best = min(self.queue, key=lambda r: r.claim)
        self.queue.remove(best)
        return best

    @staticmethod
    def _group_key(req: Request):
        """Requests share a prefill dispatch iff their stacked batch is
        homogeneous: the same prompt length and the same patch shape
        (present with one shape, or absent)."""
        patches = None if req.patches is None else np.asarray(req.patches).shape
        return (req.prompt_len, patches)

    def next_group(self) -> Tuple[List[int], List[Request]]:
        """Pop the strongest-claim queued request plus queued requests of
        the same group key (prompt length, patch shape), in claim order, up
        to the number of free slots. ([], []) when nothing can be
        admitted."""
        free = self.free_slots()
        if not free or not self.queue:
            return [], []
        key = self._group_key(min(self.queue, key=lambda r: r.claim))
        group: List[Request] = []
        for req in sorted(self.queue, key=lambda r: r.claim):
            if len(group) >= len(free):
                break
            if self._group_key(req) == key:
                group.append(req)
        for req in group:
            self.queue.remove(req)
        slots = free[: len(group)]
        for s, req in zip(slots, group):
            self.slot_req[s] = req
        return slots, group

    def next_fills(self) -> List[Tuple[int, Request]]:
        """Chunked admission: pair each free slot with the strongest-claim
        queued request, with no grouping by length (the chunk dispatch has
        one shape whatever the prompt lengths, so nothing waits for a
        partner)."""
        out: List[Tuple[int, Request]] = []
        for s in self.free_slots():
            if not self.queue:
                break
            req = self._pop_best()
            self.slot_req[s] = req
            out.append((s, req))
        return out

    # -- retirement / preemption --
    def retire(self, slot: int) -> Request:
        """Free ``slot`` and return its request."""
        req = self.slot_req[slot]
        if req is None:
            raise SchedulerError("retiring free slot", slot=slot)
        self.slot_req[slot] = None
        return req

    def requeue(self, slot: int) -> Request:
        """Preemption or a failed admission: free ``slot`` and put its
        request back in the queue, past the bound (it was accepted once;
        shedding it now would break the admission contract)."""
        req = self.slot_req[slot]
        if req is None:
            raise SchedulerError("requeueing free slot", slot=slot)
        self.slot_req[slot] = None
        self.queue.appendleft(req)
        return req

    def preempt_victims(self, beneficiary: Request, emitted: Mapping[int, int],
                        exclude: Sequence[int] = ()) -> List[int]:
        """Active slots ``beneficiary`` may reclaim pages from, best victim
        first: only strictly weaker claims, fewest tokens emitted first,
        the newest arrival on a tie (the work cheapest to recompute)."""
        ex = set(exclude)
        cands = [s for s, r in enumerate(self.slot_req)
                 if r is not None and s not in ex and beneficiary.claim < r.claim]
        cands.sort(key=lambda s: (emitted.get(s, 0), -(self.slot_req[s].arrival or 0)))
        return cands

    def idle(self) -> bool:
        """Nothing queued and no slot occupied: the serving loop's exit."""
        return not self.queue and all(r is None for r in self.slot_req)
