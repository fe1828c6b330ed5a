"""Slot scheduler for continuous batching (reference:
``repro/serving/scheduler.py``; the host-side control plane, no tensors).

The engine holds a fixed number of slots (batch rows of the per-slot
tiered KV cache). This module owns the admission queue, the slot table
and grouped admission: ``next_group`` pairs the strongest-claim queued
request with every queued request of the same prompt length, up to the
number of free slots, so one prefill dispatch serves the group. Requests
are taken in arrival order (the reference's claim order at its default
priority).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.kv_cache import external_reduction


@dataclasses.dataclass(eq=False)
class Request:
    """One generation request (identity equality: the queue removes by object)."""

    rid: int
    tokens: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int
    arrival: Optional[int] = None  # submission order, stamped once

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.tokens).shape[-1])


@dataclasses.dataclass
class FinishedRequest:
    """A completed request with its per-sequence DR-traffic ledger (bytes,
    split into ondie_read / ext_read / ondie_write / ext_write)."""

    rid: int
    prompt_len: int
    tokens: np.ndarray  # (n_generated,) int32
    seq_len: int  # prompt + appended decode tokens
    steps: int  # decode dispatches this request was active for
    traffic: Dict[str, int]

    @property
    def external_reduction(self) -> float:
        return external_reduction(self.traffic)


class SlotScheduler:
    """Host-side slot table + claim-ordered admission queue."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.queue: Deque[Request] = deque()
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self._arrival = 0

    def submit(self, req: Request) -> None:
        if req.arrival is None:
            req.arrival = self._arrival
            self._arrival += 1
        self.queue.append(req)

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    def next_group(self) -> Tuple[List[int], List[Request]]:
        """Pop the oldest queued request plus queued requests of the same
        prompt length, up to the number of free slots. ([], []) when
        nothing can be admitted."""
        free = self.free_slots()
        if not free or not self.queue:
            return [], []
        key = min(self.queue, key=lambda r: r.arrival).prompt_len
        group: List[Request] = []
        for req in sorted(self.queue, key=lambda r: r.arrival):
            if len(group) >= len(free):
                break
            if req.prompt_len == key:
                group.append(req)
        for req in group:
            self.queue.remove(req)
        slots = free[: len(group)]
        for s, req in zip(slots, group):
            self.slot_req[s] = req
        return slots, group

    def retire(self, slot: int) -> Request:
        req = self.slot_req[slot]
        if req is None:
            raise RuntimeError(f"retiring free slot (slot={slot})")
        self.slot_req[slot] = None
        return req

    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.slot_req)
