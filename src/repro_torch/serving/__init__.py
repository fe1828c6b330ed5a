"""Continuous-batching serving (reference: ``repro/serving``), exported
under the reference's names."""

from repro_torch.core.kv_cache import HandoffError
from repro_torch.serving.chaos import (ChaosConfig, ChaosInjector, FleetChaosConfig,
                                       FleetChaosInjector, InvariantViolation,
                                       check_fleet_invariants, check_serving_invariants)
from repro_torch.serving.engine import DecodeState, Engine, GenerationResult, ServeStats
from repro_torch.serving.paging import PagePool, PagePoolError, PrefixCache
from repro_torch.serving.replica import LocalTransport, Replica, ReplicaDead, Transport
from repro_torch.serving.router import Router, RouterStats
from repro_torch.serving.scheduler import (FinishedRequest, Request, SchedulerError,
                                           SlotScheduler, terminal_record)

__all__ = ["ChaosConfig", "ChaosInjector", "DecodeState", "Engine", "FinishedRequest",
           "FleetChaosConfig", "FleetChaosInjector", "GenerationResult", "HandoffError",
           "InvariantViolation", "LocalTransport", "PagePool", "PagePoolError", "PrefixCache",
           "Replica", "ReplicaDead", "Request", "Router", "RouterStats", "SchedulerError",
           "ServeStats", "SlotScheduler", "Transport", "check_fleet_invariants",
           "check_serving_invariants", "terminal_record"]
