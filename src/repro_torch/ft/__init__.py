"""Fault tolerance for the replication path (torch port of ``repro.ft``:
fault injection, bounded retries and the watchdog they use)."""
from .faults import (CrashInjected, FaultEvent, FaultInjected, FaultInjector,
                     FaultSpec, fault_point, inject, inject_bitrot)
from .retry import RetryExhausted, RetryHealth, RetryPolicy
from .watchdog import Watchdog

__all__ = ["Watchdog", "CrashInjected", "FaultEvent", "FaultInjected",
           "FaultInjector", "FaultSpec", "fault_point", "inject",
           "inject_bitrot", "RetryExhausted", "RetryHealth", "RetryPolicy"]
