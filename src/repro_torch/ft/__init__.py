"""Fault tolerance (torch port of ``repro.ft``): fault injection, bounded
retries, the watchdog, the at-rest scrub, the chaos matrix, straggler
skipping and elastic mesh shrinking."""
from .straggler import DeadlineSkipper, StragglerStats
from .watchdog import Watchdog
from .elastic import shrink_mesh_shape
from .faults import (CrashInjected, FaultEvent, FaultInjected, FaultInjector,
                     FaultSpec, fault_point, inject, inject_bitrot)
from .retry import RetryExhausted, RetryHealth, RetryPolicy
from .scrub import ScrubFinding, ScrubReport

__all__ = ["DeadlineSkipper", "StragglerStats", "Watchdog",
           "shrink_mesh_shape", "CrashInjected", "FaultEvent",
           "FaultInjected", "FaultInjector", "FaultSpec", "fault_point",
           "inject", "inject_bitrot", "RetryExhausted", "RetryHealth",
           "RetryPolicy", "ScrubFinding", "ScrubReport"]
