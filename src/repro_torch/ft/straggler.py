"""Straggler mitigation: deadline-based contribution skipping (torch port
of ``repro/ft/straggler.py``; host-side policy, no device code).

At thousands of nodes the step time is max over hosts; a single slow host
(thermal throttle, page cache miss, flaky NIC) sets the pace. Standard
mitigations: (a) skip the straggler's microbatch contribution for the step
(gradient from N-1 replicas is an unbiased estimate), (b) alert + cordon
hosts that straggle persistently.

``DeadlineSkipper`` implements the control logic host-side (policy, EWMA of
step times, per-host offender tracking). The *mechanism* for (a) in SPMD is
a masked gradient: each host contributes ``weight in {0,1}`` and the
all-reduce divides by the sum of weights — expressed in the train step as
the loss mask, so no collective topology changes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class StragglerStats:
    steps: int = 0
    skips: int = 0
    cordoned: List[int] = field(default_factory=list)


class DeadlineSkipper:
    """EWMA deadline policy: a host whose step exceeds
    ``factor * ewma`` is skipped this step; ``cordon_after`` consecutive
    skips flags it for replacement (elastic shrink)."""

    def __init__(self, n_hosts: int, factor: float = 2.0,
                 cordon_after: int = 3, ewma_alpha: float = 0.1):
        self.n_hosts = n_hosts
        self.factor = factor
        self.cordon_after = cordon_after
        self.alpha = ewma_alpha
        self.ewma: Optional[float] = None
        self.consecutive: Dict[int, int] = {h: 0 for h in range(n_hosts)}
        self.stats = StragglerStats()

    def decide(self, host_step_seconds: Dict[int, float]) -> Dict[int, bool]:
        """-> {host: include_in_step}. Updates cordon state."""
        healthy = sorted(host_step_seconds.values())
        median = healthy[len(healthy) // 2]
        if self.ewma is None:
            self.ewma = median
        deadline = self.factor * self.ewma
        include: Dict[int, bool] = {}
        for h, t in host_step_seconds.items():
            ok = t <= deadline
            include[h] = ok
            if ok:
                self.consecutive[h] = 0
            else:
                self.consecutive[h] += 1
                self.stats.skips += 1
                if self.consecutive[h] >= self.cordon_after and \
                        h not in self.stats.cordoned:
                    self.stats.cordoned.append(h)
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * median
        self.stats.steps += 1
        return include

    def contribution_weights(self, include: Dict[int, bool]) -> Dict[int, float]:
        n_in = sum(include.values()) or 1
        return {h: (self.n_hosts / n_in if ok else 0.0)
                for h, ok in include.items()}
