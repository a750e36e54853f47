"""Straggler mitigation: step-deadline watchdog + slow-rank policy.

A copy of ``repro.runtime.straggler`` (pure Python), kept in the port so
that it imports nothing of the JAX package.  The port's trainer times each
step around ``torch.cuda.synchronize()``, which stands for JAX's
``block_until_ready``.

On a synchronous SPMD mesh a straggling host stalls every collective, so
mitigation is (a) detection via step-time records, (b) policy: either
re-admit (transient), hot-spare swap, or elastic shrink (runtime/elastic).

The watchdog is deliberately host-side and framework-agnostic: it measures
wall time around the blocking wait for each step's result, keeps a
robust (median + MAD) model of expected step time, and raises a
StragglerEvent when `k` consecutive steps exceed the deadline.  The trainer
(launch/train.py) reports it; a checkpoint and the remesh plan
(runtime/elastic.py) are the response it names.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque


class StragglerEvent(RuntimeError):
    def __init__(self, step: int, step_time: float, deadline: float):
        super().__init__(
            f"step {step}: {step_time:.3f}s exceeded deadline "
            f"{deadline:.3f}s")
        self.step = step
        self.step_time = step_time
        self.deadline = deadline


@dataclasses.dataclass
class WatchdogConfig:
    window: int = 50           # steps in the rolling model
    warmup: int = 5            # ignore first N steps (compile)
    tolerance: float = 3.0     # deadline = median * tolerance
    min_deadline_s: float = 1e-3
    consecutive: int = 2       # trips after N consecutive violations


class StepWatchdog:
    def __init__(self, cfg: WatchdogConfig = WatchdogConfig()):
        self.cfg = cfg
        self.times: deque[float] = deque(maxlen=cfg.window)
        self.step = 0
        self._t0 = None
        self._violations = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        """Record one step; raises StragglerEvent when the policy trips."""
        dt = time.perf_counter() - self._t0
        self.step += 1
        if self.step <= self.cfg.warmup:
            return dt
        deadline = self.deadline()
        self.times.append(dt)
        if deadline is not None and dt > deadline:
            self._violations += 1
            if self._violations >= self.cfg.consecutive:
                raise StragglerEvent(self.step, dt, deadline)
        else:
            self._violations = 0
        return dt

    def deadline(self) -> float | None:
        if len(self.times) < 3:
            return None
        s = sorted(self.times)
        median = s[len(s) // 2]
        return max(median * self.cfg.tolerance, self.cfg.min_deadline_s)
