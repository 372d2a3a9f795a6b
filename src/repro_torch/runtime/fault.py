"""Fault-tolerance runtime: watchdog, bounded restarts, fault injection.

On a real pod the failure domains are: chip/host death (job restarts from
the latest checkpoint on spare capacity), stragglers (synchronous SPMD turns
them into global slowdowns — the watchdog flags steps exceeding the
deadline), and silent data corruption (checkpoint checksums).  This module
implements the *control plane* of that story in-process so it is testable:

* :func:`run_with_restarts` — supervises a step function; on a (possibly
  injected) failure it reloads the latest checkpoint and resumes, up to
  ``max_restarts``; the deterministic data pipeline guarantees no sample is
  replayed or skipped.
* :class:`Watchdog` — per-step deadline monitor (straggler mitigation: at
  scale you alert + evict; here we record and expose).
* :class:`FaultInjector` — deterministic failure schedule for tests/examples.

Counterpart: ``repro/runtime/fault.py``.  One addition: the watchdog times
steps on the host clock, and a step on the card returns before the card
has run it, so ``Watchdog`` and ``run_with_restarts`` take a ``sync``
callable (``torch.cuda.synchronize`` on the card) called before the clock
is read at the end of a step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class FaultConfig:
    max_restarts: int = 3
    step_deadline_s: float = 60.0


class SimulatedFailure(RuntimeError):
    pass


class FaultInjector:
    """Raises :class:`SimulatedFailure` at the configured global steps."""

    def __init__(self, fail_at_steps: List[int]):
        self.fail_at = set(fail_at_steps)
        self.fired: List[int] = []

    def check(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.append(step)
            raise SimulatedFailure(f"injected failure at step {step}")


class Watchdog:
    """Straggler detector: records step durations, flags deadline misses."""

    def __init__(self, deadline_s: float,
                 sync: Optional[Callable[[], None]] = None):
        self.deadline_s = deadline_s
        self.sync = sync
        self.durations: List[float] = []
        self.violations: List[int] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int):
        assert self._t0 is not None
        if self.sync is not None:
            self.sync()
        dt = time.monotonic() - self._t0
        self.durations.append(dt)
        if dt > self.deadline_s:
            self.violations.append(step)
        self._t0 = None
        return dt


def run_with_restarts(*, total_steps: int, init_state: Callable[[], Dict],
                      step_fn: Callable[[Dict, int], Dict],
                      save_fn: Callable[[Dict, int], None],
                      restore_fn: Callable[[], Optional[tuple]],
                      save_every: int = 10,
                      fault: FaultConfig = FaultConfig(),
                      injector: Optional[FaultInjector] = None,
                      sync: Optional[Callable[[], None]] = None) -> Dict:
    """Supervised training loop.

    ``restore_fn() -> (state, step) | None``; ``step_fn(state, step) ->
    state``.  Returns {"state", "restarts", "watchdog", "completed_steps"}.
    ``sync``: called before the watchdog reads the clock at a step's end.
    """
    watchdog = Watchdog(fault.step_deadline_s, sync)
    restarts = 0
    while True:
        restored = restore_fn()
        if restored is None:
            state, start = init_state(), 0
        else:
            state, last_saved = restored
            start = last_saved + 1
        try:
            for step in range(start, total_steps):
                if injector is not None:
                    injector.check(step)
                watchdog.start()
                state = step_fn(state, step)
                watchdog.stop(step)
                if (step + 1) % save_every == 0 or step == total_steps - 1:
                    save_fn(state, step)
            return {"state": state, "restarts": restarts,
                    "watchdog": watchdog, "completed_steps": total_steps}
        except SimulatedFailure:
            restarts += 1
            if restarts > fault.max_restarts:
                raise
