"""graftshield (port of ``shield/``): the fault-tolerant search runtime.

A supervision layer around ``equation_search``'s host loop and
``Engine.run_iteration``, on by default (``Options(shield=True)``):

1. **Preemption-safe checkpoints** (:mod:`.signals`, :mod:`.checkpoints`):
   SIGTERM/SIGINT set a flag that stops the search at the next iteration
   boundary with an emergency checkpoint; checkpoints roll (the last K,
   digest-verified) and ``resume="auto"`` falls back to the newest valid one.
2. **Watchdog deadlines** (:mod:`.watchdog`): a host thread puts
   ``Options(iteration_deadline, compile_budget)`` on each iteration
   attempt and its sync, and exits with code 124 and every thread's stack
   instead of hanging.
3. **Graceful degradation** (:mod:`.degrade`, :mod:`.quarantine`):
   transient failures (a CUDA out-of-memory first) retry with bounded
   backoff, then the engine steps down; an island whose members are all
   non-finite is reseeded from the hall of fame.
4. **Deterministic fault injection** (:mod:`.faults`): raise on the n-th
   attempt, NaN-poison island i, SIGTERM at iteration k, hang, corrupt a
   checkpoint; ``SR_FAULT_PLAN`` sets a plan for a whole process.

Every fault, retry, degradation and quarantine is a ``fault`` record of
the telemetry stream. The serving half of the JAX package's ``shield/``
(``OverloadLadder``, ``ServeFaultPlan``, ``ServeFaultInjector``) comes with
the serving stack, ROADMAP.md queue 1 item 7.
"""

from .checkpoints import (RollingCheckpointer, discover_resume_path, load_newest_valid,
                          rolled_paths)
from .degrade import ShieldRunner, is_transient_failure
from .faults import FaultInjector, FaultPlan, InjectedFault, active_injector
from .quarantine import IslandQuarantine
from .signals import PreemptionGuard
from .watchdog import Watchdog, WatchdogTimeout

__all__ = ["RollingCheckpointer", "discover_resume_path", "load_newest_valid", "rolled_paths",
           "ShieldRunner", "is_transient_failure", "FaultInjector", "FaultPlan",
           "InjectedFault", "active_injector", "IslandQuarantine", "PreemptionGuard", "Watchdog",
           "WatchdogTimeout"]
