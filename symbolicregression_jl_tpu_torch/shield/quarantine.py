"""Island quarantine: detect and reseed NaN-storm-collapsed islands.

Port of ``symbolicregression_jl_tpu/shield/quarantine.py``. An island whose
members are all non-finite is blind: tournament selection cannot rank
them, every child of a NaN-constant parent is NaN, and the island spends
its share of every launch producing nothing. The quarantine reseeds such
islands from the hall of fame (``Engine.reseed_islands``, on the device)
and the search goes on.

Detection reads one [I] vector of invalid fractions
(``Engine.island_invalid_fractions``) per iteration: one small
device-to-host copy and the one extra host sync the feature adds. The
default threshold is 1.0: only a fully collapsed island is quarantined,
so a healthy search (whose early random members may well include
non-finite ones) is bit-identical with the feature on or off.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["IslandQuarantine"]


class IslandQuarantine:
    """Quarantine policy for one search: checks each output's state once
    per iteration."""

    def __init__(self, threshold: float = 1.0, telemetry=None) -> None:
        self.threshold = float(threshold)
        self.telemetry = telemetry
        self.reseeds_total = 0

    def check_and_reseed(self, engine, state, *, iteration: int = 0, output: int = 1):
        """Returns the state, reseeded where an island crossed the
        threshold and the hall of fame has an entry to reseed from; left
        alone otherwise (a storm before the first hall-of-fame entry is
        left to evolution's randomizing mutations)."""
        fracs = engine.island_invalid_fractions(state).cpu().numpy()
        mask = fracs >= self.threshold
        if not mask.any():
            return state
        if not bool(state.hof.exists.any()):
            return state
        self.reseeds_total += int(mask.sum())
        if self.telemetry is not None:
            self.telemetry.fault(
                "quarantine", iteration=iteration, output=output,
                islands=[int(i) for i in np.nonzero(mask)[0]],
                invalid_fractions=[round(float(f), 4) for f in fracs])
        return engine.reseed_islands(state, torch.as_tensor(mask, device=state.birth.device))
