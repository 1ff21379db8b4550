"""Search observability: SRLogger payloads incl. pareto volume.

A copy of the JAX package's ``utils/logging.py`` (reading the port's
tensors on the host). The analogue of the reference's src/Logging.jl:
wraps any backend with a
`log_interval`, and emits per-iteration payloads containing population
complexity histograms, the pareto front (equations + losses), num_evals,
and the **pareto volume** — the area under the convex hull in
(log complexity, log loss) space computed by gift-wrapping
(pareto_volume/convex_hull, src/Logging.jl:157-215).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["SRLogger", "pareto_volume", "convex_hull"]


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as numpy."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def convex_hull(xy: np.ndarray) -> np.ndarray:
    """Gift-wrapping (Jarvis march) convex hull of 2D points
    (src/Logging.jl:157-179)."""
    xy = np.asarray(xy, dtype=float)
    n = xy.shape[0]
    if n < 3:
        return xy
    # leftmost point
    start = int(np.argmin(xy[:, 0]))
    hull: List[int] = []
    p = start
    while True:
        hull.append(p)
        q = (p + 1) % n
        for r in range(n):
            cross = (xy[q, 0] - xy[p, 0]) * (xy[r, 1] - xy[p, 1]) - (
                xy[q, 1] - xy[p, 1]
            ) * (xy[r, 0] - xy[p, 0])
            if cross < 0:
                q = r
        p = q
        if p == start or len(hull) > n:
            break
    return xy[hull]


def pareto_volume(
    losses: Sequence[float], complexities: Sequence[int], maxsize: int,
    use_linear_scaling: bool = False,
) -> float:
    """Area under the pareto curve in scaled (log complexity, log loss)
    space (src/Logging.jl:181-215): hull closed with corner points at
    (log(maxsize+1), max log-loss)."""
    losses = np.asarray(losses, dtype=float)
    complexities = np.asarray(complexities, dtype=float)
    keep = np.isfinite(losses) & (losses > 0 if not use_linear_scaling else True)
    losses, complexities = losses[keep], complexities[keep]
    if len(losses) == 0:
        return 0.0
    y = losses if use_linear_scaling else np.log10(losses + 1e-150)
    x = np.log10(complexities)
    max_y, min_y = float(np.max(y)), float(np.min(y))
    if max_y == min_y:
        max_y = min_y + 1.0
    # close the curve with the corner (log(maxsize+1), max_y) and
    # (min x, max_y) so the area is bounded:
    x_top = math.log10(maxsize + 1)
    xs = np.concatenate([x, [x_top, float(np.min(x))]])
    ys = np.concatenate([y, [max_y, max_y]])
    hull = convex_hull(np.stack([xs, ys], axis=1))
    # shoelace (hull is in order from gift wrapping)
    area = 0.0
    for i in range(len(hull)):
        x1, y1 = hull[i]
        x2, y2 = hull[(i + 1) % len(hull)]
        area += x1 * y2 - x2 * y1
    return abs(area) / 2.0


@dataclasses.dataclass
class SRLogger:
    """Interval logger (src/Logging.jl:39-55).

    ``backend`` is any callable ``(payload: dict) -> None``; e.g. print,
    a TensorBoard writer wrapper, or a JSONL file sink. Payload structure
    mirrors the reference's nested dict of complexity histograms, pareto
    front, pareto volume, num_evals.
    """

    backend: Optional[Callable[[Dict[str, Any]], None]] = None
    log_interval: int = 1
    jsonl_path: Optional[str] = None
    _records: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    _count: int = 0

    def log_iteration(self, *, iteration, hofs, states, options, num_evals,
                      elapsed, host_fraction: Optional[float] = None) -> None:
        self._count += 1
        if self._count % max(self.log_interval, 1) != 0:
            return
        payload: Dict[str, Any] = {
            "iteration": int(iteration),
            "num_evals": float(num_evals),
            "elapsed_s": float(elapsed),
            "evals_per_sec": float(num_evals) / max(float(elapsed), 1e-9),
            "outputs": [],
        }
        if host_fraction is not None:
            # Host-pacing share of loop time (ResourceMonitor) — the
            # telemetry hub passes it so logger backends can alert on
            # host-bound searches without scraping stdout.
            payload["host_fraction"] = float(host_fraction)
        for j, (hof, state) in enumerate(zip(hofs, states)):
            frontier = hof.pareto_frontier()
            losses = [e.loss for e in frontier]
            complexities = [e.complexity for e in frontier]
            sizes = _host(state.pops.complexity).reshape(-1)
            hist, _ = np.histogram(
                sizes, bins=np.arange(0.5, options.maxsize + 1.5)
            )
            payload["outputs"].append(
                {
                    "output": j + 1,
                    "min_loss": float(min(losses)) if losses else None,
                    "pareto_volume": pareto_volume(
                        losses, complexities, options.maxsize,
                        use_linear_scaling=(options.loss_scale == "linear"),
                    ),
                    "frontier": [
                        {"complexity": int(c), "loss": float(l)}
                        for c, l in zip(complexities, losses)
                    ],
                    "complexity_histogram": hist.tolist(),
                }
            )
        self._records.append(payload)
        if self.backend is not None:
            self.backend(payload)
        if self.jsonl_path is not None:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(payload) + "\n")

    @property
    def records(self) -> List[Dict[str, Any]]:
        return self._records
