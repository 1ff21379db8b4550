"""Terminal progress bar for the search loop.

A copy of the JAX package's ``utils/progress.py``. The WrappedProgressBar
analogue (reference src/ProgressBars.jl:9-58):
a single-line bar with a live hall-of-fame postfix (best loss, eval rate),
redirected to devnull in test environments
(src/ProgressBars.jl:16-20 semantics via SYMBOLIC_REGRESSION_IS_TESTING).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional, TextIO

__all__ = ["ProgressBar"]


class ProgressBar:
    def __init__(self, total: int, width: int = 30,
                 stream: Optional[TextIO] = None):
        self.total = max(int(total), 1)
        self.width = width
        if stream is None:
            stream = (
                open(os.devnull, "w")
                if os.environ.get("SYMBOLIC_REGRESSION_IS_TESTING")
                else sys.stderr
            )
        self.stream = stream
        self.start = time.time()
        self.count = 0

    def update(self, count: int, best_loss: float = float("nan"),
               evals_per_sec: float = float("nan"),
               host_fraction: Optional[float] = None) -> None:
        self.count = count
        frac = min(count / self.total, 1.0)
        filled = int(frac * self.width)
        bar = "█" * filled + "░" * (self.width - filled)
        elapsed = time.time() - self.start
        eta = elapsed / frac - elapsed if frac > 0 else float("inf")
        host = "" if host_fraction is None else f"  host {host_fraction:.0%}"
        postfix = (
            f"best_loss={best_loss:.4g}  {evals_per_sec:,.0f} evals/s  "
            f"eta {eta:,.0f}s{host}"
        )
        self.stream.write(f"\r{bar} {count}/{self.total}  {postfix}   ")
        self.stream.flush()

    def close(self) -> None:
        if self.count:
            self.stream.write("\n")
        self.stream.flush()
        if self.stream not in (sys.stderr, sys.stdout):
            self.stream.close()
