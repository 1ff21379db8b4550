"""The multi-chip projection's interface (port of ``bench/projection.py``).

The JAX package projects a v5e-8 figure from its measured single-chip rate
and a closed-form ICI byte model (``profiling/ici_model.py``). That model
is of a TPU v5e slice and its inter-chip links; it says nothing of an
H100 or of ranks sharing one card, so the port makes no projection:
``v5e8_comm_efficiency`` and ``load_ici_model`` raise NotImplementedError
naming the TPU model, and the port's headline prints no projected number.
Multi-device throughput is measured, not projected (mesh/dryrun.py, and
the bench's sharded cells).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

__all__ = ["load_ici_model", "v5e8_comm_efficiency", "profiling_dir"]

_REFUSAL = ("the v5e-8 projection is a model of a TPU v5e slice's ICI links "
            "(profiling/ici_model.py); the PyTorch port projects no TPU figure")


def profiling_dir() -> str:
    """``<repo root>/profiling`` for a checkout of this package."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), "profiling")


def load_ici_model():
    """Refused: the ICI byte model is the TPU's (module docstring)."""
    raise NotImplementedError(_REFUSAL)


def v5e8_comm_efficiency(iter_seconds: float, *, islands: int = 512 * 8,
                         population_size: int = 256, maxsize: int = 30, topn: int = 12,
                         n_devices: int = 8, ici_gbps: float = 400.0
                         ) -> Tuple[float, Dict[str, Any]]:
    """Refused: the JAX package's weak-scaling bound for a TPU v5e-8 from
    its ICI model (module docstring)."""
    raise NotImplementedError(_REFUSAL)
