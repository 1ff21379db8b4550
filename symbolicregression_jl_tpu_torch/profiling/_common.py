"""Shared setup of the port's profiling scripts: the bench problem.

Counterpart of the repo's ``profiling/_common.py``: every profile stays
anchored to the headline bench's workload (10,000 rows, 5 features,
operators ``+ - * /`` and ``exp abs cos``, maxsize 30), built here with the
port's Options, dataset and Engine on an explicit device.
"""

from __future__ import annotations

N_ROWS = 10_000
N_FEATURES = 5


def make_bench_problem(n_rows: int = N_ROWS, nfeatures: int = N_FEATURES, device=None,
                       **options_kw):
    """(options, dataset, engine) on the bench workload, the data from numpy
    seed 0 as the JAX package's profiling scripts draw it. ``device``: None
    means the card (``device="cpu"`` for the CPU)."""
    import numpy as np

    from ..core.dataset import make_dataset
    from ..core.options import Options
    from ..device import resolve_device
    from ..evolve.engine import Engine

    dev = resolve_device(device)
    kw = dict(binary_operators=["+", "-", "*", "/"], unary_operators=["exp", "abs", "cos"],
              maxsize=30, save_to_file=False)
    kw.update(options_kw)
    options = Options(**kw)
    rng = np.random.default_rng(0)
    X = rng.uniform(-3.0, 3.0, (n_rows, nfeatures)).astype(np.float32)
    y = (np.cos(2.13 * X[:, 0]) + 0.5 * X[:, 1] * np.abs(X[:, 2]) ** 0.9
         - 0.3 * np.abs(X[:, 3]) ** 1.5).astype(np.float32)
    ds = make_dataset(X, y, device=dev)
    ds.update_baseline_loss(options.elementwise_loss)
    engine = Engine(options, ds.nfeatures, device=dev)
    return options, ds, engine
