"""Shape-bucket padding: grow a dataset to its admission bucket's row
count with rows that are provably inert (a copy of the JAX package's
``pack/padding.py``; the same fills give the same bytes).

Why replicas and not zeros: the kernels' validity test (kernels #1-#3,
csrc/interp.cuh) reads every *materialized* row — weights gate the loss
sum, they do NOT gate finiteness tracking. A zero-filled pad row would run every tree through
operators at x=0 (div, log, inverse-sqrt gradients...), and one
non-finite value there would invalidate the whole tree even though the
row carries zero weight. A pad row that **replicates a real row**
cannot do that: it computes bit-for-bit the same values as its source
row, so it is finite exactly when the source row is — validity is
unchanged by construction, with zero kernel changes.

The three inertness guarantees (pinned by tests/test_torch_pack.py and
``chip_smoke.py`` phase 31):

- **loss**: the kernel zeroes zero-weight elements before the weighted
  sum (csrc/interp.cuh ``loss_term``: ``rn_mul(w > 0 ? elt : 0, w)``),
  so a pad row contributes exactly ``+0.0``; lane j sums rows j, j + W,
  ... in row order from 0, so the pad rows at the end add their zeros
  after every real row — bit-identical sums, not just close;
- **gradients**: the constant optimizer's cotangent on a zero-weight
  row is exactly 0, and the replica's forward chain is finite wherever
  the source row's is, so ``0 × finite = 0`` (never ``0 × inf = NaN``);
- **validity**: see above.

``fill`` selects WHICH real rows the pad replicates. Production always
uses ``"cyclic"``; ``"edge"`` exists so the masking-completeness test
can pin that pad *content* cannot influence a search at all (two
different fills must produce bit-identical results).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["pad_to_bucket"]


def pad_to_bucket(
    X: np.ndarray,
    y: np.ndarray,
    *,
    rows: int,
    fill: str = "cyclic",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad ``X [n, f]`` / ``y [n]`` to ``rows`` total rows.

    Returns ``(Xp, yp, weights)`` where ``weights`` is 1.0 on the ``n``
    real rows and 0.0 on the ``rows - n`` pad rows. ``fill="cyclic"``
    makes pad row ``j`` a copy of real row ``j % n``; ``fill="edge"``
    replicates the single middle row (test-only, see module docstring).
    Deterministic in (n, rows, fill) only, so a journal replay pads
    identically. ``rows == n`` returns copies with all-ones weights.
    """
    X = np.asarray(X)
    y = np.asarray(y)
    n = int(X.shape[0])
    rows = int(rows)
    if rows < n:
        raise ValueError(f"cannot pad {n} rows down to {rows}")
    if n == 0:
        raise ValueError("cannot pad an empty dataset")
    pad = rows - n
    if fill == "cyclic":
        src = np.arange(pad) % n
    elif fill == "edge":
        src = np.full(pad, n // 2)
    else:
        raise ValueError(f"unknown pad fill {fill!r}")
    Xp = np.concatenate([X, X[src]], axis=0)
    yp = np.concatenate([y, y[src]], axis=0)
    weights = np.zeros(rows, dtype=X.dtype if X.dtype.kind == "f"
                       else np.float32)
    weights[:n] = 1.0
    return Xp, yp, weights
