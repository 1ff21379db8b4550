"""The port's benchmark matrix, quality gate, trend and load bench
(``python -m symbolicregression_jl_tpu_torch.bench run|gate|trend|load``),
and the headline line (``bench/headline.py``)."""

from __future__ import annotations

from .extract import extract_metrics
from .gate import (
    BASELINE_SCHEMA,
    GATED_METRICS,
    calibrate_bands,
    diff_result,
    load_baseline,
    make_baseline,
)
from .matrix import MATRIX_SHAPES, RESULT_SCHEMA, matrix_cells, run_matrix
from .projection import v5e8_comm_efficiency

__all__ = [
    "extract_metrics", "BASELINE_SCHEMA", "GATED_METRICS", "calibrate_bands", "diff_result",
    "load_baseline", "make_baseline", "MATRIX_SHAPES", "RESULT_SCHEMA", "matrix_cells",
    "run_matrix", "v5e8_comm_efficiency",
]
