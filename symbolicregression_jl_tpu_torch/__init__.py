"""PyTorch/CUDA port of ``symbolicregression_jl_tpu``.

The plain-expression ``equation_search`` path runs here on one NVIDIA GPU:
f32, an elementwise loss, the built-in operators, no constant optimizer.
Candidate scoring and the per-iteration finalize re-score go through a
hand-written CUDA interpreter kernel (``csrc/program_eval.cu``); the rest
is eager PyTorch. Module paths mirror the JAX package so each module's
counterpart is easy to find.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without CUDA and without that request they raise.
"""

from .api.hall_of_fame import HallOfFame, HallOfFameEntry
from .api.search import equation_search
from .core.dataset import Dataset, make_dataset
from .core.options import MutationWeights, Options
from .evolve.engine import Engine
from .ops.operators import Op, OperatorSet
from .ops.tree import Node, parse_expression, string_tree

__all__ = [
    "Dataset",
    "Engine",
    "HallOfFame",
    "HallOfFameEntry",
    "MutationWeights",
    "Node",
    "Op",
    "OperatorSet",
    "Options",
    "equation_search",
    "make_dataset",
    "parse_expression",
    "string_tree",
]
