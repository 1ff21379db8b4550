"""PyTorch/CUDA port of ``symbolicregression_jl_tpu``.

``equation_search`` runs here on one NVIDIA GPU for plain expressions,
parametric expressions (``Options(expression_spec=ParametricExpressionSpec(...))``
with ``extra={"class": ...}``) and template expressions, parameter
vectors included (``Options(expression_spec=TemplateExpressionSpec(...))``,
``models/``): f32, an elementwise loss, the built-in operators, the
constant optimizer. Candidate scoring and the per-iteration finalize
re-score go through a hand-written CUDA interpreter kernel
(``csrc/program_eval.cu``, with a parametric form that reads each
member's parameter bank by the row's class), the optimizer's line search and gradient
through two more (``csrc/program_multi.cu``, ``csrc/program_grad.cu``),
and template expressions' call sites through the predict kernel and its
backward (``csrc/program_predict.cu``, ``csrc/program_predict_vjp.cu``);
the rest is eager PyTorch. Module paths mirror the JAX package so each
module's counterpart is easy to find.

The serving stack (``serve/``, ``pack/``): ``SearchServer`` takes many
searches from many tenants on one card, journals every request so it
survives a kill, and packs same-shape requests into lockstep cohorts;
``equation_search`` writes the default diagnostics of ``ledger/``,
``pulse/`` and ``gauge/`` (a cost account, a flight recorder, memory
samples).

The search API is the JAX package's: ``equation_search`` with guesses,
``initial_population``, warm starts (``saved_state``), checkpoints and
``resume``, hall-of-fame CSVs, several outputs and minibatching
(``Options(batching=True)``); ``SRRegressor`` and
``MultitargetSRRegressor`` fit and predict on top of it.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without CUDA and without that request they raise.
"""

from .api.hall_of_fame import (HallOfFame, HallOfFameEntry, load_hall_of_fame_csv,
                               save_hall_of_fame_csv)
from .api.regressor import MultitargetSRRegressor, SRRegressor
from .api.search import RuntimeOptions, SearchState, equation_search, warmup
from .core.dataset import Dataset, make_dataset
from .core.options import MutationWeights, Options
from .evolve.engine import Engine
from .models.spec import ExpressionSpec, ParametricExpressionSpec, TemplateExpressionSpec
from .ops.operators import Op, OperatorSet
from .ops.tree import Node, parse_expression, string_tree

__all__ = [
    "Dataset",
    "Engine",
    "ExpressionSpec",
    "HallOfFame",
    "HallOfFameEntry",
    "MultitargetSRRegressor",
    "MutationWeights",
    "Node",
    "Op",
    "OperatorSet",
    "Options",
    "ParametricExpressionSpec",
    "RuntimeOptions",
    "SRRegressor",
    "SearchState",
    "TemplateExpressionSpec",
    "equation_search",
    "load_hall_of_fame_csv",
    "make_dataset",
    "parse_expression",
    "save_hall_of_fame_csv",
    "string_tree",
    "warmup",
    "SearchServer",
    "ServerSaturated",
]


def __getattr__(name):
    # The serve layer on first use, as in the JAX package.
    if name in ("SearchServer", "ServerSaturated"):
        from . import serve

        return getattr(serve, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
