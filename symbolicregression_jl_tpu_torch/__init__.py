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

Units (``equation_search(X_units=, y_units=)`` with
``Options(dimensional_constraint_penalty=)``) run a dimensional check on
the device; ``D`` differentiates host trees symbolically, or template
subexpressions row by row (``eval_diff_tree_array`` and
``eval_grad_tree_array`` take forward-mode derivatives). ``lint/`` holds
the static analyzer and the runtime audits (``Options(debug_checks=True)``),
``bench/`` the matrix, gate and trend CLI.

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
from .core.losses import LOSS_REGISTRY, resolve_loss
from .core.options import ComplexityMapping, MutationWeights, Options
from .evolve.engine import Engine
from .models.spec import ExpressionSpec, ParametricExpressionSpec, TemplateExpressionSpec
from .ops.operators import Op, OperatorSet
from .ops.tree import Node, parse_expression, string_tree

__all__ = [
    "ComplexityMapping",
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
    "LOSS_REGISTRY",
    "load_hall_of_fame_csv",
    "make_dataset",
    "parse_expression",
    "resolve_loss",
    "save_hall_of_fame_csv",
    "search_key",
    "string_tree",
    "warmup",
    "SearchServer",
    "ServerSaturated",
    "D",
    "eval_tree_array",
    "eval_diff_tree_array",
    "eval_grad_tree_array",
    "differentiable_eval_tree_array",
]


def search_key(seed, device=None):
    """The search engine's key for ``seed``: the threefry2x32 key words of
    ``jax.random.key(seed)`` as an int32 tensor [2] holding their uint32
    bits (``evolve/rng.py``), on ``device`` (the CPU by default)."""
    from .evolve import rng

    return rng.key(seed, device=device)


def __getattr__(name):
    # The serve layer and the differentiation API on first use, as in the
    # JAX package.
    if name in ("SearchServer", "ServerSaturated"):
        from . import serve

        return getattr(serve, name)
    if name in ("eval_tree_array", "eval_diff_tree_array", "eval_grad_tree_array",
                "differentiable_eval_tree_array"):
        from .ops import diff

        return getattr(diff, name)
    if name == "D":
        return _dispatch_D
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _dispatch_D(obj, arg=1):
    """The exported ``D`` (src/SymbolicRegression.jl:172 of the Julia
    reference), as the JAX package dispatches it:

    - on a host ``Node``: the symbolic derivative w.r.t. variable index
      ``arg`` (0-based feature, ops/diff.py ``D``);
    - on template or composable subexpression callables: a derivative
      callable w.r.t. argument slot ``arg`` (1-based, the template idiom
      ``D(V, 1)(x)``; models/template.py ``D``)."""
    if isinstance(obj, Node):
        from .ops import diff

        return diff.D(obj, arg)
    from .models import template as _template

    return _template.D(obj, arg)
