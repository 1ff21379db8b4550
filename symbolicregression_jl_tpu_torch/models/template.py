"""Template expressions: structured expressions with a user combiner
(port of ``models/template.py``).

- ``TemplateStructure``: K named subexpressions and a ``combine``
  function over ValidVectors. The combiner is any Python function of the
  ValidVector algebra (models/composable.py).
- Arity inference: the combiner is probed with ``ArgumentRecorder``s that
  record how many arguments each subexpression is called with, and
  whether a ``D(...)`` call site appears (``uses_deriv``).
- ``template_spec``: a decorator that reads subexpression and variable
  names off the function's signature.
- Evaluation (:func:`eval_template_batch`): the combiner runs once over
  member-batched callables, so each subexpression call site is one launch
  of kernel #4 over every member (``fused_predict_ad``), and gradients
  flow back through kernel #5. A call site whose arguments are dataset
  columns passes them shared ([F, n]); one whose arguments are other
  subexpressions' outputs ([M, n]) passes one argument block per member
  ([M, F, n]).

Population layout: a template member's trees are a TreeBatch with a key
axis ``[K, L]`` before the slot axis. Its parameter vectors (``ParamVec``
keys of the combiner) ride the member's parameter bank as one flat
[total_params, 1] vector; in the batched evaluation each key is a
:class:`_BatchedParamVec` over every member.
"""

from __future__ import annotations

import dataclasses
import inspect
import re
from types import SimpleNamespace
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.encoding import TreeBatch
from ..ops.fused_eval import fused_predict_ad
from ..ops.operators import OperatorSet
from .composable import ParamVec, ValidVector

__all__ = [
    "TemplateStructure",
    "template_spec",
    "make_template_structure",
    "TemplateReturnError",
    "ArgumentRecorder",
    "D",
    "eval_template_batch",
    "HostTemplateExpression",
    "parse_template_expression",
    "template_from_dict",
]

class TemplateReturnError(TypeError):
    """The combiner returned something other than a ValidVector."""

    def __init__(self):
        super().__init__(
            "Template `combine` must return a ValidVector — use the "
            "ValidVector algebra (subexpression calls and lifted "
            "operators) all the way to the final result."
        )


def _probe_vector() -> ValidVector:
    return ValidVector(torch.ones((1,), dtype=torch.float32), torch.ones((), dtype=torch.bool))


class ArgumentRecorder:
    """Stand-in subexpression that records its call arity during
    inference; ``D(f, k)`` call sites mark the shared record under the
    reserved ``__D__`` key."""

    def __init__(self, key: str, record: Dict[str, int]):
        self._key = key
        self._record = record

    def _mark_deriv(self, argnum: int) -> None:
        self._record["__D__"] = 1

    def __call__(self, *args):
        prev = self._record.get(self._key, -1)
        if prev == -1:
            self._record[self._key] = len(args)
        elif prev != len(args):
            raise ValueError(
                f"Inconsistent number of arguments passed to {self._key!r}: "
                f"{prev} then {len(args)}"
            )
        if args:
            a0 = args[0]
            if isinstance(a0, ValidVector):
                return a0
            return ValidVector(torch.atleast_1d(torch.as_tensor(a0, dtype=torch.float32)),
                               torch.ones((), dtype=torch.bool))
        return _probe_vector()


class TemplateStructure(NamedTuple):
    """Static template configuration: ``combine(exprs, xs)`` (or
    ``combine(exprs, params, xs)`` with parameters), where ``exprs`` and
    ``params`` are attribute namespaces and ``xs`` a tuple of per-feature
    ValidVectors."""

    combine: Callable
    expr_keys: Tuple[str, ...]
    num_features: Tuple[int, ...]       # call arity per expr key
    param_keys: Tuple[str, ...] = ()
    num_params: Tuple[int, ...] = ()    # length per param key
    n_variables: int = 0                # dataset features consumed
    uses_deriv: bool = False            # the combiner contains D(...) call sites

    @property
    def has_params(self) -> bool:
        return len(self.param_keys) > 0

    @property
    def total_params(self) -> int:
        return int(sum(self.num_params))

    @property
    def n_subexpressions(self) -> int:
        return len(self.expr_keys)

    @property
    def param_offsets(self) -> Tuple[int, ...]:
        offs, o = [], 0
        for n in self.num_params:
            offs.append(o)
            o += n
        return tuple(offs)


def _probe(combine, expr_keys, param_keys, nparams, nv: int, record: Dict[str, int]):
    exprs = SimpleNamespace(**{k: ArgumentRecorder(k, record) for k in expr_keys})
    xs = tuple(_probe_vector() for _ in range(nv))
    if param_keys:
        params = SimpleNamespace(**{k: ParamVec(torch.ones((n,), dtype=torch.float32))
                                    for k, n in zip(param_keys, nparams)})
        return combine(exprs, params, xs)
    return combine(exprs, xs)


def make_template_structure(
    combine: Callable,
    *,
    num_features: Optional[Dict[str, int]] = None,
    num_parameters: Optional[Dict[str, int]] = None,
    expressions: Optional[Sequence[str]] = None,
    n_variables: Optional[int] = None,
) -> TemplateStructure:
    """Build a TemplateStructure from a combiner ``combine(exprs, xs)`` /
    ``combine(exprs, params, xs)``. ``num_features`` is inferred by
    probing when not given; pass ``n_variables`` (or ``num_features``)
    when the combiner destructures the variable tuple."""
    num_parameters = dict(num_parameters or {})
    if expressions is None:
        if num_features is None:
            raise ValueError(
                "Pass `expressions=[...]` (subexpression names) or an "
                "explicit `num_features` dict"
            )
        expressions = list(num_features)
    expr_keys = tuple(expressions)
    param_keys = tuple(num_parameters)
    nparams = tuple(int(num_parameters[k]) for k in param_keys)

    if num_features is None:
        record: Dict[str, int] = {}
        tried = [n_variables] if n_variables is not None else list(range(1, 33))
        last_err: Optional[Exception] = None
        inferred_nv = None
        for nv in tried:
            record.clear()
            try:
                out = _probe(combine, expr_keys, param_keys, nparams, nv, record)
            except (TypeError, ValueError, IndexError) as e:  # try the next count
                last_err = e
                continue
            if not isinstance(out, ValidVector):
                raise TemplateReturnError()
            inferred_nv = nv
            break
        if inferred_nv is None:
            raise ValueError(
                f"Could not infer the combiner's variable count; last error: {last_err!r}")
        missing = [k for k in expr_keys if k not in record]
        if missing:
            raise ValueError(
                f"Failed to infer number of features used by {missing} — "
                "the combiner never called them")
        num_features = {k: record[k] for k in expr_keys}
        n_variables = inferred_nv
        uses_deriv = record.get("__D__", 0) > 0
    else:
        if n_variables is None:
            raise ValueError("Pass `n_variables` along with explicit `num_features`")
        # Probe for D(...) call sites only; a combiner that cannot be
        # probed counts as using D (the conservative choice).
        rec2: Dict[str, int] = {}
        try:
            _probe(combine, expr_keys, param_keys, nparams, int(n_variables), rec2)
            uses_deriv = rec2.get("__D__", 0) > 0
        except Exception:
            uses_deriv = True

    return TemplateStructure(
        combine=combine,
        expr_keys=expr_keys,
        num_features=tuple(int(num_features[k]) for k in expr_keys),
        param_keys=param_keys,
        num_params=nparams,
        n_variables=int(n_variables),
        uses_deriv=bool(uses_deriv),
    )


def template_spec(*, expressions: Sequence[str], parameters: Optional[Dict[str, int]] = None):
    """Decorator: the decorated function's signature names, in order, the
    subexpressions, the dataset variables and the parameter vectors::

        @template_spec(expressions=("f", "g"))
        def structure(f, g, x1, x2):
            return f(x1) * f(x1) + g(x2)

    Returns a :class:`~.spec.TemplateExpressionSpec`."""
    parameters = dict(parameters or {})
    expr_keys = tuple(expressions)
    param_keys = tuple(parameters)

    def build(fn: Callable):
        sig_names = list(inspect.signature(fn).parameters)
        for k in expr_keys:
            if k not in sig_names:
                raise ValueError(f"Subexpression {k!r} not in function signature {sig_names}")
        for k in param_keys:
            if k not in sig_names:
                raise ValueError(f"Parameter {k!r} not in function signature {sig_names}")
        var_names = [n for n in sig_names if n not in expr_keys and n not in param_keys]

        def combine(exprs, *rest):
            if param_keys:
                params, xs = rest
            else:
                (xs,) = rest
                params = None
            kw = {k: getattr(exprs, k) for k in expr_keys}
            if len(xs) != len(var_names):
                raise ValueError(
                    f"Template expects {len(var_names)} variables ({var_names}); "
                    f"dataset provides {len(xs)}")
            kw.update(dict(zip(var_names, xs)))
            if params is not None:
                kw.update({k: getattr(params, k) for k in param_keys})
            return fn(**kw)

        structure = make_template_structure(combine, num_parameters=parameters,
                                            expressions=expr_keys, n_variables=len(var_names))
        from .spec import TemplateExpressionSpec

        return TemplateExpressionSpec(structure=structure)

    return build


# ---------------------------------------------------------------------------
# Device-side evaluation
# ---------------------------------------------------------------------------


class _BatchedTreeCallable:
    """Member-batched subexpression: one call evaluates key k of every
    member in the batch, one launch of kernel #4 (``fused``) or its plain
    version. Dataset-column arguments ([n] rows, scalars) go in shared;
    any member-dependent argument ([M, n]) makes the call per-member, every
    argument broadcast to [M, F, n]."""

    def __init__(self, key, trees: TreeBatch, arity_expected: int, operators: OperatorSet,
                 n: int, fused: bool):
        self.key = key
        self.trees = trees           # fields [M, L]
        self.arity_expected = arity_expected
        self.operators = operators
        self.n = n
        self.fused = fused

    def _prep_args(self, args):
        """(rows, shared, valid_in) from the combiner's arguments."""
        if len(args) != self.arity_expected:
            raise ValueError(f"Subexpression {self.key!r} takes {self.arity_expected} "
                             f"arguments; got {len(args)}")
        const = self.trees.const
        valid_in = torch.ones((), dtype=torch.bool, device=const.device)
        rows = []
        shared = True
        for a in args:
            if isinstance(a, ValidVector):
                valid_in = valid_in & a.valid
                x = a.x
            else:
                x = torch.as_tensor(a, dtype=const.dtype, device=const.device)
            if x.dim() >= 2:
                shared = False
            rows.append(x)
        return rows, shared, valid_in

    def _member_x(self, rows):
        """Every argument broadcast to a per-member [M, a, n] block."""
        M = self.trees.length.shape[0]
        const = self.trees.const
        if not rows:
            return torch.zeros((M, 1, self.n), dtype=const.dtype, device=const.device)
        return torch.stack([torch.broadcast_to(torch.atleast_1d(r), (M, self.n)) for r in rows],
                           dim=1).to(const.dtype)

    def derivative(self, argnum: int, *args) -> ValidVector:
        """Row-wise d self(args) / d args[argnum - 1], the ``D`` operator:
        rows are independent, so it is the VJP with an all-ones cotangent,
        one launch of kernel #5 (its gx). First order only: the result
        carries no gradient (structures with D call sites do not run the
        constant optimizer in this port)."""
        if not 1 <= argnum <= self.arity_expected:
            raise ValueError(f"D argnum {argnum} out of range 1..{self.arity_expected} "
                             f"for subexpression {self.key!r}")
        rows, _, valid_in = self._prep_args(args)
        tr = self.trees
        with torch.enable_grad():
            xm = self._member_x(rows).detach().requires_grad_(True)
            detached = TreeBatch(tr.arity, tr.op, tr.feat, tr.const.detach(), tr.length)
            pred, v = fused_predict_ad(detached, xm, self.operators, plain=not self.fused)
            (gx,) = torch.autograd.grad(pred, xm, torch.ones_like(pred))
        deriv = gx[:, argnum - 1, :]
        # Non-finite derivative rows invalidate the member.
        v = v & torch.isfinite(deriv).all(dim=-1)
        deriv = torch.where(torch.isfinite(deriv), deriv, 0.0)
        return ValidVector(deriv, v & valid_in)

    def __call__(self, *args) -> ValidVector:
        rows, shared, valid_in = self._prep_args(args)
        if shared:
            const = self.trees.const
            X = (torch.stack([torch.broadcast_to(torch.atleast_1d(r), (self.n,)) for r in rows])
                 if rows else torch.zeros((1, self.n), dtype=const.dtype, device=const.device))
            X = X.to(const.dtype)
        else:
            X = self._member_x(rows)
        pred, v = fused_predict_ad(self.trees, X, self.operators, plain=not self.fused)
        return ValidVector(pred, v & valid_in)


class _DerivCallable:
    """``D(f, argnum)``: evaluates the row-wise partial derivative of
    subexpression ``f`` with respect to its argnum-th argument (1-based)."""

    def __init__(self, f, argnum: int):
        if not isinstance(argnum, int) or argnum < 1:
            raise ValueError("D argnum must be a positive integer (1-based)")
        self.f = f
        self.argnum = argnum

    def __call__(self, *args):
        f = self.f
        if isinstance(f, ArgumentRecorder):
            f._mark_deriv(self.argnum)
            return f(*args)
        if isinstance(f, _BatchedTreeCallable):
            return f.derivative(self.argnum, *args)
        if isinstance(f, _DerivCallable):  # higher order: D(D(f, i), j)
            raise NotImplementedError(
                "Nested D is not supported on the device evaluator; compose host-side via "
                "symbolic differentiation instead.")
        deriv = getattr(f, "derivative", None)
        if deriv is not None:  # host ComposableExpression
            return deriv(self.argnum)(*args)
        raise TypeError(f"D does not know how to differentiate {type(f).__name__}")


def D(f, argnum: int = 1) -> _DerivCallable:
    """Derivative operator for template combiners: ``D(V, 1)(x)`` inside a
    ``combine`` is dV/darg1 row by row (e.g. force = -D(potential, 1)(r))."""
    return _DerivCallable(f, argnum)


class _BatchedParamVec:
    """Member-batched ParamVec: ``p[i]`` is a [M, 1] column (it broadcasts
    against shared [n] rows and member-batched [M, n] data); a ValidVector
    index gathers per row, [M, n] (per member when the index itself is
    member-batched)."""

    def __init__(self, data: torch.Tensor):  # [M, count]
        self.data = data

    def __getitem__(self, idx):
        if isinstance(idx, ValidVector):
            ix = torch.clamp(idx.x.to(torch.int64), 0, self.data.shape[1] - 1)
            if ix.dim() >= 2:   # member-dependent index [M, n]
                g = torch.gather(self.data, 1, ix)
            else:               # shared index rows [n]
                g = self.data[:, ix]
            return ValidVector(g, idx.valid)
        if isinstance(idx, int):
            if not -len(self) <= idx < len(self):
                raise IndexError(f"parameter index {idx} out of range [0, {len(self)})")
            idx = idx % len(self)
            return self.data[:, idx:idx + 1]
        return self.data[:, idx]

    def __len__(self):
        return self.data.shape[1]

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def eval_template_batch(trees: TreeBatch, X: torch.Tensor, structure: TemplateStructure,
                        operators: OperatorSet, params=None, fused: bool = False):
    """Batched template evaluation of trees [..., K, L] over X [F, n];
    returns (y [..., n], valid [...]). The combiner runs once over
    member-batched callables; with ``fused`` each call site is one launch
    of kernel #4, otherwise its plain version runs. A structure with
    parameter vectors reads them from ``params`` [..., total_params].
    Differentiable with respect to ``trees.const`` (through kernel #5) and
    ``params``."""
    K = structure.n_subexpressions
    batch_shape = trees.arity.shape[:-2]
    flat = trees.reshape(-1, K)
    M = flat.length.shape[0]
    n = X.shape[1]
    exprs = {
        key: _BatchedTreeCallable(
            key, TreeBatch(flat.arity[:, k], flat.op[:, k], flat.feat[:, k], flat.const[:, k],
                           flat.length[:, k]),
            structure.num_features[k], operators, n, fused)
        for k, key in enumerate(structure.expr_keys)
    }
    true = torch.ones((), dtype=torch.bool, device=X.device)
    xs = tuple(ValidVector(X[i], true) for i in range(structure.n_variables))
    if structure.has_params:
        if params is None:
            raise ValueError("Template has parameters but none were provided")
        p_flat = params.reshape(M, structure.total_params)
        pns = SimpleNamespace(**{
            key: _BatchedParamVec(p_flat[:, off:off + cnt])
            for key, off, cnt in zip(structure.param_keys, structure.param_offsets,
                                     structure.num_params)})
        out = structure.combine(SimpleNamespace(**exprs), pns, xs)
    else:
        out = structure.combine(SimpleNamespace(**exprs), xs)
    if not isinstance(out, ValidVector):
        raise TemplateReturnError()
    y = torch.broadcast_to(torch.atleast_2d(out.x), (M, n))
    valid = torch.broadcast_to(out.valid, (M,)) & torch.isfinite(y).all(dim=-1)
    return y.reshape(*batch_shape, n), valid.reshape(batch_shape)


def parse_template_expression(s: str, structure: TemplateStructure,
                              operators: OperatorSet) -> "HostTemplateExpression":
    """Parse ``f = <expr over #1..#k>; g = <expr>`` (components separated
    by ``; `` or newlines) back into a host expression: the round trip of
    :meth:`HostTemplateExpression.string`."""
    from ..ops.tree import parse_expression

    trees: Dict[str, object] = {}
    params = np.zeros((structure.total_params,), np.float64) if structure.has_params else None
    seen_params = set()
    parts = [p.strip() for p in s.replace("\n", ";").split(";") if p.strip()]
    for part in parts:
        if "=" not in part:
            raise ValueError(f"Template component missing '=': {part!r}")
        name, rhs = part.split("=", 1)
        name = name.strip().lstrip("╭├╰ ").strip()
        rhs = rhs.strip()
        if name in structure.expr_keys:
            nf = structure.num_features[structure.expr_keys.index(name)]
            names = [f"x{i + 1}" for i in range(max(nf, 1))]
            trees[name] = parse_expression(re.sub(r"#(\d+)", r"x\1", rhs), operators,
                                           variable_names=names)
        elif name in structure.param_keys:
            if not (rhs.startswith("[") and rhs.endswith("]")):
                raise ValueError(f"Parameter vector {name!r} must be [..]")
            vals = [float(v) for v in rhs[1:-1].split(",") if v.strip()]
            i = structure.param_keys.index(name)
            off, cnt = structure.param_offsets[i], structure.num_params[i]
            if len(vals) != cnt:
                raise ValueError(f"Parameter {name!r} expects {cnt} values; got {len(vals)}")
            params[off:off + cnt] = vals
            seen_params.add(name)
        else:
            raise ValueError(f"Unknown template component {name!r} (expressions: "
                             f"{structure.expr_keys}, parameters: {structure.param_keys})")
    missing = [k for k in structure.expr_keys if k not in trees]
    if missing:
        raise ValueError(f"Template string missing subexpressions: {missing}")
    if structure.has_params:
        if not seen_params:
            # No parameter vector given: leave them unset rather than zero.
            params = None
        else:
            missing_p = [k for k in structure.param_keys if k not in seen_params]
            if missing_p:
                raise ValueError(f"Template string sets {sorted(seen_params)} but is missing "
                                 f"parameter vectors: {missing_p}")
    return HostTemplateExpression(trees=trees, structure=structure, operators=operators,
                                  params=params)


def template_from_dict(d: Dict, structure: TemplateStructure,
                       operators: OperatorSet) -> "HostTemplateExpression":
    """Host template expression from ``{key: expr}`` (strings over
    ``#1..#k`` or ``Node`` trees): the dict form of
    :func:`parse_template_expression`."""
    from ..ops.tree import Node, parse_expression

    missing = [k for k in structure.expr_keys if k not in d]
    if missing:
        raise ValueError(f"Template guess dict missing subexpressions: {missing} "
                         f"(keys: {structure.expr_keys})")
    unknown = [k for k in d if k not in structure.expr_keys and k not in structure.param_keys]
    if unknown:
        raise ValueError(f"Template guess dict has unknown keys: {unknown} (expressions: "
                         f"{structure.expr_keys}, parameters: {structure.param_keys})")
    trees: Dict[str, object] = {}
    for k, key in enumerate(structure.expr_keys):
        v = d[key]
        if isinstance(v, Node):
            trees[key] = v
            continue
        names = [f"x{i + 1}" for i in range(max(structure.num_features[k], 1))]
        trees[key] = parse_expression(re.sub(r"#(\d+)", r"x\1", str(v)), operators,
                                      variable_names=names)
    params = None
    if structure.has_params and any(k in d for k in structure.param_keys):
        missing_p = [k for k in structure.param_keys if k not in d]
        if missing_p:
            raise ValueError(f"Template guess dict sets some parameter vectors but is "
                             f"missing: {missing_p}")
        params = np.concatenate([np.asarray(d[k], np.float64).reshape(-1)
                                 for k in structure.param_keys])
        if params.shape[0] != structure.total_params:
            raise ValueError(f"Template guess parameters have {params.shape[0]} values; "
                             f"expected {structure.total_params}")
    return HostTemplateExpression(trees=trees, structure=structure, operators=operators,
                                  params=params)


# ---------------------------------------------------------------------------
# Host-side expression (printing, prediction)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HostTemplateExpression:
    """A decoded template member: named host subtrees and parameter values.
    Prints as the JAX package does: ``f = ...; g = ...; p = [...]`` with
    arguments ``#1..#k``."""

    trees: Dict[str, "object"]          # key -> ops.tree.Node
    structure: TemplateStructure
    operators: OperatorSet
    params: Optional[np.ndarray] = None  # [total_params]

    def string(self, pretty: bool = False, precision: int = 5) -> str:
        from ..ops.tree import string_tree

        parts = []
        for k, key in enumerate(self.structure.expr_keys):
            names = [f"#{i + 1}" for i in range(self.structure.num_features[k])]
            s = string_tree(self.trees[key], variable_names=names, precision=precision)
            parts.append(f"{key} = {s}")
        if self.structure.has_params and self.params is not None:
            for key, off, cnt in zip(self.structure.param_keys, self.structure.param_offsets,
                                     self.structure.num_params):
                vals = ", ".join(f"{float(v):.{precision}g}" for v in self.params[off:off + cnt])
                parts.append(f"{key} = [{vals}]")
        return ("\n" if pretty else "; ").join(parts)

    def __repr__(self) -> str:  # pragma: no cover
        return f"HostTemplateExpression({self.string()})"

    def encode(self, max_nodes: int, device=None) -> TreeBatch:
        """Postfix-encode into a [K, max_nodes] TreeBatch (member layout)."""
        from ..ops.encoding import encode_population

        return encode_population([self.trees[k] for k in self.structure.expr_keys], max_nodes,
                                 self.operators, device=device)

    def __call__(self, X, device=None) -> np.ndarray:
        """Evaluate on host data ``X`` [n, F] on ``device`` (CUDA unless
        the caller asks for the CPU); invalid gives NaN."""
        from ..device import resolve_device

        dev = resolve_device(device)
        L = max(max(t.count_nodes() for t in self.trees.values()), 1)
        enc = self.encode(L, device=dev)
        stacked = TreeBatch(*(f[None] for f in enc.fields()))  # [1, K, L]
        Xt = torch.as_tensor(np.asarray(X, dtype=np.float32).T.copy(), device=dev)
        p = (torch.as_tensor(np.asarray(self.params, np.float32)[None], device=dev)
             if self.params is not None and self.structure.total_params else None)
        y, valid = eval_template_batch(stacked, Xt, self.structure, self.operators, params=p,
                                       fused=True)
        y = y[0].cpu().numpy()
        if not bool(valid[0]):
            return np.full_like(y, np.nan)
        return y
